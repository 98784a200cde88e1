"""Plain references of the benchmark's configurations (NumPy and PyTorch,
no kernels, nothing of the program or the JAX package)."""
