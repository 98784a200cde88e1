"""repro_torch: the RF analog processor reproduction on PyTorch and CUDA.

A port of the JAX package ``repro`` that mirrors its layout
(``repro_torch.core.cell`` is the counterpart of ``repro.core.cell``, and
so on).  The mesh sweep, the fused analog linear layer and their
backwards run as hand-written CUDA kernels for Hopper
(``repro_torch.kernels.givens_mesh``); everything around them is plain
PyTorch.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.  The package imports neither ``jax`` nor ``repro``.
"""

from repro_torch.device import resolve_device

__version__ = "0.1.0"

__all__ = ["resolve_device", "__version__"]
