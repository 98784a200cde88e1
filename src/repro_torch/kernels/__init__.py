"""The hand-written Hopper kernels and their wrappers.

givens_mesh  — the mesh sweep: CUDA kernels ``csrc/mesh_fwd.cu`` (forward)
               and ``csrc/mesh_bwd.cu`` (backward), built at first use by
               ``cuda_build``, and their plain versions
schedule     — parity-column schedules lowering any adjacent-pair MeshPlan
               onto the kernel, and the ``[C', 8, P]`` coefficient packing
ops          — public wrappers (``mesh_apply``, ``mesh_apply_cells``)
ref          — the plain PyTorch twin of the column sweep and its reverse
"""
