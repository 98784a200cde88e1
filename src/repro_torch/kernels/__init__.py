"""The hand-written Hopper kernels and their wrappers.

givens_mesh  — the mesh sweep: CUDA kernels ``csrc/mesh_fwd.cu`` (forward,
               B1) and ``csrc/mesh_bwd.cu`` (backward, B2); the fused analog
               linear layer: ``csrc/rfnn_fwd.cu`` (B3 inference, B4 training
               forward) and ``csrc/rfnn_bwd.cu`` (B5); all built at first use
               by ``cuda_build`` and sharing ``csrc/mesh_sweep.cuh``; and
               their plain versions
schedule     — parity-column schedules lowering any adjacent-pair MeshPlan
               onto the kernel, and the ``[C', 8, P]`` coefficient packing
ops          — public wrappers (``mesh_apply``, ``mesh_apply_cells``,
               ``rfnn_linear``)
ref          — the plain PyTorch twins of the column sweep, its reverse and
               the fused layer
"""
