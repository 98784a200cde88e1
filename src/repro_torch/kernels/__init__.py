"""The hand-written Hopper kernels and their wrappers.

givens_mesh  — the mesh sweep: CUDA kernels ``csrc/mesh_fwd.cu`` (forward,
               B1) and ``csrc/mesh_bwd.cu`` (backward, B2); the fused analog
               linear layer: ``csrc/rfnn_fwd.cu`` (B3 inference, B4 training
               forward) and ``csrc/rfnn_bwd.cu`` (B5); the deep tile grid:
               ``csrc/deepgrid_fwd.cu`` (B6, B7) and ``csrc/deepgrid_bwd.cu``
               (B8); all built at first use by ``cuda_build`` and sharing
               ``csrc/mesh_sweep.cuh``; and their plain versions
schedule     — parity-column schedules lowering any adjacent-pair MeshPlan
               onto the kernels, the ``[C', 8, P]`` coefficient packing and
               the deep grid's stacked schedules
flash_attention — kernel B9, flash attention: CUDA kernel
               ``csrc/flash_attn_fwd.cu`` (online softmax, causal block skip,
               float32 or bfloat16) and its dense plain version
adamw_fused  — the fused AdamW update: CUDA kernels ``csrc/adamw_fused.cu``
               (the clipping norm's partial sums, its finalize, one update
               pass a leaf) and the plain version ``optim.AdamW`` runs on
               the CPU and on DTensors
rope_fused   — A2, the rotary position embedding of q and k in one launch:
               CUDA kernel ``csrc/rope_fused.cu`` (forward, and the backward
               as the same kernel with the sine negated); its plain version
               is ``models/layers.py``'s, which DTensors and the CPU take
ops          — public wrappers (``mesh_apply``, ``mesh_apply_cells``,
               ``rfnn_linear``, ``deep_apply``, ``rfnn_network``,
               ``tiled_apply``) and the deep grid's pack cache
ref          — the plain PyTorch twins of the column sweep, its reverse,
               the fused layer, the deep grid and flash attention
"""
