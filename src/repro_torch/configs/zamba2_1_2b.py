"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242; hf].

38L d_model=2048 32H (kv=32) d_ff=8192, ssm_state=64.  A single shared
attention+MLP block (weights tied) is invoked after every 2 mamba layers.
Runs long_500k (state decode + data-sharded KV for the shared blocks).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_chunk=128,
    attn_every=2,
)

REDUCED = ModelConfig(
    name="zamba2-1.2b-reduced",
    family="hybrid",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    ssm_state=16,
    ssm_headdim=16,
    ssm_chunk=8,
    attn_every=2,
    attn_chunk=32,
)
