"""llama3.2-3b [dense] — small llama3 [hf:meta-llama/Llama-3.2-1B; unverified].

28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=500_000.0,
)

REDUCED = ModelConfig(
    name="llama3.2-3b-reduced",
    family="dense",
    n_layers=2,
    d_model=96,
    n_heads=6,
    n_kv_heads=2,
    head_dim=16,
    d_ff=256,
    vocab_size=512,
    attn_chunk=32,
)
