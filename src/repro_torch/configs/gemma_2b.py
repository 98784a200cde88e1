"""gemma-2b [dense] — GeGLU, head_dim=256, MQA [arXiv:2403.08295; hf].

18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000; embeddings scaled by
sqrt(d_model) and tied with the output projection.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    mlp_variant="geglu",
    embed_scale=True,
    tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="gemma-2b-reduced",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    mlp_variant="geglu",
    embed_scale=True,
    tie_embeddings=True,
    attn_chunk=32,
)
