"""internvl2-2b [vlm] — InternViT + InternLM2 backbone [arXiv:2404.16821; hf].

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.  The ViT frontend is
a stub per the brief: ``input_specs`` supplies precomputed patch embeddings
(256 tokens) prepended to the text stream.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92553,
    n_vis_tokens=256,
    rope_theta=1_000_000.0,
)

REDUCED = ModelConfig(
    name="internvl2-2b-reduced",
    family="vlm",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    n_vis_tokens=8,
    attn_chunk=32,
)
