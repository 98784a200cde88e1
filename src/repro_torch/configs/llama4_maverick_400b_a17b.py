"""llama4-maverick-400b-a17b [moe] — MoE with early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048; MoE 128 routed
experts top-1 + 1 shared expert, interleaved every 2nd layer
(interleave_moe_layer_step=2 on the HF config), which lands the total at
~400B params with ~17B active — matching the name.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,                 # dense (non-MoE) layers
    vocab_size=202048,
    n_experts=128,
    top_k=1,
    d_ff_expert=8192,
    n_shared_experts=1,
    d_ff_shared=8192,
    moe_interleave=2,
    capacity_factor=1.25,
    rope_theta=500_000.0,
)

REDUCED = ModelConfig(
    name="llama4-maverick-400b-a17b-reduced",
    family="moe",
    n_layers=4,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    n_experts=8,
    top_k=1,
    d_ff_expert=64,
    n_shared_experts=1,
    d_ff_shared=64,
    moe_interleave=2,
    attn_chunk=32,
)
