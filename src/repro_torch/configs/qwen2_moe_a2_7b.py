"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed top-4
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf].

24L d_model=2048 16H (GQA kv=16) vocab=151936; per-expert FFN 1408, top-4 of
60 routed experts (padded to 64 for even EP sharding; the 4 pad experts are
masked out of routing) + 4 shared experts of 1408 each (= the HF
shared_expert_intermediate_size of 5632 in aggregate).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=5632,                 # unused: every layer is MoE (interleave=1)
    vocab_size=151936,
    n_experts=64,
    n_experts_active=60,
    top_k=4,
    d_ff_expert=1408,
    n_shared_experts=4,
    d_ff_shared=1408,
    moe_interleave=1,
    capacity_factor=1.25,
)

REDUCED = ModelConfig(
    name="qwen2-moe-a2.7b-reduced",
    family="moe",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    head_dim=32,
    d_ff=128,
    vocab_size=512,
    n_experts=8,
    n_experts_active=6,
    top_k=4,
    d_ff_expert=32,
    n_shared_experts=2,
    d_ff_shared=32,
    moe_interleave=1,
    attn_chunk=32,
)
