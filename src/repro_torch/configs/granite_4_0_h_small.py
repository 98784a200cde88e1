"""granite-4.0-h-small [hybrid, MoE] — Mamba-2 and GQA attention layers,
each followed by a dropless MoE with a shared MLP
[hf:ibm-granite/granite-4.0-h-small, config.json (granitemoehybrid)].

40L d_model=4096; ``layer_types`` puts attention at layers 5, 15, 25, 35,
so one super-block is ``MMMMMAMMMM``.  Mamba-2: 128 heads x 64 (expand 2),
d_state 128, one group, chunk 256, conv 4 with a bias.  Attention: 32 q
heads, 8 KV heads, head_dim 128, no position embedding, scores x 1/128.
FFN: 72 routed SwiGLU experts of 768, top-10 (softmax over the top 10),
no capacity, plus a shared SwiGLU MLP of 1536.  Embeddings x 12, each
sub-layer's output x 0.22, logits / 16; vocab 100,352 tied.  HF's router
loss weight is taken as 0 (no aux loss).

Not in the registry (``configs.list_archs`` is the JAX package's list, which
lacks this layout): import the module.  ``REDUCED`` is one 10-layer period
at a small width for the CPU tests, 8 of 16 experts held, top-4.
"""

from repro_torch.models.config import PatternConfig

CONFIG = PatternConfig(
    name="granite-4.0-h-small",
    family="hybrid",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=1536,                 # unused: every FFN is the MoE
    vocab_size=100352,
    norm_eps=1e-5,
    tie_embeddings=True,
    n_experts=72,
    top_k=10,
    d_ff_expert=768,
    n_shared_experts=1,
    d_ff_shared=1536,
    router_aux_weight=0.0,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_chunk=256,
    ssm_conv=4,
    layer_pattern="MMMMMAMMMM",
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    logits_scaling=16.0,
    attention_multiplier=0.0078125,
    nope=True,
    ssm_conv_bias=True,
    moe_dropless=True,
)

REDUCED = PatternConfig(
    name="granite-4.0-h-small-reduced",
    family="hybrid",
    n_layers=10,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=32,
    vocab_size=512,
    norm_eps=1e-5,
    tie_embeddings=True,
    n_experts=16,
    top_k=4,
    d_ff_expert=16,
    n_shared_experts=1,
    d_ff_shared=32,
    router_aux_weight=0.0,
    ssm_state=16,
    ssm_headdim=16,
    ssm_expand=2,
    ssm_chunk=8,
    ssm_conv=4,
    layer_pattern="MMMMMAMMMM",
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    logits_scaling=16.0,
    attention_multiplier=1.0 / 16,
    nope=True,
    ssm_conv_bias=True,
    moe_dropless=True,
    experts_held=8,
    attn_chunk=16,
    dtype="float32",
)
