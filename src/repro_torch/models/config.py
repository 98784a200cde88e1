"""Model configuration for all assigned architectures.

One frozen dataclass covers the five families (dense / moe / ssm / hybrid /
encdec / vlm); family-specific fields default to "off".  Exact per-arch
values live in ``repro_torch.configs``.  A copy of the JAX package's
``models/config.py``, field for field; ``activation_dtype`` returns a torch
dtype.  :class:`PatternConfig` adds the fields of Granite 4.0's hybrid
layout (``layer_pattern`` and what it reads), which the JAX package lacks;
on a ``ModelConfig`` they read as off.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"          # dense | moe | ssm | hybrid | encdec | vlm

    # --- transformer backbone ---
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0              # 0 -> d_model // n_heads
    d_ff: int = 1024
    vocab_size: int = 1000
    mlp_variant: str = "swiglu"    # swiglu | geglu
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    embed_scale: bool = False      # gemma: embeddings scaled by sqrt(d_model)
    attn_chunk: int = 1024         # flash-style kv chunk in train/prefill
    attn_impl: str = "xla"         # xla (chunked scan) | pallas (flash kernel)
    logit_softcap: float = 0.0
    vocab_real: int = 0            # >0: vocab_size is padded; mask the rest
    head_pad: int = 0              # dead (masked) q-heads appended so the
                                   # head axis divides the TP degree

    # --- MoE ---
    n_experts: int = 0             # routed experts (0 = dense)
    n_experts_active: int = 0      # real experts if padded (qwen 60 -> 64)
    top_k: int = 1
    d_ff_expert: int = 0
    n_shared_experts: int = 0
    d_ff_shared: int = 0
    moe_interleave: int = 1        # every k-th layer is MoE (llama4: 2)
    capacity_factor: float = 1.25
    expert_groups: int = 1         # dispatch groups (set >= DP shards at scale)
    router_aux_weight: float = 0.01

    # --- SSM (mamba2) ---
    ssm_state: int = 0             # d_state (0 = no ssm)
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    ssm_conv: int = 4

    # --- hybrid (zamba2) ---
    attn_every: int = 0            # shared attn block every k ssm layers

    # --- encoder-decoder (whisper) ---
    n_enc_layers: int = 0
    enc_seq: int = 0               # whisper: 1500 precomputed frames

    # --- vlm (internvl) ---
    n_vis_tokens: int = 0          # precomputed patch embeddings prepended

    # --- paper integration ---
    linear_impl: str = "digital"   # digital | rfnn (analog tiled projections)
    rfnn_tile: int = 16
    rfnn_quantize: str | None = None
    rfnn_backend: str = "reference"  # reference | pallas (fused mesh kernels)

    # --- training/runtime ---
    dtype: str = "bfloat16"
    remat: str = "none"            # none | full | dots
    max_cache_len: int = 0         # decode KV cache length (0 -> seq)

    # --- Granite 4.0-h's layout: ``PatternConfig``'s fields, off here (class
    # attributes, not fields: this dataclass's fields stay the JAX
    # package's) ---
    layer_pattern = ""
    embedding_multiplier = 1.0
    residual_multiplier = 1.0
    logits_scaling = 1.0
    attention_multiplier = 0.0
    nope = False
    ssm_conv_bias = False
    moe_dropless = False
    experts_held = 0
    experts_first = 0

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_experts and not self.n_experts_active:
            object.__setattr__(self, "n_experts_active", self.n_experts)
        if self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads must be a multiple of n_kv_heads")
        if self.family == "moe" and not self.n_experts:
            raise ValueError("moe family needs n_experts")
        if self.family in ("ssm", "hybrid") and not self.ssm_state:
            raise ValueError(f"{self.family} family needs ssm_state")
        if self.family == "encdec" and not self.n_enc_layers:
            raise ValueError("encdec family needs n_enc_layers")
        if self.experts_first + self.held > self.n_experts:
            raise ValueError("held experts must lie within n_experts")
        # the attention's score scale, read by every attention call (a
        # derived attribute, not a field)
        object.__setattr__(self, "attn_scale", self.attention_multiplier
                           or 1.0 / math.sqrt(self.head_dim))

    # ------------------------------------------------------------------
    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def held(self) -> int:
        """Experts whose weights this chip holds and computes."""
        return self.experts_held or self.n_experts

    @property
    def is_moe_layer(self):
        """Vector of per-layer booleans: which layers carry the MoE block."""
        if not self.n_experts:
            return [False] * self.n_layers
        return [(i % self.moe_interleave) == (self.moe_interleave - 1)
                for i in range(self.n_layers)]

    def activation_dtype(self):
        import torch
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.dtype]

    def _pattern_counts(self) -> tuple[int, int]:
        """(params, params a token meets) of a ``layer_pattern`` model:
        each layer two norms, its mixer and its FFN; a token meets the held
        experts at their expected share, ``top_k * held / n_experts``."""
        d, hd, h, kv = self.d_model, self.head_dim, self.n_heads, \
            self.n_kv_heads
        di, n, hs, k = self.d_inner, self.ssm_state, self.ssm_heads, \
            self.ssm_conv
        mamba = (2 * d * di + 2 * d * n + d * hs + k * (di + 2 * n)
                 + (di + 2 * n) * self.ssm_conv_bias + 3 * hs + di + di * d)
        attn = d * hd * (h + 2 * kv) + h * hd * d
        expert = 3 * d * self.d_ff_expert
        other = (d * self.n_experts
                 + 3 * d * self.d_ff_shared * self.n_shared_experts)
        ffn = other + self.held * expert
        ffn_active = other + self.top_k * self.held * expert // self.n_experts
        mixers = sum(mamba if c == "M" else attn for c in self.layer_pattern)
        reps = self.n_layers // len(self.layer_pattern)
        base = (self.vocab_size * d * (1 if self.tie_embeddings else 2) + d
                + reps * mixers + 2 * d * self.n_layers)
        return (base + self.n_layers * ffn,
                base + self.n_layers * ffn_active)

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks), for roofline."""
        if self.layer_pattern:
            return self._pattern_counts()[0]
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd, h, kv = self.head_dim, self.n_heads, self.n_kv_heads
        attn = d * hd * (h + 2 * kv) + h * hd * d
        gates = 3 if self.mlp_variant in ("swiglu", "geglu") else 2
        mlp = gates * d * f
        total = v * d * (1 if self.tie_embeddings else 2)
        if self.family in ("ssm", "hybrid"):
            di, n, hs = self.d_inner, self.ssm_state, self.ssm_heads
            ssm = (d * di * 2            # z, x projections
                   + 2 * d * n + d * hs  # B, C, dt projections
                   + self.ssm_conv * (di + 2 * n)
                   + 3 * hs + di        # A_log, D, dt_bias, norm
                   + di * d)            # out_proj
            total += self.n_layers * (ssm + d)
            if self.family == "hybrid" and self.attn_every:
                total += attn + mlp + 2 * d  # one shared block
            return total
        n_moe = sum(self.is_moe_layer)
        n_dense = self.n_layers - n_moe
        total += n_dense * (attn + mlp + 2 * d)
        if n_moe:
            fe = self.d_ff_expert
            moe = (d * self.n_experts_active
                   + self.n_experts_active * gates * d * fe
                   + self.n_shared_experts * gates * d * self.d_ff_shared)
            total += n_moe * (attn + moe + 2 * d)
        if self.family == "encdec":
            total += self.n_enc_layers * (attn + mlp + 2 * d)
            total += self.n_layers * (attn + d)  # cross-attention per dec layer
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE top-k; weight-tied blocks counted
        per *invocation*), for the 6ND model-FLOPs."""
        if self.layer_pattern:
            return self._pattern_counts()[1]
        if self.family == "hybrid" and self.attn_every:
            d, f = self.d_model, self.d_ff
            hd, h, kv = self.head_dim, self.n_heads, self.n_kv_heads
            attn = d * hd * (h + 2 * kv) + h * hd * d
            gates = 3 if self.mlp_variant in ("swiglu", "geglu") else 2
            shared = attn + gates * d * f + 2 * d
            reuse = self.n_layers // self.attn_every - 1
            return self.param_count() + reuse * shared
        if not self.n_experts:
            return self.param_count()
        d, fe = self.d_model, self.d_ff_expert
        gates = 3 if self.mlp_variant in ("swiglu", "geglu") else 2
        n_moe = sum(self.is_moe_layer)
        inactive = n_moe * (self.n_experts_active - self.top_k) * gates * d * fe
        return self.param_count() - inactive


@dataclasses.dataclass(frozen=True)
class PatternConfig(ModelConfig):
    """A ``ModelConfig`` with a per-layer mixer pattern (granite 4.0-h)."""

    layer_pattern: str = ""        # one super-block's mixers, "M" mamba2 or
                                   # "A" attention, each followed by the
                                   # dropless MoE; "" = off
    embedding_multiplier: float = 1.0   # embeddings x m
    residual_multiplier: float = 1.0    # each sub-layer's output x m
    logits_scaling: float = 1.0         # logits / s
    attention_multiplier: float = 0.0   # score scale; 0 -> 1/sqrt(head_dim)
    nope: bool = False             # no position embedding in attention
    ssm_conv_bias: bool = False    # a bias on the causal conv's channels
    moe_dropless: bool = False     # sort choices by expert, keep them all
    experts_held: int = 0          # experts this chip computes (0 = all)
    experts_first: int = 0         # the first of them, of n_experts
