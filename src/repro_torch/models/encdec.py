"""Encoder-decoder transformer (whisper-large-v3 backbone).

The JAX package's ``models/encdec.py`` on torch.  The conv/mel frontend is
a stub, as there: the encoder consumes precomputed frame embeddings
[B, enc_seq, d_model], adds sinusoidal position encodings and runs
non-causal self-attention without RoPE; the decoder runs causal RoPE
self-attention (the JAX package's documented deviation from whisper's
learned positions) plus cross-attention to the encoder memory.  Encoder
and decoder layers are stacked over a leading layer axis and a Python loop
indexes them (the JAX package scans); ``remat="full"`` or ``"dots"``
checkpoints each decoder layer whole, as the JAX package's
``jax.checkpoint`` of its decoder scan body (``"outputs"`` keeps
everything, as there).  With ``attn_impl="pallas"`` the
encoder and the decoder's self-attention run kernel B9; cross-attention,
whose keys are the encoder's frames, runs the plain chunked loop, as in
the JAX package.  ``spec_encdec`` and ``spec_dec_cache`` mirror the params
and the cache with logical axis names; the ``constrain`` calls stand where
the JAX package's do.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import checkpointed, constrain_tree, unstack
from repro_torch.parallel.sharding import constrain, local_copy_


def sinusoids(length: int, channels: int) -> np.ndarray:
    half = channels // 2
    t = np.log(10000.0) / (half - 1)
    inv = np.exp(-t * np.arange(half))
    ang = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=1).astype(np.float32)


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def init_encdec(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """Random params on the generator's device, the encoder's and the
    decoder's layer leaves stacked over their layer axes."""
    dev = generator.device
    d = cfg.d_model
    enc = (cfg.n_enc_layers,)
    dec = (cfg.n_layers,)
    return {
        "embed": L.init_embed(generator, cfg),
        "enc_blocks": {
            "ln1": L.init_rmsnorm(d, dev, stack=enc),
            "attn": attn_lib.init_attention(generator, cfg, stack=enc),
            "ln2": L.init_rmsnorm(d, dev, stack=enc),
            "mlp": L.init_mlp(generator, cfg, stack=enc)},
        "enc_norm": L.init_rmsnorm(d, dev),
        "dec_blocks": {
            "ln1": L.init_rmsnorm(d, dev, stack=dec),
            "self_attn": attn_lib.init_attention(generator, cfg, stack=dec),
            "ln_x": L.init_rmsnorm(d, dev, stack=dec),
            "cross_attn": attn_lib.init_attention(generator, cfg, stack=dec),
            "ln2": L.init_rmsnorm(d, dev, stack=dec),
            "mlp": L.init_mlp(generator, cfg, stack=dec)},
        "final_norm": L.init_rmsnorm(d, dev),
    }


def spec_encdec(cfg: ModelConfig) -> dict:
    enc = {"ln1": L.spec_rmsnorm(), "attn": attn_lib.spec_attention(),
           "ln2": L.spec_rmsnorm(), "mlp": L.spec_mlp(cfg)}
    dec = {"ln1": L.spec_rmsnorm(), "self_attn": attn_lib.spec_attention(),
           "ln_x": L.spec_rmsnorm(), "cross_attn": attn_lib.spec_attention(),
           "ln2": L.spec_rmsnorm(), "mlp": L.spec_mlp(cfg)}
    return {"embed": L.spec_embed(cfg), "enc_blocks": L.stack_spec(enc),
            "enc_norm": L.spec_rmsnorm(), "dec_blocks": L.stack_spec(dec),
            "final_norm": L.spec_rmsnorm()}


def encode(params: dict, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames: [B, enc_seq, D] precomputed embeddings (frontend stub)."""
    x = frames.to(cfg.activation_dtype())
    pe = torch.from_numpy(sinusoids(x.shape[1], cfg.d_model)).to(x.device)
    x = constrain(x + pe.to(x.dtype), "batch", "seq", "embed")
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    for lp in unstack(params["enc_blocks"], cfg.n_enc_layers):
        h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        x = x + attn_lib.attention(lp["attn"], cfg, h, positions,
                                   causal=False, rope=False)
        h = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
        x = constrain(x + L.mlp(lp["mlp"], cfg, h), "batch", "seq", "embed")
    return L.rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def _dec_layer(lp, cfg, x, positions, memory, *, return_kv=False):
    """A decoder layer over a full target sequence:
    (x, self-attention (k, v) or None, cross (k, v))."""
    h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    y = attn_lib.attention(lp["self_attn"], cfg, h, positions,
                           return_kv=return_kv)
    kv = None
    if return_kv:
        y, kv = y
    x = x + y
    h = L.rmsnorm(lp["ln_x"], x, cfg.norm_eps)
    cross = attn_lib.project_cross_kv(lp["cross_attn"], cfg, memory)
    x = x + attn_lib.attention(lp["cross_attn"], cfg, h, positions,
                               causal=False, rope=False, kv_override=cross)
    h = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
    return x + L.mlp(lp["mlp"], cfg, h), kv, cross


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            frames: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced decode over the full target sequence."""
    memory = encode(params, cfg, frames)
    x = constrain(L.embed_tokens(params["embed"], cfg, tokens),
                  "batch", "seq", "embed")
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)

    def layer(lp, x):
        return constrain(_dec_layer(lp, cfg, x, positions, memory)[0],
                         "batch", "seq", "embed")

    if cfg.remat in ("full", "dots"):
        layer = checkpointed(layer, "full")
    for lp in unstack(params["dec_blocks"], cfg.n_layers):
        x = layer(lp, x)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = constrain(L.unembed(params["embed"], cfg, x),
                       "batch", "seq", "vocab")
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def init_dec_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                   device=None) -> dict:
    """The decoder's cache stacked over its layers: a ``self`` KV cache of
    ``max_len`` slots and the cross-attention ``cross_k``/``cross_v`` of
    ``enc_seq`` frames (zeros until a prefill encodes frames)."""
    dt = cfg.activation_dtype()
    shape = (cfg.n_layers, batch, cfg.enc_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"self": attn_lib.init_cache(cfg, batch, max_len, dt,
                                        device=device, stack=(cfg.n_layers,)),
            "cross_k": torch.zeros(shape, dtype=dt, device=device),
            "cross_v": torch.zeros(shape, dtype=dt, device=device)}


def spec_dec_cache(cfg: ModelConfig) -> dict:
    return L.stack_spec({"self": attn_lib.spec_cache(),
                         "cross_k": ("batch", None, "kv_heads", "head_dim"),
                         "cross_v": ("batch", None, "kv_heads", "head_dim")})


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            frames: torch.Tensor,
            max_len: int | None = None) -> tuple[torch.Tensor, dict]:
    """Encode + teacher-forced pass building the self and cross caches."""
    memory = encode(params, cfg, frames)
    x = constrain(L.embed_tokens(params["embed"], cfg, tokens),
                  "batch", "seq", "embed")
    s = x.shape[1]
    max_len = max_len or cfg.max_cache_len or s
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    cache = constrain_tree(
        init_dec_cache(cfg, x.shape[0], max_len, device=x.device),
        spec_dec_cache(cfg))
    for i in range(cfg.n_layers):
        x, (k, v), (ck, cv) = _dec_layer(_layer(params["dec_blocks"], i), cfg,
                                         x, positions, memory, return_kv=True)
        x = constrain(x, "batch", "seq", "embed")
        attn_lib.prefill_into_cache(_layer(cache["self"], i), k, v)
        local_copy_(cache["cross_k"][i], ck)
        local_copy_(cache["cross_v"][i], cv)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed(params["embed"], cfg, x[:, -1:])[:, 0]
    return constrain(logits, "batch", "vocab"), cache


def decode_step(params: dict, cfg: ModelConfig, token: torch.Tensor,
                cache: dict, pos) -> tuple[torch.Tensor, dict]:
    """One decode step (``pos`` as in ``lm.decode_step``); the self cache is
    updated in place, the cross cache read."""
    x = constrain(L.embed_tokens(params["embed"], cfg, token[:, None]),
                  "batch", None, "embed")
    pos = attn_lib.row_positions(pos, x.shape[0], x.device)
    for i in range(cfg.n_layers):
        lp = _layer(params["dec_blocks"], i)
        h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        y, _ = attn_lib.decode_attention(lp["self_attn"], cfg, h,
                                         _layer(cache["self"], i), pos)
        x = x + y
        h = L.rmsnorm(lp["ln_x"], x, cfg.norm_eps)
        y, _ = attn_lib.decode_attention(
            lp["cross_attn"], cfg, h,
            {"k": cache["cross_k"][i], "v": cache["cross_v"][i]},
            cfg.enc_seq - 1, rope=False, update_cache=False)
        x = x + y
        h = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
        x = x + L.mlp(lp["mlp"], cfg, h)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed(params["embed"], cfg, x)[:, 0]
    return constrain(logits, "batch", "vocab"), cache
