"""Decoder-only language models: the dense and VLM families.

The JAX package's ``models/lm.py`` on torch, for the families whose
super-block is one attention-plus-MLP layer (``dense``; ``vlm`` prepends
precomputed patch embeddings).  Parameters are stacked over a leading
super-block axis, as in the JAX package, and a Python loop over the layers
indexes each leaf (the JAX package scans).  Caches are stacked the same
way and written in place.

Modes: ``forward`` (evaluation over a full sequence), ``prefill`` (forward
plus cache) and ``decode_step`` (one token).  The ``moe``, ``ssm`` and
``hybrid`` families raise; ``remat`` is a training knob and is ignored.
"""

from __future__ import annotations

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

_NOT_PORTED = ("the {} family is not ported yet (moe, ssm and hybrid layers): "
               "see ROADMAP A10")


def superblock_layout(cfg: ModelConfig) -> tuple[int, list[str]]:
    """(number of super-blocks, layer kinds inside one super-block)."""
    if cfg.family in ("dense", "vlm"):
        return cfg.n_layers, ["dense"]
    if cfg.family in ("moe", "ssm", "hybrid"):
        raise NotImplementedError(_NOT_PORTED.format(cfg.family))
    raise ValueError(cfg.family)


def init_lm(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """Random params on the generator's device, every block leaf stacked
    over the super-block axis."""
    n_super, kinds = superblock_layout(cfg)
    dev = generator.device
    stack = (n_super,)
    blocks = {f"l{i}_{kind}": {
        "ln1": L.init_rmsnorm(cfg.d_model, dev, stack=stack),
        "attn": attn_lib.init_attention(generator, cfg, stack=stack),
        "ln2": L.init_rmsnorm(cfg.d_model, dev, stack=stack),
        "mlp": L.init_mlp(generator, cfg, stack=stack)}
        for i, kind in enumerate(kinds)}
    return {"embed": L.init_embed(generator, cfg),
            "final_norm": L.init_rmsnorm(cfg.d_model, dev),
            "blocks": blocks}


def _layer(tree, i: int):
    """Super-block ``i``'s slice of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _embed_input(params, cfg, tokens, vis_embed):
    x = L.embed_tokens(params["embed"], cfg, tokens)
    if cfg.family == "vlm":
        if vis_embed is None:
            raise ValueError("vlm family requires vis_embed")
        x = torch.cat([vis_embed.to(x.dtype), x], dim=1)
    return x


def _dense_layer(lp, cfg, x, positions, *, return_kv=False):
    h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    y = attn_lib.attention(lp["attn"], cfg, h, positions, return_kv=return_kv)
    kv = None
    if return_kv:
        y, kv = y
    x = x + y
    h = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
    return x + L.mlp(lp["mlp"], cfg, h), kv


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            vis_embed: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns (logits, moe_aux_loss = 0)."""
    n_super, kinds = superblock_layout(cfg)
    x = _embed_input(params, cfg, tokens, vis_embed)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    for l in range(n_super):
        bp = _layer(params["blocks"], l)
        for i, kind in enumerate(kinds):
            x, _ = _dense_layer(bp[f"l{i}_{kind}"], cfg, x, positions)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed(params["embed"], cfg, x)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def init_lm_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                  device=None) -> dict:
    """Decode cache stacked over super-blocks (mirrors params['blocks'])."""
    n_super, kinds = superblock_layout(cfg)
    return {f"l{i}_{kind}": attn_lib.init_cache(
        cfg, batch, max_len, cfg.activation_dtype(), device=device,
        stack=(n_super,)) for i, kind in enumerate(kinds)}


def decode_step(params: dict, cfg: ModelConfig, token: torch.Tensor,
                cache: dict, pos) -> tuple[torch.Tensor, dict]:
    """One decode step.  token: [B] int; pos: int or 0-d tensor (every row
    at that position) or an int tensor [B] (row b at ``pos[b]``).
    -> (logits [B, V], cache), the cache updated in place."""
    n_super, kinds = superblock_layout(cfg)
    x = L.embed_tokens(params["embed"], cfg, token[:, None])
    pos = attn_lib.row_positions(pos, x.shape[0], x.device)
    for l in range(n_super):
        bp = _layer(params["blocks"], l)
        for i, kind in enumerate(kinds):
            name = f"l{i}_{kind}"
            lp = bp[name]
            h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
            y, _ = attn_lib.decode_attention(lp["attn"], cfg, h,
                                             _layer(cache[name], l), pos)
            x = x + y
            h = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
            x = x + L.mlp(lp["mlp"], cfg, h)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.unembed(params["embed"], cfg, x)[:, 0], cache


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            vis_embed: torch.Tensor | None = None,
            max_len: int | None = None) -> tuple[torch.Tensor, dict]:
    """Prefill: full-sequence pass producing last-position logits + cache."""
    n_super, kinds = superblock_layout(cfg)
    x = _embed_input(params, cfg, tokens, vis_embed)
    s = x.shape[1]
    max_len = max_len or cfg.max_cache_len or s
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    cache = init_lm_cache(cfg, x.shape[0], max_len, device=x.device)
    for l in range(n_super):
        bp = _layer(params["blocks"], l)
        for i, kind in enumerate(kinds):
            name = f"l{i}_{kind}"
            x, (k, v) = _dense_layer(bp[name], cfg, x, positions,
                                     return_kv=True)
            attn_lib.prefill_into_cache(_layer(cache[name], l), k, v)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.unembed(params["embed"], cfg, x[:, -1:])[:, 0], cache
