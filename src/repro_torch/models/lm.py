"""Decoder-only language models: dense / MoE / SSM / hybrid / VLM.

The JAX package's ``models/lm.py`` on torch.  Parameters are stacked over a
leading super-block axis, as in the JAX package, and a Python loop over the
super-blocks indexes each leaf (the JAX package scans).  A super-block is
the family's repeating pattern:

  dense/vlm    1 layer  (attn + mlp; vlm prepends patch embeddings)
  moe          ``moe_interleave`` layers (dense..., moe)
  ssm          1 mamba2 layer
  hybrid       ``attn_every`` mamba2 layers + one invocation of the *shared*
               attention block (one parameter set outside the stack, reused
               by every invocation, each with its own KV cache: zamba2's
               weight tying)
  pattern      ``cfg.layer_pattern``'s layers (granite 4.0-h's
               ``MMMMMAMMMM``), each a mixer (``M`` mamba2, ``A`` attention
               without RoPE under ``cfg.nope``) and then the dropless MoE
               with its shared MLP, every sub-layer's output scaled by
               ``cfg.residual_multiplier``; one cache tree holds the mamba
               layers' states beside the attention layers' KV caches.  Its
               layers run in functions of their own (``_pattern_*``), picked
               once a call, so the other layouts run no step of theirs.

Modes: ``forward`` (training and evaluation over a full sequence),
``prefill`` (forward plus cache) and ``decode_step`` (one token).  Caches
are stacked over the same super-block axis and written in place.

``cfg.remat`` sets what ``forward`` keeps for the backward pass, as the
JAX package's ``jax.checkpoint`` around its scan body:

  none     everything autograd saves;
  full     each super-block's input only: every super-block runs under
           ``torch.utils.checkpoint`` (non-reentrant) and is recomputed in
           the backward pass;
  outputs  the residual stream between sub-layers (norm + attention, norm +
           MLP or MoE, norm + SSM), each sub-layer checkpointed on its own.
           The JAX package saves each sub-layer's output (``attn_out``,
           ``mlp_out``, ``ssm_out``) beside the super-block's input; the
           stream after a sub-layer is its input plus that output, so both
           keep one ``[B, S, D]`` tensor a sub-layer and recompute the
           same internals;
  dots     the outputs of matmuls without batch dims (``aten.mm``/
           ``aten.addmm``: the projections), everything else recomputed:
           selective checkpointing of each super-block, as JAX's
           ``checkpoint_dots_with_no_batch_dims`` (attention's batched
           score matmuls are recomputed in both).

``spec_lm`` and ``spec_lm_cache`` mirror the params and the cache with
logical axis names; the ``constrain`` calls stand where the JAX package's
do, and under an active mesh a prefill's new cache takes the cache specs.
"""

from __future__ import annotations

import functools

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ModelConfig
from repro_torch.parallel.sharding import (active_mesh, active_rules,
                                           constrain, local_copy_,
                                           use_mesh_and_rules)
from repro_torch.runtime import trace


PATTERN_KINDS = {"M": "mamba", "A": "attn"}


def superblock_layout(cfg: ModelConfig) -> tuple[int, list[str]]:
    """(number of super-blocks, layer kinds inside one super-block)."""
    if cfg.layer_pattern:
        p = cfg.layer_pattern
        if set(p) - set(PATTERN_KINDS) or cfg.n_layers % len(p):
            raise ValueError(f"layer_pattern {p!r} is not M/A letters "
                             f"whose length divides n_layers {cfg.n_layers}")
        if not (cfg.n_experts and cfg.moe_dropless):
            raise ValueError("a layer_pattern's FFN is the dropless MoE")
        return cfg.n_layers // len(p), [PATTERN_KINDS[c] for c in p]
    if cfg.moe_dropless:
        raise ValueError("moe_dropless needs a layer_pattern")
    if cfg.family in ("dense", "vlm"):
        return cfg.n_layers, ["dense"]
    if cfg.family == "moe":
        il = cfg.moe_interleave
        if cfg.n_layers % il:
            raise ValueError(f"n_layers {cfg.n_layers} is no multiple of "
                             f"moe_interleave {il}")
        return cfg.n_layers // il, ["dense"] * (il - 1) + ["moe"]
    if cfg.family == "ssm":
        return cfg.n_layers, ["ssm"]
    if cfg.family == "hybrid":
        k = cfg.attn_every
        if not k or cfg.n_layers % k:
            raise ValueError(f"n_layers {cfg.n_layers} is no multiple of "
                             f"attn_every {k}")
        return cfg.n_layers // k, ["ssm"] * k + ["shared_attn"]
    raise ValueError(cfg.family)


def _spec_attn_layer(cfg, ffn):
    p = {"ln1": L.spec_rmsnorm(), "attn": attn_lib.spec_attention(),
         "ln2": L.spec_rmsnorm()}
    if ffn == "moe":
        p["moe"] = moe_lib.spec_moe(cfg)
    else:
        p["mlp"] = L.spec_mlp(cfg)
    return p


def _spec_layer(kind, cfg):
    if kind in ("dense", "moe"):
        return _spec_attn_layer(cfg, "moe" if kind == "moe" else "mlp")
    if kind in ("mamba", "attn"):
        p = {"ln1": L.spec_rmsnorm(), "ln2": L.spec_rmsnorm(),
             "moe": moe_lib.spec_moe(cfg)}
        p.update({"ssm": ssm_lib.spec_ssm(cfg)} if kind == "mamba"
                 else {"attn": attn_lib.spec_attention()})
        return p
    return {"ln": L.spec_rmsnorm(), "ssm": ssm_lib.spec_ssm()}


def spec_lm(cfg: ModelConfig) -> dict:
    """``init_lm``'s tree with a tuple of logical axis names a leaf, the
    stacked blocks' led by ``"layers"``."""
    kinds = superblock_layout(cfg)[1]
    specs = {"embed": L.spec_embed(cfg), "final_norm": L.spec_rmsnorm(),
             "blocks": L.stack_spec({f"l{i}_{kind}": _spec_layer(kind, cfg)
                                     for i, kind in enumerate(kinds)
                                     if kind != "shared_attn"})}
    if "shared_attn" in kinds:
        specs["shared_attn"] = _spec_attn_layer(cfg, "mlp")
    return specs


def _init_attn_layer(generator, cfg, stack, ffn):
    dev = generator.device
    p = {"ln1": L.init_rmsnorm(cfg.d_model, dev, stack=stack),
         "attn": attn_lib.init_attention(generator, cfg, stack=stack),
         "ln2": L.init_rmsnorm(cfg.d_model, dev, stack=stack)}
    if ffn == "moe":
        p["moe"] = moe_lib.init_moe(generator, cfg, stack=stack)
    else:
        p["mlp"] = L.init_mlp(generator, cfg, stack=stack)
    return p


def _init_layer(kind, generator, cfg, stack):
    if kind in ("dense", "moe"):
        return _init_attn_layer(generator, cfg, stack,
                                "moe" if kind == "moe" else "mlp")
    if kind in ("mamba", "attn"):
        dev = generator.device
        p = {"ln1": L.init_rmsnorm(cfg.d_model, dev, stack=stack)}
        p.update({"ssm": ssm_lib.init_ssm(generator, cfg, stack=stack)}
                 if kind == "mamba" else
                 {"attn": attn_lib.init_attention(generator, cfg,
                                                  stack=stack)})
        p["ln2"] = L.init_rmsnorm(cfg.d_model, dev, stack=stack)
        p["moe"] = moe_lib.init_moe(generator, cfg, stack=stack)
        return p
    return {"ln": L.init_rmsnorm(cfg.d_model, generator.device, stack=stack),
            "ssm": ssm_lib.init_ssm(generator, cfg, stack=stack)}


def init_lm(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """Random params on the generator's device, every block leaf stacked
    over the super-block axis (the hybrid's shared block unstacked)."""
    n_super, kinds = superblock_layout(cfg)
    stack = (n_super,)
    blocks = {f"l{i}_{kind}": _init_layer(kind, generator, cfg, stack)
              for i, kind in enumerate(kinds) if kind != "shared_attn"}
    params = {"embed": L.init_embed(generator, cfg),
              "final_norm": L.init_rmsnorm(cfg.d_model, generator.device),
              "blocks": blocks}
    if "shared_attn" in kinds:
        params["shared_attn"] = _init_attn_layer(generator, cfg, (), "mlp")
    return params


def _layer(tree, i: int):
    """Super-block ``i``'s slice of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def unstack(tree, n: int) -> list:
    """The ``n`` per-super-block trees of a stacked tree, each leaf
    ``torch.unbind``'s view: its backward stacks every super-block's
    gradient into the stacked leaf once, where indexing each super-block
    (``_layer``) would add a zero-filled full-size gradient per
    super-block."""
    if isinstance(tree, dict):
        subs = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: subs[k][i] for k in tree} for i in range(n)]
    return list(torch.unbind(tree, 0))


def _embed_input(params, cfg, tokens, vis_embed):
    with trace.span("lm.embed"):
        x = L.embed_tokens(params["embed"], cfg, tokens)
        if cfg.family == "vlm":
            if vis_embed is None:
                raise ValueError("vlm family requires vis_embed")
            x = torch.cat([vis_embed.to(x.dtype), x], dim=1)
        return constrain(x, "batch", "seq", "embed")


_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """``remat="dots"``'s policy: keep the unbatched matmuls' outputs."""
    if op in _SAVED_DOTS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return ckpt.create_selective_checkpoint_contexts(_save_dots)


def checkpointed(fn, remat: str):
    """``fn`` run under ``remat``'s checkpointing (``"full"``: plain,
    ``"dots"``: the matmul-saving policy) when autograd records it, else
    ``fn`` itself.  The recomputation runs under the mesh context of the
    forward pass: autograd runs a CUDA backward on a thread of its own,
    where the thread-local context is empty."""
    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        body = fn
        if active_mesh() is not None:
            context = (active_mesh(), active_rules())

            def body(*a):
                with use_mesh_and_rules(*context):
                    return fn(*a)
        if remat == "dots":
            return ckpt.checkpoint(body, *args, use_reentrant=False,
                                   context_fn=_dots_context)
        return ckpt.checkpoint(body, *args, use_reentrant=False)
    return run


def _attn_sublayer(lp, cfg, x, positions):
    h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    return attn_lib.attention(lp["attn"], cfg, h, positions)


def _ffn_sublayer(lp, cfg, x):
    """(y, moe aux or None)."""
    h = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
    with trace.span("lm.ffn"):
        if "moe" in lp:
            return moe_lib.moe_block(lp["moe"], cfg, h)
        return L.mlp(lp["mlp"], cfg, h), None


def _ssm_sublayer(lp, cfg, x):
    return ssm_lib.ssm_block(lp["ssm"], cfg, L.rmsnorm(lp["ln"], x,
                                                        cfg.norm_eps))


def _layers(params, cfg):
    """(name, kind, that layer's params) of every layer in order, super-block
    by super-block; the hybrid's shared block at each invocation."""
    n_super, kinds = superblock_layout(cfg)
    for l in range(n_super):
        bp = _layer(params["blocks"], l)
        for i, kind in enumerate(kinds):
            name = f"l{i}_{kind}"
            yield l, name, kind, (params["shared_attn"]
                                  if kind == "shared_attn" else bp[name])


def _call(fn, *args):
    return fn(*args)


def _superblock(cfg, kinds, shared, positions, bp, x, aux):
    """One super-block (params ``bp``) over the full sequence: (x, aux)."""
    sub = checkpointed(_call, "full") if cfg.remat == "outputs" else _call
    for i, kind in enumerate(kinds):
        lp = shared if kind == "shared_attn" else bp[f"l{i}_{kind}"]
        if kind == "ssm":
            x = x + sub(functools.partial(_ssm_sublayer, lp, cfg), x)
            x = constrain(x, "batch", "seq", "embed")
            continue
        x = x + sub(functools.partial(_attn_sublayer, lp, cfg), x, positions)
        y, a = sub(functools.partial(_ffn_sublayer, lp, cfg), x)
        x = x + y
        if a is not None:
            aux = aux + a
        x = constrain(x, "batch", "seq", "embed")
    return x, aux


def _pattern_mixer(kind, lp, cfg, x, positions):
    """A ``layer_pattern`` layer's mixer over its normed input."""
    h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    if kind == "mamba":
        with trace.span("lm.ssm"):
            return ssm_lib.ssm_block(lp["ssm"], cfg, h)
    return attn_lib.attention(lp["attn"], cfg, h, positions,
                              rope=not cfg.nope)


def _pattern_ffn(lp, cfg, x):
    """A ``layer_pattern`` layer's FFN, the dropless MoE with its shared
    MLP, over its normed input."""
    h = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
    with trace.span("lm.ffn"), trace.span("lm.moe"):
        return moe_lib.moe_dropless(lp["moe"], cfg, h)


def _pattern_superblock(cfg, kinds, shared, positions, bp, x, aux):
    """One ``layer_pattern`` super-block over the full sequence: (x, aux;
    the dropless MoE adds no aux loss)."""
    sub = checkpointed(_call, "full") if cfg.remat == "outputs" else _call
    r = cfg.residual_multiplier
    for i, kind in enumerate(kinds):
        lp = bp[f"l{i}_{kind}"]
        x = x + sub(functools.partial(_pattern_mixer, kind, lp, cfg), x,
                    positions) * r
        x = x + sub(functools.partial(_pattern_ffn, lp, cfg), x) * r
        x = constrain(x, "batch", "seq", "embed")
    return x, aux


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            vis_embed: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns (logits, moe_aux_loss)."""
    x = _embed_input(params, cfg, tokens, vis_embed)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    n_super, kinds = superblock_layout(cfg)
    body = _pattern_superblock if cfg.layer_pattern else _superblock
    run = functools.partial(body, cfg, kinds,
                            params.get("shared_attn"), positions)
    if cfg.remat in ("full", "dots"):
        run = checkpointed(run, cfg.remat)
    elif cfg.remat not in ("none", "outputs"):
        raise ValueError(f"unknown remat {cfg.remat!r}")
    for bp in unstack(params["blocks"], n_super):
        x, aux = run(bp, x, aux)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed(params["embed"], cfg, x)
    return constrain(logits, "batch", "seq", "vocab"), aux


def init_lm_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                  device=None) -> dict:
    """Decode cache stacked over super-blocks (mirrors params['blocks'],
    plus one KV cache per shared-attention invocation)."""
    n_super, kinds = superblock_layout(cfg)
    dt = cfg.activation_dtype()
    cache = {}
    with trace.span("lm.cache"):
        for i, kind in enumerate(kinds):
            if kind in ("ssm", "mamba"):
                cache[f"l{i}_{kind}"] = ssm_lib.init_ssm_cache(
                    cfg, batch, dt, device=device, stack=(n_super,))
            else:
                cache[f"l{i}_{kind}"] = attn_lib.init_cache(
                    cfg, batch, max_len, dt, device=device,
                    stack=(n_super,))
    return cache


def spec_lm_cache(cfg: ModelConfig) -> dict:
    kinds = superblock_layout(cfg)[1]
    return L.stack_spec({
        f"l{i}_{kind}": (ssm_lib.spec_ssm_cache() if kind in ("ssm", "mamba")
                         else attn_lib.spec_cache())
        for i, kind in enumerate(kinds)})


def constrain_tree(tree, specs):
    """``constrain`` of every leaf of ``tree`` by its spec in ``specs``."""
    if isinstance(tree, dict):
        return {k: constrain_tree(v, specs[k]) for k, v in tree.items()}
    return constrain(tree, *specs)


def _decode_layers(params, cfg, x, cache, pos):
    for l, name, kind, lp in _layers(params, cfg):
        lc = _layer(cache[name], l)
        if kind == "ssm":
            h = L.rmsnorm(lp["ln"], x, cfg.norm_eps)
            y, _ = ssm_lib.ssm_decode_step(lp["ssm"], cfg, h, lc)
            x = x + y
            continue
        h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        y, _ = attn_lib.decode_attention(lp["attn"], cfg, h, lc, pos)
        x = x + y
        x = x + _ffn_sublayer(lp, cfg, x)[0]
    return x


def _pattern_decode_layers(params, cfg, x, cache, pos):
    r = cfg.residual_multiplier
    for l, name, kind, lp in _layers(params, cfg):
        lc = _layer(cache[name], l)
        h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        if kind == "mamba":
            y, _ = ssm_lib.ssm_decode_step(lp["ssm"], cfg, h, lc)
        else:
            y, _ = attn_lib.decode_attention(lp["attn"], cfg, h, lc, pos,
                                             rope=not cfg.nope)
        x = x + y * r
        x = x + _pattern_ffn(lp, cfg, x) * r
    return x


def decode_step(params: dict, cfg: ModelConfig, token: torch.Tensor,
                cache: dict, pos) -> tuple[torch.Tensor, dict]:
    """One decode step.  token: [B] int; pos: int or 0-d tensor (every row
    at that position) or an int tensor [B] (row b at ``pos[b]``).
    -> (logits [B, V], cache), the cache updated in place."""
    x = L.embed_tokens(params["embed"], cfg, token[:, None])
    x = constrain(x, "batch", None, "embed")
    pos = attn_lib.row_positions(pos, x.shape[0], x.device)
    layers = _pattern_decode_layers if cfg.layer_pattern else _decode_layers
    x = layers(params, cfg, x, cache, pos)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed(params["embed"], cfg, x)[:, 0]
    return constrain(logits, "batch", "vocab"), cache


def _prefill_layers(params, cfg, x, positions, cache):
    for l, name, kind, lp in _layers(params, cfg):
        lc = _layer(cache[name], l)
        if kind == "ssm":
            h = L.rmsnorm(lp["ln"], x, cfg.norm_eps)
            y, c = ssm_lib.ssm_block(lp["ssm"], cfg, h, return_cache=True)
            x = x + y
            for key, t in c.items():
                local_copy_(lc[key], t)
            x = constrain(x, "batch", "seq", "embed")
            continue
        h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        y, (k, v) = attn_lib.attention(lp["attn"], cfg, h, positions,
                                       return_kv=True)
        attn_lib.prefill_into_cache(lc, k, v)
        x = x + y
        x = x + _ffn_sublayer(lp, cfg, x)[0]
        x = constrain(x, "batch", "seq", "embed")
    return x


def _pattern_prefill_layers(params, cfg, x, positions, cache):
    r = cfg.residual_multiplier
    for l, name, kind, lp in _layers(params, cfg):
        lc = _layer(cache[name], l)
        h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        if kind == "mamba":
            with trace.span("lm.ssm"):
                y, c = ssm_lib.ssm_block(lp["ssm"], cfg, h,
                                         return_cache=True)
            with trace.span("lm.cache"):
                for key, t in c.items():
                    local_copy_(lc[key], t)
        else:
            y, (k, v) = attn_lib.attention(lp["attn"], cfg, h, positions,
                                           rope=not cfg.nope, return_kv=True)
            attn_lib.prefill_into_cache(lc, k, v)
        x = x + y * r
        x = x + _pattern_ffn(lp, cfg, x) * r
        x = constrain(x, "batch", "seq", "embed")
    return x


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            vis_embed: torch.Tensor | None = None,
            max_len: int | None = None) -> tuple[torch.Tensor, dict]:
    """Prefill: full-sequence pass producing last-position logits + cache.
    An ``ssm``/``hybrid`` prompt longer than ``ssm_chunk`` must be a
    multiple of it (``ssm_block`` raises otherwise)."""
    with trace.span("lm.prefill"):
        x = _embed_input(params, cfg, tokens, vis_embed)
        s = x.shape[1]
        max_len = max_len or cfg.max_cache_len or s
        positions = torch.arange(s, dtype=torch.int32, device=x.device)
        cache = constrain_tree(
            init_lm_cache(cfg, x.shape[0], max_len, device=x.device),
            spec_lm_cache(cfg))
        layers = (_pattern_prefill_layers if cfg.layer_pattern
                  else _prefill_layers)
        x = layers(params, cfg, x, positions, cache)
        x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        logits = L.unembed(params["embed"], cfg, x[:, -1:])[:, 0]
        return constrain(logits, "batch", "vocab"), cache

