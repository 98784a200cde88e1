"""Decoder-only language models: dense / MoE / SSM / hybrid / VLM.

The JAX package's ``models/lm.py`` on torch.  Parameters are stacked over a
leading super-block axis, as in the JAX package, and a Python loop over the
super-blocks indexes each leaf (the JAX package scans).  A super-block is a
list of layer kinds (``superblock_layout``), the family's repeating pattern
or ``cfg.layer_pattern``'s letters (``M`` mamba, ``A`` attn).  Each kind is
a mixer and an FFN (``LAYER_KINDS``):

  kind         mixer      FFN    used by
  dense        attention  MLP    dense, vlm (patch embeddings prepended),
                                 moe's first ``moe_interleave - 1`` layers
  moe          attention  MoE    moe's last layer
  shared_attn  attention  MLP    hybrid: after ``attn_every`` ssm layers,
                                 one parameter set outside the stack reused
                                 by every invocation, each with its own KV
                                 cache (zamba2's weight tying)
  ssm          mamba2     -      ssm, hybrid
  mamba        mamba2     MoE    ``layer_pattern``'s ``M`` (granite 4.0-h)
  attn         attention  MoE    ``layer_pattern``'s ``A``

A layer with an FFN norms the mixer's input with ``ln1`` and the FFN's with
``ln2``; one without norms with ``ln``.  Attention takes no RoPE under
``cfg.nope``, the MoE is ``moe_dropless`` under ``cfg.moe_dropless`` (with
its shared MLP, no aux loss), and every sub-layer's output joins the
residual stream scaled by ``cfg.residual_multiplier``.  One cache tree holds
the mamba2 layers' states beside the attention layers' KV caches.

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


LAYER_KINDS = {"dense": ("attn", "mlp"), "moe": ("attn", "moe"),
               "shared_attn": ("attn", "mlp"), "ssm": ("ssm", None),
               "mamba": ("ssm", "moe"), "attn": ("attn", "moe")}

_SPEC = {"attn": lambda cfg: attn_lib.spec_attention(),
         "ssm": ssm_lib.spec_ssm, "mlp": L.spec_mlp, "moe": moe_lib.spec_moe}
_INIT = {"attn": attn_lib.init_attention, "ssm": ssm_lib.init_ssm,
         "mlp": L.init_mlp, "moe": moe_lib.init_moe}


def _spec_layer(kind, cfg):
    mixer, ffn = LAYER_KINDS[kind]
    if ffn is None:
        return {"ln": L.spec_rmsnorm(), mixer: _SPEC[mixer](cfg)}
    return {"ln1": L.spec_rmsnorm(), mixer: _SPEC[mixer](cfg),
            "ln2": L.spec_rmsnorm(), ffn: _SPEC[ffn](cfg)}


def spec_lm(cfg: ModelConfig) -> dict:
    """``init_lm``'s tree with a tuple of logical axis names a leaf, the
    stacked blocks' led by ``"layers"``."""
    kinds = superblock_layout(cfg)[1]
    specs = {"embed": L.spec_embed(cfg), "final_norm": L.spec_rmsnorm(),
             "blocks": L.stack_spec({f"l{i}_{kind}": _spec_layer(kind, cfg)
                                     for i, kind in enumerate(kinds)
                                     if kind != "shared_attn"})}
    if "shared_attn" in kinds:
        specs["shared_attn"] = _spec_layer("shared_attn", cfg)
    return specs


def _init_layer(kind, generator, cfg, stack):
    """A layer's params, drawn in the order ``{ln1, mixer, ln2, ffn}``."""
    mixer, ffn = LAYER_KINDS[kind]

    def norm():
        return L.init_rmsnorm(cfg.d_model, generator.device, stack=stack)

    def part(name):
        return _INIT[name](generator, cfg, stack=stack)

    if ffn is None:
        return {"ln": norm(), mixer: part(mixer)}
    return {"ln1": norm(), mixer: part(mixer), "ln2": norm(), ffn: part(ffn)}


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
        params["shared_attn"] = _init_layer("shared_attn", generator, cfg, ())
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


def _mixer_input(kind, lp, cfg, x):
    norm = "ln" if LAYER_KINDS[kind][1] is None else "ln1"
    return L.rmsnorm(lp[norm], x, cfg.norm_eps)


def _mixer(kind, lp, cfg, x, positions, lc=None):
    """A layer's mixer over its normed input; a prefill passes the layer's
    cache ``lc``, which it fills."""
    h = _mixer_input(kind, lp, cfg, x)
    if LAYER_KINDS[kind][0] == "ssm":
        with trace.span("lm.ssm"):
            out = ssm_lib.ssm_block(lp["ssm"], cfg, h,
                                    return_cache=lc is not None)
        if lc is None:
            return out
        y, c = out
        with trace.span("lm.cache"):
            for key, t in c.items():
                local_copy_(lc[key], t)
        return y
    if lc is None:
        return attn_lib.attention(lp["attn"], cfg, h, positions,
                                  rope=not cfg.nope)
    y, (k, v) = attn_lib.attention(lp["attn"], cfg, h, positions,
                                   rope=not cfg.nope, return_kv=True)
    attn_lib.prefill_into_cache(lc, k, v)
    return y


def _ffn_sublayer(kind, lp, cfg, x):
    """A layer's FFN over its normed input: (y, moe aux or None)."""
    h = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
    with trace.span("lm.ffn"):
        if LAYER_KINDS[kind][1] == "mlp":
            return L.mlp(lp["mlp"], cfg, h), None
        with trace.span("lm.moe"):
            if cfg.moe_dropless:
                return moe_lib.moe_dropless(lp["moe"], cfg, h), None
            return moe_lib.moe_block(lp["moe"], cfg, h)


def _residual(cfg, x, y):
    """The residual stream after a sub-layer whose output is ``y``."""
    r = cfg.residual_multiplier
    return x + y if r == 1 else x + y * r


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
        x = _residual(cfg, x, sub(functools.partial(_mixer, kind, lp, cfg),
                                  x, positions))
        if LAYER_KINDS[kind][1] is not None:
            y, a = sub(functools.partial(_ffn_sublayer, kind, lp, cfg), x)
            x = _residual(cfg, x, y)
            if a is not None:
                aux = aux + a
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
    run = functools.partial(_superblock, cfg, kinds,
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
            if LAYER_KINDS[kind][0] == "ssm":
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
        f"l{i}_{kind}": (ssm_lib.spec_ssm_cache()
                         if LAYER_KINDS[kind][0] == "ssm"
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
        h = _mixer_input(kind, lp, cfg, x)
        if LAYER_KINDS[kind][0] == "ssm":
            y, _ = ssm_lib.ssm_decode_step(lp["ssm"], cfg, h, lc)
        else:
            y, _ = attn_lib.decode_attention(lp["attn"], cfg, h, lc, pos,
                                             rope=not cfg.nope)
        x = _residual(cfg, x, y)
        if LAYER_KINDS[kind][1] is not None:
            x = _residual(cfg, x, _ffn_sublayer(kind, lp, cfg, x)[0])
    return x


def decode_step(params: dict, cfg: ModelConfig, token: torch.Tensor,
                cache: dict, pos) -> tuple[torch.Tensor, dict]:
    """One decode step.  token: [B] int; pos: int or 0-d tensor (every row
    at that position) or an int tensor [B] (row b at ``pos[b]``).
    -> (logits [B, V], cache), the cache updated in place."""
    x = L.embed_tokens(params["embed"], cfg, token[:, None])
    x = constrain(x, "batch", None, "embed")
    pos = attn_lib.row_positions(pos, x.shape[0], x.device)
    x = _decode_layers(params, cfg, x, cache, pos)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed(params["embed"], cfg, x)[:, 0]
    return constrain(logits, "batch", "vocab"), cache


def _prefill_layers(params, cfg, x, positions, cache):
    for l, name, kind, lp in _layers(params, cfg):
        x = _residual(cfg, x, _mixer(kind, lp, cfg, x, positions,
                                     _layer(cache[name], l)))
        if LAYER_KINDS[kind][1] is not None:
            x = _residual(cfg, x, _ffn_sublayer(kind, lp, cfg, x)[0])
        x = constrain(x, "batch", "seq", "embed")
    return x


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            vis_embed: torch.Tensor | None = None,
            max_len: int | None = None) -> tuple[torch.Tensor, dict]:
    """Prefill: full-sequence pass producing last-position logits + cache.
    A prompt through mamba2 mixers longer than ``ssm_chunk`` must be a
    multiple of it (``ssm_block`` raises otherwise)."""
    with trace.span("lm.prefill"):
        x = _embed_input(params, cfg, tokens, vis_embed)
        s = x.shape[1]
        max_len = max_len or cfg.max_cache_len or s
        positions = torch.arange(s, dtype=torch.int32, device=x.device)
        cache = constrain_tree(
            init_lm_cache(cfg, x.shape[0], max_len, device=x.device),
            spec_lm_cache(cfg))
        x = _prefill_layers(params, cfg, x, positions, cache)
        x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        logits = L.unembed(params["embed"], cfg, x[:, -1:])[:, 0]
        return constrain(logits, "batch", "vocab"), cache

