"""Grouped-query attention: flash-style train/prefill and cached decode.

The JAX package's ``models/attention.py`` on torch.  Full-sequence
attention runs either the online-softmax loop over KV chunks in plain
torch (``attn_impl="xla"``) or, with ``attn_impl="pallas"``, the flash
attention kernel B9 (``repro_torch.kernels.flash_attention``) for every
self-attention length: B9 tiles ragged lengths itself, where the JAX
package's TPU kernel takes the chunked loop unless the length divides
``min(attn_chunk, S)``.  Scores are scaled by ``cfg.attn_scale`` (Granite's
``attention_multiplier``, else ``1/sqrt(head_dim)``); ``rope=False`` is the
NoPE of Granite 4.0's attention layers.  B9 is forward-only, so ``"pallas"`` raises under
autograd (train with ``"xla"``).  Decode reads and writes a KV
cache; the port writes the cache in place (the JAX package returns a new
one), reproducing ``dynamic_update_slice``'s clamp of the write position to
the cache's last slot.  The ``constrain`` calls stand where the JAX
package's do; under an active mesh B9 runs on each rank's batch rows and
heads (the port expands KV heads to the q heads before B9, so every rank's
q heads find their KV heads locally), and the cache writes land where each
rank holds the cache.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rope_qk, truncated_normal
from repro_torch.parallel.sharding import (constrain, local_call,
                                           local_index_put_, local_window,
                                           replicated)
from repro_torch.runtime import trace

NEG_INF = -1e30


def _h_tot(cfg: ModelConfig) -> int:
    return cfg.n_heads + cfg.head_pad


def _head_mask(cfg: ModelConfig, device=None):
    """1 for real heads, 0 for padding heads (kept dead at use sites)."""
    if not cfg.head_pad:
        return None
    return torch.arange(_h_tot(cfg), device=device) < cfg.n_heads


def head_to_kv_map(cfg: ModelConfig, device=None) -> torch.Tensor:
    """Which KV head each (possibly padded) q head attends with.

    Real heads keep the *original* GQA grouping (h // (H/KV)) so padding is
    semantics-preserving; dead pad heads read kv 0 (their output is masked).
    """
    g = cfg.n_heads // cfg.n_kv_heads
    real = torch.arange(cfg.n_heads, device=device) // g
    pad = torch.zeros(cfg.head_pad, dtype=real.dtype, device=device)
    return torch.cat([real, pad]).to(torch.int32)


def init_attention(generator: torch.Generator, cfg: ModelConfig, *,
                   stack: tuple = ()) -> dict:
    """Attention params, each leaf with the leading ``stack`` axes."""
    d, h, kv, hd = cfg.d_model, _h_tot(cfg), cfg.n_kv_heads, cfg.head_dim
    s = 1.0 / math.sqrt(d)
    wq = truncated_normal(generator, stack + (d, h, hd), s)
    wk = truncated_normal(generator, stack + (d, kv, hd), s)
    wv = truncated_normal(generator, stack + (d, kv, hd), s)
    wo = truncated_normal(generator, stack + (h, hd, d), 1.0 / math.sqrt(h * hd))
    if cfg.head_pad:  # dead heads start (and are masked) at zero
        wq[..., cfg.n_heads:, :] = 0.0
        wo[..., cfg.n_heads:, :, :] = 0.0
    return {"wq": wq, "wk": wk, "wv": wv, "wo": wo}


def spec_attention() -> dict:
    return {
        "wq": ("embed", "heads", "head_dim"),
        "wk": ("embed", "kv_heads", "head_dim"),
        "wv": ("embed", "kv_heads", "head_dim"),
        "wo": ("heads", "head_dim", "embed"),
    }


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk", x, w) in x's dtype."""
    d, h, k = w.shape
    y = torch.matmul(x, w.to(x.dtype).reshape(d, h * k))
    return y.reshape(x.shape[:-1] + (h, k))


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd", out, wo)."""
    h, k, d = wo.shape
    return torch.matmul(out.reshape(out.shape[:-2] + (h * k,)),
                        wo.reshape(h * k, d))


def _project_qkv(params, cfg: ModelConfig, xq, xkv):
    return (_proj(xq, params["wq"]), _proj(xkv, params["wk"]),
            _proj(xkv, params["wv"]))


def _flash_over_kv(q_blk, kc, vc, pc, q_pos_blk, causal, scale):
    """Online-softmax loop of one q block over a list of KV chunks.

    q_blk: [B,Sq,H,hd]; kc/vc: lists of [B,chunk,H,hd]; pc: list of [chunk].
    Scores, max and sum in float32; ``p`` and the accumulator in q's dtype,
    as the JAX package's scan.
    """
    b, sq, h, hd = q_blk.shape
    dt = q_blk.dtype
    qh = q_blk.permute(0, 2, 1, 3)                          # [B,H,Sq,hd]
    acc = torch.zeros((b, h, sq, hd), dtype=dt, device=q_blk.device)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32,
                   device=q_blk.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q_blk.device)
    for kci, vci, pci in zip(kc, vc, pc):
        s = torch.matmul(qh, kci.permute(0, 2, 3, 1)).float() * scale
        if causal:
            mask = pci[None, :] > q_pos_blk[:, None]
        else:
            mask = (pci >= 2**30)[None, :].expand(sq, -1)
        s = s.masked_fill(mask[None, None], NEG_INF)
        s = constrain(s, "batch", "heads", None, None)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.matmul(p.to(dt), vci.permute(0, 2, 1, 3))
        acc = acc * corr[..., None].to(dt) + pv
        m = m_new
    return acc / torch.clamp(l, min=1e-30)[..., None].to(dt)


def _flash_chunks(q, k, v, q_pos, kv_pos, cfg: ModelConfig, causal: bool):
    """Online-softmax attention over KV chunks with causal block skipping.

    q: [B,Sq,H,hd]; k,v: [B,Skv,H,hd] (KV heads pre-expanded to H);
    positions int32 [Sq]/[Skv].  For causal self-attention (Sq == Skv) the
    q axis is blocked (at most 8 blocks, each a multiple of the KV chunk)
    and each q block only visits its KV prefix.
    """
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    chunk = min(cfg.attn_chunk, skv)
    n_chunks = -(-skv // chunk)
    pad = n_chunks * chunk - skv
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = torch.nn.functional.pad(kv_pos, (0, pad), value=2**30)
    kc = list(k.split(chunk, dim=1))
    vc = list(v.split(chunk, dim=1))
    pc = list(kv_pos.split(chunk))
    scale = cfg.attn_scale

    blockable = causal and sq == skv and n_chunks > 1 and pad == 0
    if not blockable:
        out = _flash_over_kv(q, kc, vc, pc, q_pos, causal, scale)
        return out.permute(0, 2, 1, 3)

    chunks_per_block = max(1, -(-n_chunks // 8))
    q_block = chunks_per_block * chunk
    n_blocks = -(-sq // q_block)
    outs = []
    for i in range(n_blocks):
        lo, hi = i * q_block, min((i + 1) * q_block, sq)
        kv_hi = -(-hi // chunk)  # KV prefix covering this block
        outs.append(_flash_over_kv(q[:, lo:hi], kc[:kv_hi], vc[:kv_hi],
                                   pc[:kv_hi], q_pos[lo:hi], True, scale))
    return torch.cat(outs, dim=2).permute(0, 2, 1, 3)  # [B,Sq,H,hd]


def _expand_kv(t: torch.Tensor, hmap: torch.Tensor) -> torch.Tensor:
    """``t.index_select(2, hmap)``.  On a DTensor each rank selects from its
    rows with the KV heads whole: DTensor's ``index_select`` backward fails
    on a split batch."""
    if not hasattr(t, "placements"):
        return t.index_select(2, hmap)
    t = constrain(t, "batch", "seq", None, "head_dim")
    return local_call(lambda a: a.index_select(2, hmap), (t,), t.placements)


def attention(params, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor, *, causal: bool = True,
              rope: bool = True, kv_override=None, return_kv: bool = False):
    """Full-sequence attention (train / prefill / cross)."""
    with trace.span("lm.attention"):
        b, s, _ = x.shape
        if kv_override is None:
            q, k, v = _project_qkv(params, cfg, x, x)
            kv_pos = positions
        else:
            q = _proj(x, params["wq"])
            k, v = kv_override
            kv_pos = torch.arange(k.shape[1], dtype=torch.int32,
                                  device=x.device)
        if rope and kv_override is None:
            with trace.span("attn.rope"):
                q, k = rope_qk(cfg, q, k, positions)
        q = constrain(q, "batch", "seq", "heads", "head_dim")
        k = constrain(k, "batch", "seq", "kv_heads", "head_dim")
        v = constrain(v, "batch", "seq", "kv_heads", "head_dim")
        kv_out = (k, v)
        if _h_tot(cfg) != cfg.n_kv_heads:
            # expand KV per q-head (original GQA grouping kept under head
            # padding)
            hmap = head_to_kv_map(cfg, x.device)
            k = _expand_kv(k, hmap)
            v = _expand_kv(v, hmap)
            k = constrain(k, "batch", "seq", "heads", "head_dim")
            v = constrain(v, "batch", "seq", "heads", "head_dim")
        use_kernel = cfg.attn_impl == "pallas" and k.shape[1] == s
        # the flash attention kernel B9: score blocks stay on chip.  Its tiles
        # are its own; the block passed only has to divide s.
        blk = math.gcd(s, min(cfg.attn_chunk, s, 128))

        def core(q, k, v):
            with trace.span("attn.core"):
                if use_kernel:
                    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                          v.transpose(1, 2), causal=causal,
                                          bq=blk, bk=blk, scale=cfg.attn_scale)
                    return out.transpose(1, 2)
                return _flash_chunks(q, k, v, positions, kv_pos, cfg, causal)

        if hasattr(q, "placements"):
            # under a mesh each rank attends over the batch rows and heads it
            # holds (B9 takes device pointers, never a DTensor)
            k = k.redistribute(q.device_mesh, q.placements)
            v = v.redistribute(q.device_mesh, q.placements)
            out = local_call(core, (q, k, v), q.placements)
        else:
            out = core(q, k, v)
        wo = params["wo"].to(x.dtype)
        mask = _head_mask(cfg, x.device)
        if mask is not None:
            wo = wo * mask[:, None, None].to(wo.dtype)
        y = _out_proj(out, wo)
        if return_kv:
            return y, kv_out
        return y


def project_cross_kv(params, cfg: ModelConfig, memory: torch.Tensor):
    """Precompute cross-attention K/V from encoder memory."""
    return _proj(memory, params["wk"]), _proj(memory, params["wv"])


# ---------------------------------------------------------------------------
# cached decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, *,
               device=None, stack: tuple = ()) -> dict:
    shape = stack + (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def spec_cache() -> dict:
    return {"k": ("batch", "kv_seq", "kv_heads", "head_dim"),
            "v": ("batch", "kv_seq", "kv_heads", "head_dim")}


def prefill_into_cache(cache: dict, k: torch.Tensor,
                       v: torch.Tensor) -> dict:
    """Write a prefill's k, v [B, S, KV, hd] into the cache's first S slots,
    in place (each rank its own shard of a DTensor cache); returns the
    cache."""
    with trace.span("lm.cache"):
        b, s = k.shape[:2]
        max_len = cache["k"].shape[1]
        if s > max_len:
            raise ValueError(f"prefill of {s} tokens exceeds the cache's "
                             f"{max_len} slots")
        if not hasattr(cache["k"], "placements"):
            cache["k"][:, :s] = k.to(cache["k"].dtype)
            cache["v"][:, :s] = v.to(cache["v"].dtype)
            return cache
        dev = cache["k"].device
        at = (torch.arange(b, device=dev).repeat_interleave(s),
              torch.arange(s, device=dev).repeat(b))
        for name, t in (("k", k), ("v", v)):
            local_index_put_(cache[name], at,
                             t.reshape((b * s,) + t.shape[2:]))
        return cache


def row_positions(pos, batch: int, device) -> torch.Tensor:
    """A decode position as an int32 tensor [B]: an int or 0-d tensor puts
    every row at it, an int tensor [B] gives row b its own ``pos[b]``."""
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        if pos.shape != (batch,):
            raise ValueError(f"per-row positions must be [{batch}], got "
                             f"{tuple(pos.shape)}")
        return pos.to(device=device, dtype=torch.int32)
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.int32).expand(batch)
    return torch.full((batch,), int(pos), dtype=torch.int32, device=device)


def decode_attention(params, cfg: ModelConfig, x: torch.Tensor, cache: dict,
                     pos, *, rope: bool = True,
                     update_cache: bool = True) -> tuple[torch.Tensor, dict]:
    """One-token attention against the cache.

    x: [B, 1, D]; pos: the current position, an int or 0-d tensor (every row
    at it) or an int tensor [B] (see :func:`row_positions`).  Row b takes the
    RoPE angle of ``pos[b]``, masks the cache to ``arange(S) <= pos[b]`` and,
    with ``update_cache``, writes its new k, v at ``pos[b]`` clamped into
    [0, max_len - 1] (``dynamic_update_slice``'s clamp: a write past the end
    lands in the last slot), in place in ``cache``'s tensors; the same dict
    is returned.  ``update_cache=False`` reads without writing
    (cross-attention).
    """
    b = x.shape[0]
    pos = row_positions(pos, b, x.device)
    q, k_new, v_new = _project_qkv(params, cfg, x, x)
    # the projection sharded as its weight, then the small q replicated
    # over the heads for the cache products
    q = constrain(q, "batch", None, "heads", "head_dim")
    q = constrain(q, "batch", None, None, None)
    if rope:
        q, k_new = rope_qk(cfg, q, k_new, pos[:, None])        # [B, 1]
    k, v = cache["k"], cache["v"]
    s_len = k.shape[1]
    if update_cache:
        at = (torch.arange(b, device=x.device), pos.long().clamp(0, s_len - 1))
        local_index_put_(k, at, k_new[:, 0])
        local_index_put_(v, at, v_new[:, 0])
        k = constrain(k, "batch", "kv_seq", "kv_heads", "head_dim")
        v = constrain(v, "batch", "kv_seq", "kv_heads", "head_dim")
    if hasattr(q, "placements") or hasattr(k, "placements"):
        out = _decode_sharded(q, k, v, pos, cfg)
    else:
        out = _decode_core(q, k, v, pos, cfg)
    wo = params["wo"][: cfg.n_heads].to(x.dtype)
    return _out_proj(out, wo), cache


def _decode_core(q, k, v, pos, cfg: ModelConfig, seq_offset: int = 0,
                 reduce=None):
    """One token's attention: q [B, 1, H, hd] against k, v [B, S, KV, hd]
    (positions ``seq_offset`` on), row b seeing positions <= ``pos[b]``.
    ``reduce(t, op)`` sums (``op="sum"``) or maxes over the ranks that hold
    the other positions; ``None`` when these are all of them."""
    b, g = q.shape[0], cfg.n_heads // cfg.n_kv_heads
    s_len = k.shape[1]
    # grouped form over the real heads only (pad heads are dead)
    q = q[..., : cfg.n_heads, :]
    qg = q.reshape(b, cfg.n_kv_heads, g, cfg.head_dim)         # [B,KV,G,hd]
    scores = torch.matmul(qg, k.to(qg.dtype).permute(0, 2, 3, 1))  # [B,KV,G,S]
    scores = (scores.float() * cfg.attention_multiplier
              if cfg.attention_multiplier
              else scores.float() / math.sqrt(cfg.head_dim))
    at = torch.arange(s_len, device=q.device)
    if seq_offset:
        at = at + seq_offset
    valid = at <= pos[:, None, None, None]
    scores = scores.masked_fill(~valid, NEG_INF)
    if reduce is None:
        probs = torch.softmax(scores, dim=-1).to(qg.dtype)
        out = torch.matmul(probs, v.to(qg.dtype).permute(0, 2, 1, 3))
    else:  # a softmax over positions split across ranks (flash-decode)
        m = reduce(scores.amax(dim=-1, keepdim=True), "max")
        p = torch.exp(scores - m)
        probs = (p / reduce(p.sum(dim=-1, keepdim=True), "sum")).to(qg.dtype)
        out = reduce(torch.matmul(probs, v.to(qg.dtype).permute(0, 2, 1, 3)),
                     "sum")
    return out.reshape(b, 1, cfg.n_heads, cfg.head_dim)        # [B,1,H,hd]


def _decode_sharded(q, k, v, pos, cfg: ModelConfig):
    """:func:`_decode_core` on each rank's shard of the cache: the cache
    split by batch rows and positions (its heads gathered), q by the same
    rows; the softmax and the value sum reduced over the ranks that split
    the positions."""
    from torch.distributed._functional_collectives import all_reduce
    from torch.distributed.tensor import Replicate, Shard

    mesh = (k if hasattr(k, "placements") else q).device_mesh
    q, k, v = (replicated(mesh, t) for t in (q, k, v))
    if hasattr(pos, "full_tensor"):
        pos = pos.full_tensor()
    kv_pl = tuple(p if isinstance(p, Shard) and p.dim in (0, 1)
                  else Replicate() for p in k.placements)
    q_pl = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in kv_pl)
    k = k.redistribute(mesh, kv_pl)
    v = v.redistribute(mesh, kv_pl)
    q = q.redistribute(mesh, q_pl)
    seq_dims = [i for i, p in enumerate(kv_pl)
                if isinstance(p, Shard) and p.dim == 1]
    size, off = local_window(k.shape, mesh, kv_pl)
    pos = pos.narrow(0, off[0], size[0])

    def reduce(t, op):
        for i in seq_dims:
            t = all_reduce(t, op, (mesh, i))
        return t

    return local_call(
        lambda q_, k_, v_: _decode_core(q_, k_, v_, pos, cfg, off[1],
                                        reduce if seq_dims else None),
        (q, k, v), q_pl)
