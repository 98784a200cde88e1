"""Mixture-of-Experts block: top-k routing and capacity dispatch.

The JAX package's ``models/moe.py`` on torch: a GShard-style dropping MoE.
Tokens are grouped ``[G, T, D]``; a float32 router picks each token's top-k
experts (padded experts, e.g. qwen's 60 -> 64, are masked out of the
router, so routing behaves exactly like the unpadded model) and renormalises
their gates; each choice takes the next position in its expert's queue in
token-major order, and choices at or past the expert's capacity are dropped
(they fall through on the residual).  Dispatch and combine are gathers over
a per-group ``[G, E * C]`` slot table, as in the JAX package, whose
``custom_vjp`` forms exist for GSPMD's locality and are not needed here.
Under an active mesh the ``constrain`` calls stand where the JAX package's
do: the groups split over the DP axes, then the expert buffer flips to the
experts split over "data" (DTensor's redistribution is the expert-parallel
all-to-all) and back.

:func:`moe_dropless` is Granite 4.0's layer (``cfg.moe_dropless``), which
the JAX package lacks: a softmax over each token's top-k router logits, no
capacity, and only the experts this chip holds (``cfg.experts_first`` on,
``cfg.held`` of them) computed, as one chip of an expert-parallel group
computes its share; the router scores all ``n_experts``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import truncated_normal
from repro_torch.parallel.sharding import constrain
from repro_torch.runtime import trace


def init_moe(generator: torch.Generator, cfg: ModelConfig, *,
             stack: tuple = ()) -> dict:
    """MoE params, each leaf with the leading ``stack`` axes: the router
    over all ``n_experts``, the held experts' weights."""
    d, e, fe, eh = cfg.d_model, cfg.n_experts, cfg.d_ff_expert, cfg.held
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(fe)
    p = {"router": truncated_normal(generator, stack + (d, e), s_in),
         "wi": truncated_normal(generator, stack + (eh, d, fe), s_in),
         "wg": truncated_normal(generator, stack + (eh, d, fe), s_in),
         "wo": truncated_normal(generator, stack + (eh, fe, d), s_out)}
    if cfg.n_shared_experts:
        f_sh = cfg.n_shared_experts * cfg.d_ff_shared
        p["shared"] = {
            "wi": truncated_normal(generator, stack + (d, f_sh), s_in),
            "wg": truncated_normal(generator, stack + (d, f_sh), s_in),
            "wo": truncated_normal(generator, stack + (f_sh, d),
                                   1.0 / math.sqrt(f_sh))}
    return p


def spec_moe(cfg: ModelConfig) -> dict:
    p = {
        "router": ("embed", None),
        "wi": ("experts", "mlp_embed", "expert_ffn"),
        "wg": ("experts", "mlp_embed", "expert_ffn"),
        "wo": ("experts", "expert_ffn", "mlp_embed"),
    }
    if cfg.n_shared_experts:
        p["shared"] = {"wi": ("embed", "ffn"), "wg": ("embed", "ffn"),
                       "wo": ("ffn", "embed")}
    return p


def capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    """Slots per expert in a group of ``tokens_per_group`` tokens: the
    capacity factor's share, rounded up to a multiple of 4, at least 4."""
    c = math.ceil(tokens_per_group * cfg.top_k * cfg.capacity_factor
                  / cfg.n_experts)
    return max(4, -(-c // 4) * 4)


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of ``x`` [G, N, D] at ``idx`` [G, M], an index N reading zeros."""
    pad = torch.cat([x, x.new_zeros(x.shape[0], 1, x.shape[2])], dim=1)
    return torch.gather(pad, 1, idx[..., None].expand(-1, -1, x.shape[2]))


def moe_block(params: dict, cfg: ModelConfig,
              x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> (y, aux_loss)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    g = min(cfg.expert_groups, b)
    t = (b // g) * s
    cap = capacity(cfg, t)
    dt = x.dtype
    xg = x.reshape(g, t, d)
    xg = constrain(xg, "expert_group", None, None)

    # ---- router (float32) ----
    logits = torch.matmul(xg.float(), params["router"].float())   # [G,T,E]
    if cfg.n_experts_active < e:  # padded experts never receive tokens
        pad = torch.arange(e, device=x.device) >= cfg.n_experts_active
        logits = logits.masked_fill(pad, -1e30)
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k's order: largest first, equal values by lower index (a
    # stable descending sort; torch.topk leaves ties unordered)
    gate_vals, expert_idx = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals, expert_idx = gate_vals[..., :k], expert_idx[..., :k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    # ---- positions within each expert queue (dropping beyond capacity) ----
    flat_idx = expert_idx.reshape(g, t * k)
    onehot = F.one_hot(flat_idx, e)                                 # [G,T*k,E]
    onehot = constrain(onehot, "expert_group", None, None)
    pos_in_e = constrain(torch.cumsum(onehot, dim=1) - 1,
                         "expert_group", None, None)
    pos = torch.gather(pos_in_e, 2, flat_idx[..., None])[..., 0]
    keep = pos < cap

    # ---- dispatch: each kept choice owns one slot of its expert ----
    n_slots = e * cap
    slot_of_choice = torch.where(keep, flat_idx * cap + pos,
                                 torch.full_like(pos, n_slots))
    tok_of_choice = torch.arange(t, device=x.device).repeat_interleave(k)
    tok_of_slot = torch.full((g, n_slots + 1), t, dtype=torch.long,
                             device=x.device)
    tok_of_slot = tok_of_slot.scatter(1, slot_of_choice,
                                      tok_of_choice.expand(g, -1))
    tok_of_slot = constrain(tok_of_slot, "expert_group", None)
    slot_of_choice = constrain(slot_of_choice, "expert_group", None)
    buf = _gather_rows(xg, tok_of_slot[:, :n_slots]).reshape(g, e, cap, d)
    buf = constrain(buf, "expert_group", None, None, None)

    # ---- groups split -> experts split (the all-to-all) ----
    buf = constrain(buf, None, "experts", None, None)

    # ---- expert FFNs ----
    h = torch.einsum("gecd,edf->gecf", buf, params["wi"].to(dt))
    gt = torch.einsum("gecd,edf->gecf", buf, params["wg"].to(dt))
    h = h * F.silu(gt)
    h = constrain(h, None, "experts", None, "expert_ffn")
    out = torch.einsum("gecf,efd->gecd", h, params["wo"].to(dt))
    out = constrain(out, None, "experts", None, None)

    # ---- and back to the groups split ----
    out = constrain(out, "expert_group", None, None, None)

    # ---- combine with gates (dropped choices read the zero row) ----
    picked = _gather_rows(out.reshape(g, n_slots, d), slot_of_choice)
    w = (gate_vals.reshape(g, t * k) * keep).to(dt)
    picked = picked * w[..., None]
    y = picked.reshape(g, t, k, d).sum(dim=2).reshape(b, s, d)
    y = constrain(y, "batch", "seq", None)

    # ---- shared experts (plain dense MLP path) ----
    if cfg.n_shared_experts:
        sh = params["shared"]
        hs = torch.matmul(x, sh["wi"].to(dt))
        gs = torch.matmul(x, sh["wg"].to(dt))
        hs = constrain(hs * F.silu(gs), "batch", "seq", "ffn")
        y = y + torch.matmul(hs, sh["wo"].to(dt))

    # ---- load-balance aux (switch-style), over real experts only ----
    n_act = cfg.n_experts_active
    frac = onehot[..., :n_act].float().mean(dim=(0, 1))
    prob = probs[..., :n_act].mean(dim=(0, 1))
    aux = n_act * torch.sum(frac * prob)
    return y, aux.float()


# ---------------------------------------------------------------------------
# dropless, with the held experts alone (granite 4.0-h)
# ---------------------------------------------------------------------------

def dropless_rows(cfg: ModelConfig, tokens: int) -> int:
    """Rows of the expert buffer for ``tokens`` tokens: every choice of a
    held expert (a token makes at most ``min(top_k, held)``), and one
    padding row that no choice takes."""
    return tokens * min(cfg.top_k, cfg.held) + 1


def moe_dropless(params: dict, cfg: ModelConfig,
                 x: torch.Tensor) -> torch.Tensor:
    """x: [B, S, D] -> the held experts' part of the routed sum plus the
    shared MLP (no aux loss).

    Every choice of a held expert is kept: the choices are sorted by
    expert (stable, so token-major within one), each held expert's run of
    rows is one group of a grouped matmul (``torch._grouped_mm`` with the
    groups' ends as device offsets: no count leaves the device), and the
    buffer holds as many rows as the held experts could ever be given.
    Rows past the last choice hold no value (the grouped matmul leaves
    them unwritten, forward and backward): the combine reads the padding
    row for every choice not computed, their input rows and gates are the
    zero row and a ``where``, so nothing undefined reaches the output or a
    gradient.  The gate multiplies each row before the down projection
    (the same sum as after it).  While tracing counts, the layer counts its choices kept per
    held expert (``moe.kept``) and dropped (``moe.dropped``: choices of
    held experts past the buffer's rows, 0 by construction)."""
    b, s, d = x.shape
    t, k, eh = b * s, cfg.top_k, cfg.held
    dt = x.dtype
    xf = x.reshape(t, d)
    with trace.span("moe.route"):
        logits = torch.matmul(xf.float(), params["router"].float())  # [T,E]
        top, idx = torch.topk(logits, k, dim=-1)
        gates = torch.softmax(top, dim=-1).reshape(t * k)

    with trace.span("moe.dispatch"):
        rows = dropless_rows(cfg, t)
        local = idx.reshape(t * k) - cfg.experts_first
        held = (local >= 0) & (local < eh)
        key = torch.where(held, local, eh)          # other experts last
        order = torch.sort(key, stable=True).indices
        counts = torch.zeros(eh + 1, dtype=torch.long, device=x.device)
        counts = counts.scatter_add_(0, key, torch.ones_like(key))[:eh]
        offs = torch.cumsum(counts, 0).clamp(max=rows - 1).to(torch.int32)
        n = offs[-1]
        slots = torch.arange(rows - 1, device=x.device)
        head = order[: rows - 1]
        used = slots < n
        # each row's token (the zero row t past the last choice) and gate
        src = torch.where(used, head // k, t)
        gate_row = torch.where(used, gates[head], 0.0).to(dt)
        xs = F.pad(xf, (0, 0, 0, 1))[F.pad(src, (0, 1), value=t)]
        # each choice's row, the padding row where it is not computed
        place = torch.empty_like(order).scatter_(
            0, order, torch.arange(t * k, device=x.device))
        slot = torch.where(held & (place < n), place, rows - 1)
        if trace.counting():
            trace.count("moe.kept", torch.diff(offs, prepend=offs.new_zeros(1)))
            trace.count("moe.dropped", held.sum() - n)

    with trace.span("moe.experts"):
        h = torch._grouped_mm(xs, params["wi"].to(dt), offs=offs)
        g = torch._grouped_mm(xs, params["wg"].to(dt), offs=offs)
        a = h * F.silu(g) * F.pad(gate_row, (0, 1))[:, None]
        out = torch._grouped_mm(a, params["wo"].to(dt), offs=offs)

    with trace.span("moe.combine"):
        y = F.embedding_bag(slot.reshape(t, k), out, mode="sum",
                            padding_idx=rows - 1).reshape(b, s, d)

    if cfg.n_shared_experts:
        with trace.span("moe.shared"):
            sh = params["shared"]
            hs = torch.matmul(x, sh["wi"].to(dt))
            gs = torch.matmul(x, sh["wg"].to(dt))
            y = y + torch.matmul(hs * F.silu(gs), sh["wo"].to(dt))
    return y
