"""Mamba2 — state-space duality (SSD) blocks (arXiv:2405.21060).

The JAX package's ``models/ssm.py`` on torch.  Prefill and evaluation use
the chunked dual form: within-chunk attention-like scores (C B^T masked by
the decay kernel) plus an inter-chunk state recurrence (a loop over
chunks).  Decode is the O(1) recurrent update on a [B, H, state, headdim]
carry.  Single B/C group (n_groups=1) as in the mamba2-780m config; the
causal depthwise conv (window ``ssm_conv``) is applied to x, B and C, with
a bias on each channel under ``cfg.ssm_conv_bias`` (granite 4.0-h).  The
block's parts run in the spans ``ssm.proj``, ``ssm.conv``, ``ssm.scan``
and ``ssm.out``.
No kernel of the JAX package runs here: these are plain torch.  Under an
active mesh the chunked heads are constrained where the JAX package's are,
and a decode step writes each rank's shard of a DTensor cache.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import truncated_normal
from repro_torch.parallel.sharding import constrain, local_copy_
from repro_torch.runtime import trace


def _uniform(generator: torch.Generator, shape, lo: float,
             hi: float) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=generator.device)
    return lo + (hi - lo) * u


def init_ssm(generator: torch.Generator, cfg: ModelConfig, *,
             stack: tuple = ()) -> dict:
    """SSM params, each leaf with the leading ``stack`` axes.  A starts in
    [1, 16) as in mamba2; the dt bias is the inverse softplus of
    dt ~ U[1e-3, 1e-1] (log-uniform)."""
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    dev = generator.device
    s = 1.0 / math.sqrt(d)
    sc = 1.0 / math.sqrt(cfg.ssm_conv)
    a_init = torch.exp(_uniform(generator, stack + (h,), 0.0, math.log(16.0)))
    dt = torch.exp(_uniform(generator, stack + (h,), math.log(1e-3),
                            math.log(1e-1)))
    bias = {}
    if cfg.ssm_conv_bias:  # torch's Conv1d draw: U[-1/sqrt(K), 1/sqrt(K))
        bias = {f"{name}_bias": _uniform(generator, stack + (width,), -sc, sc)
                for name, width in (("conv_x", di), ("conv_b", n),
                                    ("conv_c", n))}
    return {**bias,
        "w_z": truncated_normal(generator, stack + (d, di), s),
        "w_x": truncated_normal(generator, stack + (d, di), s),
        "w_b": truncated_normal(generator, stack + (d, n), s),
        "w_c": truncated_normal(generator, stack + (d, n), s),
        "w_dt": truncated_normal(generator, stack + (d, h), s),
        "conv_x": truncated_normal(generator, stack + (cfg.ssm_conv, di), sc),
        "conv_b": truncated_normal(generator, stack + (cfg.ssm_conv, n), sc),
        "conv_c": truncated_normal(generator, stack + (cfg.ssm_conv, n), sc),
        "a_log": torch.log(a_init),
        "d_skip": torch.ones(stack + (h,), dtype=torch.float32, device=dev),
        "dt_bias": torch.log(torch.expm1(dt)),
        "norm": torch.ones(stack + (di,), dtype=torch.float32, device=dev),
        "w_out": truncated_normal(generator, stack + (di, d),
                                  1.0 / math.sqrt(di)),
    }


def spec_ssm(cfg: ModelConfig | None = None) -> dict:
    bias = {}
    if cfg is not None and cfg.ssm_conv_bias:
        bias = {"conv_x_bias": ("conv_dim",), "conv_b_bias": (None,),
                "conv_c_bias": (None,)}
    return {**bias,
        "w_z": ("embed", "conv_dim"), "w_x": ("embed", "conv_dim"),
        "w_b": ("embed", None), "w_c": ("embed", None),
        "w_dt": ("embed", "ssm_heads"),
        "conv_x": (None, "conv_dim"), "conv_b": (None, None),
        "conv_c": (None, None),
        "a_log": ("ssm_heads",), "d_skip": ("ssm_heads",),
        "dt_bias": ("ssm_heads",), "norm": ("conv_dim",),
        "w_out": ("conv_dim", "embed"),
    }


def _causal_conv(seq: torch.Tensor, w: torch.Tensor,
                 state: torch.Tensor | None = None, bias=0):
    """Depthwise causal conv along axis 1.  seq [B,S,C]; w [K,C]; state
    [B,K-1,C] the history (zeros when None); ``bias`` [C] (float32) or 0.
    -> (silu(out) in seq's dtype, new history)."""
    k = w.shape[0]
    if state is None:
        pad = seq.new_zeros(seq.shape[0], k - 1, seq.shape[2])
    else:
        pad = state.to(seq.dtype)
    full = torch.cat([pad, seq], dim=1)
    out = sum((full[:, i:i + seq.shape[1]] * w[i].to(seq.dtype)
               for i in range(k)), bias)
    return F.silu(out).to(seq.dtype), full[:, full.shape[1] - (k - 1):]


def _project(params, cfg: ModelConfig, u: torch.Tensor):
    dt_ = u.dtype
    z = torch.matmul(u, params["w_z"].to(dt_))
    x = torch.matmul(u, params["w_x"].to(dt_))
    bb = torch.matmul(u, params["w_b"].to(dt_))
    cc = torch.matmul(u, params["w_c"].to(dt_))
    dt = torch.matmul(u, params["w_dt"].to(dt_))
    dt = F.softplus(dt.float() + params["dt_bias"].float())
    return z, x, bb, cc, dt


def _gated_out(params, cfg: ModelConfig, y: torch.Tensor,
               z: torch.Tensor) -> torch.Tensor:
    y = y * F.silu(z)
    yf = y.float()
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    y = (yf * torch.rsqrt(var + 1e-5) * params["norm"]).to(z.dtype)
    return torch.matmul(y, params["w_out"].to(z.dtype))


def _conv_tail(seq: torch.Tensor, k: int) -> torch.Tensor:
    """The last ``k - 1`` rows of ``seq`` [B, S, C], as a decode step's conv
    history; a sequence shorter than that is preceded by zero rows (the
    history the causal conv assumes; the JAX package's tail would be short
    and its next decode step empty)."""
    tail = seq[:, max(seq.shape[1] - (k - 1), 0):]
    short = (k - 1) - tail.shape[1]
    if short:
        tail = torch.cat([tail.new_zeros(tail.shape[0], short, tail.shape[2]),
                          tail], dim=1)
    return tail


def ssm_block(params: dict, cfg: ModelConfig, u: torch.Tensor,
              return_cache: bool = False):
    """Chunked SSD scan over the full sequence.  u: [B, S, D]."""
    s = u.shape[1]
    q = min(cfg.ssm_chunk, s)
    if s % q:
        raise ValueError(f"seq {s} not divisible by ssm_chunk {q}")
    with trace.span("ssm.proj"):
        z, x, bb, cc, dt = _project(params, cfg, u)
    with trace.span("ssm.conv"):
        kc = cfg.ssm_conv
        conv_tails = {"conv_x": _conv_tail(x, kc),
                      "conv_b": _conv_tail(bb, kc),
                      "conv_c": _conv_tail(cc, kc)}
        x, _ = _causal_conv(x, params["conv_x"], None,
                            params.get("conv_x_bias", 0))
        bb, _ = _causal_conv(bb, params["conv_b"], None,
                             params.get("conv_b_bias", 0))
        cc, _ = _causal_conv(cc, params["conv_c"], None,
                             params.get("conv_c_bias", 0))
    with trace.span("ssm.scan"):
        y, state = _scan(params, cfg, x, bb, cc, dt)
    with trace.span("ssm.out"):
        out = _gated_out(params, cfg, y, z)
    if return_cache:
        return out, {"state": state, **conv_tails}
    return out


def _scan(params, cfg: ModelConfig, x, bb, cc, dt):
    """The chunked SSD over conv'd x [B,S,H*P], B, C [B,S,N] and dt
    [B,S,H] (float32): (y [B,S,H*P] in x's dtype, with D's skip; the
    state after the last token, float32 [B,H,N,P])."""
    b, s, _ = x.shape
    h, p, n = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    q = min(cfg.ssm_chunk, s)
    nc = s // q
    dev = x.device
    a = -torch.exp(params["a_log"].float())                    # [H]
    da = dt * a                                                # [B,S,H] (<=0)
    xh = x.reshape(b, nc, q, h, p)
    xh = constrain(xh, "batch", None, None, "ssm_heads", None)
    bc = bb.reshape(b, nc, q, n)
    ccc = cc.reshape(b, nc, q, n)
    dac = da.reshape(b, nc, q, h)
    dtc = dt.reshape(b, nc, q, h)

    cum = torch.cumsum(dac, dim=2)                             # [B,nc,Q,H]
    seg_sum = cum[:, :, -1]                                    # [B,nc,H]

    # ---- within-chunk (dual / attention-like) term ----
    rel = cum[:, :, :, None, :] - cum[:, :, None, :, :]        # [B,nc,Qi,Qj,H]
    tri = torch.tril(torch.ones(q, q, dtype=torch.bool, device=dev))
    l_kernel = torch.where(tri[None, None, :, :, None], torch.exp(rel),
                           torch.zeros((), device=dev))
    scores = torch.matmul(ccc, bc.transpose(-1, -2)).float()   # [B,nc,Qi,Qj]
    w = scores[..., None] * l_kernel * dtc[:, :, None]         # [B,nc,Qi,Qj,H]
    y_intra = torch.matmul(w.to(x.dtype).permute(0, 1, 4, 2, 3),
                           xh.permute(0, 1, 3, 2, 4))          # [B,nc,H,Qi,P]
    y_intra = y_intra.permute(0, 1, 3, 2, 4)                   # [B,nc,Qi,H,P]

    # ---- chunk boundary states + inter-chunk recurrence ----
    decay_to_end = torch.exp(seg_sum[:, :, None] - cum)        # [B,nc,Q,H]
    chunk_states = torch.einsum(
        "bcqn,bcqhp->bchnp", bc.float(),
        (dtc * decay_to_end)[..., None] * xh.float())
    state = torch.zeros((b, h, n, p), dtype=torch.float32, device=dev)
    prev = []
    for c in range(nc):                                        # state BEFORE c
        prev.append(state)
        state = state * torch.exp(seg_sum[:, c])[..., None, None] \
            + chunk_states[:, c]
    prev_states = torch.stack(prev, dim=1)                     # [B,nc,H,N,P]

    decay_from_start = torch.exp(cum)                          # [B,nc,Q,H]
    y_inter = torch.einsum("bcqn,bchnp->bcqhp", ccc.float(), prev_states)
    y_inter = y_inter * decay_from_start[..., None]

    y = y_intra.float() + y_inter
    y = y + xh.float() * params["d_skip"][:, None]
    return y.reshape(b, s, h * p).to(x.dtype), state


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_ssm_cache(cfg: ModelConfig, batch: int, dtype, *, device=None,
                   stack: tuple = ()) -> dict:
    h, p, n = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    k = cfg.ssm_conv

    def zeros(shape, dt):
        return torch.zeros(stack + shape, dtype=dt, device=device)

    return {"state": zeros((batch, h, n, p), torch.float32),
            "conv_x": zeros((batch, k - 1, cfg.d_inner), dtype),
            "conv_b": zeros((batch, k - 1, n), dtype),
            "conv_c": zeros((batch, k - 1, n), dtype)}


def spec_ssm_cache() -> dict:
    return {"state": ("batch", "ssm_heads", None, None),
            "conv_x": ("batch", None, "conv_dim"),
            "conv_b": ("batch", None, None),
            "conv_c": ("batch", None, None)}


def ssm_decode_step(params: dict, cfg: ModelConfig, u: torch.Tensor,
                    cache: dict) -> tuple[torch.Tensor, dict]:
    """One-token recurrent update.  u: [B, 1, D].  The cache's tensors are
    overwritten in place with the new state; the same dict is returned."""
    b = u.shape[0]
    h, p = cfg.ssm_heads, cfg.ssm_headdim
    z, x, bb, cc, dt = _project(params, cfg, u)
    x, ncx = _causal_conv(x, params["conv_x"], cache["conv_x"],
                          params.get("conv_x_bias", 0))
    bb, ncb = _causal_conv(bb, params["conv_b"], cache["conv_b"],
                           params.get("conv_b_bias", 0))
    cc, ncc = _causal_conv(cc, params["conv_c"], cache["conv_c"],
                           params.get("conv_c_bias", 0))

    a = -torch.exp(params["a_log"].float())
    da = torch.exp(dt[:, 0] * a)                               # [B,H]
    xh = x.reshape(b, h, p).float()
    binp = bb[:, 0].float()                                    # [B,N]
    state = cache["state"] * da[..., None, None] + torch.einsum(
        "bn,bh,bhp->bhnp", binp, dt[:, 0], xh)
    y = torch.einsum("bn,bhnp->bhp", cc[:, 0].float(), state)
    y = y + xh * params["d_skip"][:, None]
    y = y.reshape(b, 1, h * p).to(u.dtype)
    out = _gated_out(params, cfg, y, z)
    for name, new in (("state", state), ("conv_x", ncx), ("conv_b", ncb),
                      ("conv_c", ncc)):
        local_copy_(cache[name], new)
    return out, cache
