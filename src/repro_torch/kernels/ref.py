"""Plain-PyTorch twin of the mesh kernels: the mesh sweep (forward B1,
backward B2) and the fused analog linear layer (B3, B4 and backward B5).

Re-expresses the mesh semantics in the de-interleaved (even/odd channel)
layout the column sweep is written in, so the CUDA kernels can be held
value-for-value against it.  It is itself validated against
:func:`repro_torch.core.mesh.apply_mesh` and against the JAX package in
the tests (independent implementations of the same physics).

Unlike the JAX package's oracle, which alternates parities by column
index (valid for the Clements rectangle only), this sweep reads each
column's pairing from the schedule's parity array, so mixed-parity
schedules from ``pack_cells_to_columns`` run through it unchanged.
"""

from __future__ import annotations

import torch


def split_channels(x: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Complex [B, N] -> (xer, xei, xor, xoi) float32 [B, N//2] planes."""
    xe, xo = x[..., 0::2], x[..., 1::2]
    return (xe.real.float(), xe.imag.float(), xo.real.float(),
            xo.imag.float())


def merge_channels(xer, xei, xor, xoi) -> torch.Tensor:
    """Inverse of :func:`split_channels`."""
    xe = torch.complex(xer, xei)
    xo = torch.complex(xor, xoi)
    return torch.stack([xe, xo], -1).reshape(xe.shape[:-1] + (2 * xe.shape[-1],))


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _rotate_pair(cc, ar, ai, br, bi):
    """(a', b') = t @ (a, b) with t given by an 8-row coefficient slice."""
    xr, xi = _cmul(cc[0], cc[1], ar, ai)
    yr, yi = _cmul(cc[2], cc[3], br, bi)
    a2r, a2i = xr + yr, xi + yi
    xr, xi = _cmul(cc[4], cc[5], ar, ai)
    yr, yi = _cmul(cc[6], cc[7], br, bi)
    return a2r, a2i, xr + yr, xi + yi


def _parities(parity, coef: torch.Tensor) -> list[int]:
    par = [int(v) for v in torch.as_tensor(parity).reshape(-1).tolist()]
    if len(par) != coef.shape[0]:
        raise ValueError(f"{len(par)} parities for {coef.shape[0]} columns")
    return par


def _column(cc, pc, er, ei, orr, oi):
    """One column: parity 0 rotates (even_i, odd_i); parity 1 rotates
    (odd_i, even_{i+1}) with the last slot passing through."""
    if pc == 0:
        return _rotate_pair(cc, er, ei, orr, oi)
    a2r, a2i, b2r, b2i = _rotate_pair(
        cc[:, :-1], orr[..., :-1], oi[..., :-1], er[..., 1:], ei[..., 1:])
    return (torch.cat([er[..., :1], b2r], -1), torch.cat([ei[..., :1], b2i], -1),
            torch.cat([a2r, orr[..., -1:]], -1), torch.cat([a2i, oi[..., -1:]], -1))


def mesh_apply_planes(coef: torch.Tensor, parity, xer, xei, xor, xoi):
    """The kernel's column sweep on the de-interleaved planes.

    coef: [C, 8, P]; parity: [C] (0 or 1 per column); planes: [..., P].
    """
    planes = (xer, xei, xor, xoi)
    for c, pc in enumerate(_parities(parity, coef)):
        planes = _column(coef[c], pc, *planes)
    return planes


def mesh_apply_ref(coef: torch.Tensor, parity, x: torch.Tensor) -> torch.Tensor:
    """``y = T_{C-1} ... T_0 x`` for complex ``x[B, n]`` (complex64 out)."""
    planes = mesh_apply_planes(coef, parity, *split_channels(x))
    return merge_channels(*planes)


# ---------------------------------------------------------------------------
# the reverse sweep (the plain version of kernel B2)
# ---------------------------------------------------------------------------

def adjoint_coefficients(coef: torch.Tensor) -> torch.Tensor:
    """Conjugate-transpose each packed 2x2 cell, layout kept.

    Rows (t00, t01, t10, t11) x (re, im) -> (t00*, t10*, t01*, t11*): the
    adjoint carries the cotangent backwards through ``y = T x`` for any
    complex ``T``.  Rows live on axis -2.
    """
    idx = torch.tensor([0, 1, 4, 5, 2, 3, 6, 7], device=coef.device)
    sign = torch.tensor([1.0, -1.0] * 4, dtype=coef.dtype, device=coef.device)
    return coef.index_select(-2, idx) * sign[:, None]


def inverse_coefficients(coef: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Analytic per-cell 2x2 inverse, ``adj(t) / det(t)``, layout kept.

    Rebuilds a column's input state from its output for lossy, imbalanced
    (non-unitary) cells with no per-column residual.  ``eps`` floors
    ``|det|^2`` against exact zeros.  Rows live on axis -2.
    """
    t00 = torch.complex(coef[..., 0, :], coef[..., 1, :])
    t01 = torch.complex(coef[..., 2, :], coef[..., 3, :])
    t10 = torch.complex(coef[..., 4, :], coef[..., 5, :])
    t11 = torch.complex(coef[..., 6, :], coef[..., 7, :])
    det = t00 * t11 - t01 * t10
    inv_det = det.conj() / torch.clamp_min(det.real ** 2 + det.imag ** 2, eps)
    cells = (t11 * inv_det, -t01 * inv_det, -t10 * inv_det, t00 * inv_det)
    return torch.stack([part for t in cells for part in (t.real, t.imag)],
                       -2).to(coef.dtype)


def _conj_dot(xr, xi, gr, gi):
    """Batch-summed conj(x) * g: one complex coefficient gradient entry."""
    return (xr * gr + xi * gi).sum(0), (xr * gi - xi * gr).sum(0)


def _pair_grad_rows(ar, ai, br, bi, gar, gai, gbr, gbi) -> torch.Tensor:
    """d loss / d t for (a2, b2) = t (a, b): rows (00, 01, 10, 11) x (re, im)."""
    return torch.stack([*_conj_dot(ar, ai, gar, gai), *_conj_dot(br, bi, gar, gai),
                        *_conj_dot(ar, ai, gbr, gbi), *_conj_dot(br, bi, gbr, gbi)])


def mesh_apply_planes_bwd(coef: torch.Tensor, parity, y_planes, g_planes):
    """The VJP of :func:`mesh_apply_planes` from its output, as kernel B2
    computes it.

    Walks the columns in reverse: rebuilds each column's input state with
    the per-cell inverse (``s_in = T_c^-1 s``), adds the batch-summed
    ``conj(s_in) * g`` rows to ``dcoef[c]`` (the wrap slot of an odd
    column holds no cell: its gradient is 0), then carries the cotangent
    back with the adjoint (``g_in = T_c^H g``).

    coef: [C, 8, P]; parity: [C]; planes: [B, P] (the output ``y`` and the
    cotangent at it).  Returns ``(dcoef [C, 8, P], dx planes)``.
    """
    par = _parities(parity, coef)
    inv, adj = inverse_coefficients(coef), adjoint_coefficients(coef)
    s, g = tuple(y_planes), tuple(g_planes)
    rows = [None] * len(par)
    for c in reversed(range(len(par))):
        s = _column(inv[c], par[c], *s)
        er, ei, orr, oi = s
        ger, gei, gor, goi = g
        if par[c] == 0:
            rows[c] = _pair_grad_rows(er, ei, orr, oi, ger, gei, gor, goi)
        else:
            r = _pair_grad_rows(orr[:, :-1], oi[:, :-1], er[:, 1:], ei[:, 1:],
                                gor[:, :-1], goi[:, :-1], ger[:, 1:], gei[:, 1:])
            rows[c] = torch.cat([r, r.new_zeros(8, 1)], 1)
        g = _column(adj[c], par[c], *g)
    return torch.stack(rows).to(coef.dtype), g


# ---------------------------------------------------------------------------
# the fused analog linear layer (the plain versions of kernels B3/B4 and B5)
# ---------------------------------------------------------------------------

def _gain_planes(gains: torch.Tensor, first: int):
    """The (even re, even im, odd re, odd im) rows ``first .. first + 3`` of
    the ``[8, P]`` gains: g1 at 0, g2 at 4."""
    return tuple(gains[first + k] for k in range(4))


def _gain(planes, g):
    er, ei = _cmul(planes[0], planes[1], g[0], g[1])
    orr, oi = _cmul(planes[2], planes[3], g[2], g[3])
    return er, ei, orr, oi


def _gain_adjoint(planes, g):
    """conj(g) * planes: the cotangent carried back through a gain."""
    er, ei = _cmul(g[0], -g[1], planes[0], planes[1])
    orr, oi = _cmul(g[2], -g[3], planes[2], planes[3])
    return er, ei, orr, oi


def _gain_grad_rows(planes, g_planes) -> torch.Tensor:
    """Batch-summed conj(state) * cotangent for a gain: rows (even re,
    even im, odd re, odd im) ``[4, P]``."""
    return torch.stack([*_conj_dot(*planes[:2], *g_planes[:2]),
                        *_conj_dot(*planes[2:], *g_planes[2:])])


def rfnn_linear_planes(coef_v: torch.Tensor, par_v, coef_u: torch.Tensor,
                       par_u, gains: torch.Tensor, x: torch.Tensor):
    """The fused layer ``|g2 * U (g1 * V x)|`` as kernels B3/B4 compute it.

    coef_v: [Cv, 8, P]; coef_u: [Cu, 8, P]; parities [Cv], [Cu]; gains:
    float32 [8, P] (rows 0-3 g1, 4-7 g2: even re, even im, odd re, odd im);
    x: complex [B, n].  Returns ``(out, v, u)``: the magnitudes float32
    [B, n] in channel order, and the post-V and post-U stage boundaries
    complex64 [B, n], both taken before their gain.
    """
    v = mesh_apply_planes(coef_v, par_v, *split_channels(x))
    u = mesh_apply_planes(coef_u, par_u, *_gain(v, _gain_planes(gains, 0)))
    zer, zei, zor, zoi = _gain(u, _gain_planes(gains, 4))
    oe = torch.sqrt(zer * zer + zei * zei)
    oo = torch.sqrt(zor * zor + zoi * zoi)
    out = torch.stack([oe, oo], -1).reshape(oe.shape[:-1] + (2 * oe.shape[-1],))
    return out, merge_channels(*v), merge_channels(*u)


def rfnn_linear_planes_bwd(coef_v: torch.Tensor, par_v, coef_u: torch.Tensor,
                           par_u, gains: torch.Tensor, v: torch.Tensor,
                           u: torch.Tensor, g: torch.Tensor):
    """The VJP of :func:`rfnn_linear_planes`, as kernel B5 computes it.

    From the saved boundaries ``v``, ``u`` (complex [B, n]) and the
    cotangent ``g`` of the magnitudes (float32 [B, n]): the |.| backward
    (``g z / |z|``, exactly 0 where ``|z| = 0``), the g2 gradient, U's
    reversed sweep from ``u``, the g1 gradient and V's reversed sweep from
    ``v``.  Returns ``(dcv [Cv, 8, P], dcu [Cu, 8, P], dg [8, P], dx)``
    with ``dx`` complex64 [B, n] (dL/dRe + i dL/dIm).
    """
    g1, g2 = _gain_planes(gains, 0), _gain_planes(gains, 4)
    v_planes, u_planes = split_channels(v), split_channels(u)
    zer, zei, zor, zoi = _gain(u_planes, g2)
    g_even, g_odd = g[..., 0::2].float(), g[..., 1::2].float()
    me = torch.sqrt(zer * zer + zei * zei)
    mo = torch.sqrt(zor * zor + zoi * zoi)
    we = torch.where(me > 0, g_even / torch.where(me > 0, me, 1.0), 0.0)
    wo = torch.where(mo > 0, g_odd / torch.where(mo > 0, mo, 1.0), 0.0)
    gz_planes = (we * zer, we * zei, wo * zor, wo * zoi)
    dg2 = _gain_grad_rows(u_planes, gz_planes)
    dcu, gh = mesh_apply_planes_bwd(coef_u, par_u, u_planes,
                                    _gain_adjoint(gz_planes, g2))
    dg1 = _gain_grad_rows(v_planes, gh)
    dcv, gx = mesh_apply_planes_bwd(coef_v, par_v, v_planes,
                                    _gain_adjoint(gh, g1))
    return dcv, dcu, torch.cat([dg1, dg2]).to(gains.dtype), merge_channels(*gx)


def rfnn_linear_ref(v_params: dict, atten: torch.Tensor, u_params: dict,
                    x: torch.Tensor, n: int, scale=1.0) -> torch.Tensor:
    """The composition oracle ``|scale * U (atten * V x)|`` on the Clements
    rectangle: two :func:`mesh_apply_ref` sweeps (each reading its parity
    array) with each mesh's output screen ``alpha``, independent of the
    fused kernel and its gains layout."""
    # imported here: repro_torch.core imports the kernels, which import this
    # module
    from repro_torch.core.cell import cell_matrix, expj
    from repro_torch.kernels.schedule import (clements_schedule, pack_cells,
                                              parity_array)

    sched = clements_schedule(n)
    par = parity_array(sched, x.device)

    def mesh(params, h):
        coef = pack_cells(sched, cell_matrix(params["theta"], params["phi"]))
        y = mesh_apply_ref(coef, par, h)
        alpha = params.get("alpha")
        return y if alpha is None else y * expj(alpha)

    h = mesh(v_params, x.to(torch.complex64)) * atten.to(torch.complex64)
    return (scale * mesh(u_params, h)).abs()
