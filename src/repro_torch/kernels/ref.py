"""Plain-PyTorch twin of the mesh kernels: the mesh sweep (forward B1,
backward B2), the fused analog linear layer (B3, B4 and backward B5) and
the deep tile grid (B6, B7 and backward B8); and the dense-softmax twin of
the flash attention kernel (B9), :func:`flash_attention_ref`.

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

import math

import torch


def split_channels(x: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Complex [B, N] -> (xer, xei, xor, xoi) real [B, N//2] planes, float32
    for complex64 and float64 for complex128 (the kernels take complex64;
    a complex128 grid is the float64 witness of their plain versions)."""
    xe, xo = x[..., 0::2], x[..., 1::2]
    return xe.real, xe.imag, xo.real, xo.imag


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
    (odd_i, even_{i+1}) with the last slot passing through.  ``cc`` is an
    ``[8, ..., P]`` coefficient slice broadcasting against the planes."""
    if pc == 0:
        return _rotate_pair(cc, er, ei, orr, oi)
    a2r, a2i, b2r, b2i = _rotate_pair(
        cc[..., :-1], orr[..., :-1], oi[..., :-1], er[..., 1:], ei[..., 1:])
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


def _sweep_bwd(col_inv, col_adj, par, s, g):
    """The reversed column walk shared by B2, B5 and B8's plain versions.

    ``col_inv(c)``/``col_adj(c)``: column ``c``'s inverse and adjoint
    ``[8, ..., P]`` slices; ``s``/``g``: the output state and cotangent
    planes ``[B, ..., P]``.  Returns the per-column gradient rows (a list
    of ``[8, ..., P]``, batch-summed) and the cotangent at the input.
    """
    rows = [None] * len(par)
    for c in reversed(range(len(par))):
        s = _column(col_inv(c), par[c], *s)
        er, ei, orr, oi = s
        ger, gei, gor, goi = g
        if par[c] == 0:
            rows[c] = _pair_grad_rows(er, ei, orr, oi, ger, gei, gor, goi)
        else:
            r = _pair_grad_rows(orr[..., :-1], oi[..., :-1], er[..., 1:],
                                ei[..., 1:], gor[..., :-1], goi[..., :-1],
                                ger[..., 1:], gei[..., 1:])
            rows[c] = torch.cat([r, r.new_zeros(r.shape[:-1] + (1,))], -1)
        g = _column(col_adj(c), par[c], *g)
    return rows, g


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
    rows, g = _sweep_bwd(inv.__getitem__, adj.__getitem__, par,
                         tuple(y_planes), tuple(g_planes))
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


def _detect(z):
    """|.| on complex planes: the real planes (|even|, 0, |odd|, 0)."""
    zer, zei, zor, zoi = z
    me = torch.sqrt(zer * zer + zei * zei)
    mo = torch.sqrt(zor * zor + zoi * zoi)
    return me, torch.zeros_like(me), mo, torch.zeros_like(mo)


def _detect_bwd(z, g_even, g_odd):
    """The |.| backward: ``g z / |z|`` from the magnitudes' real cotangent,
    exactly 0 where ``|z| = 0`` (a zero row, a parked tile: no NaN)."""
    zer, zei, zor, zoi = z
    me = torch.sqrt(zer * zer + zei * zei)
    mo = torch.sqrt(zor * zor + zoi * zoi)
    we = torch.where(me > 0, g_even / torch.where(me > 0, me, 1.0), 0.0)
    wo = torch.where(mo > 0, g_odd / torch.where(mo > 0, mo, 1.0), 0.0)
    return we * zer, we * zei, wo * zor, wo * zoi


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
    oe, _, oo, _ = _detect(_gain(u, _gain_planes(gains, 4)))
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
    gz_planes = _detect_bwd(_gain(u_planes, g2), g[..., 0::2].float(),
                            g[..., 1::2].float())
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


# ---------------------------------------------------------------------------
# the deep tile grid (the plain versions of kernels B6/B7 and B8)
# ---------------------------------------------------------------------------
#
# Per tile the semantics of the JAX package's deep kernels
# (repro/kernels/givens_mesh.py: deepgrid_kernel and deepgrid_bwd_kernel):
# g0 -> V -> g1 -> U -> g2, each row summing its Ti tile outputs, the
# rows re-detected (|.|, imaginary part 0) into the next layer's input
# tiles.  Tiles whose parity sequences agree sweep together, as one
# ``[B, G, P]`` stack through the single-mesh ``_column``.

def _tile_groups(parity_rows: list) -> list[tuple[list[int], list[int]]]:
    """Group tiles by their parity sequence: ``[(tiles, parities), ...]``
    from per-tile rows of ``C`` parities."""
    groups: dict[tuple, list[int]] = {}
    for t, row in enumerate(parity_rows):
        groups.setdefault(tuple(row), []).append(t)
    return [(tiles, list(par)) for par, tiles in groups.items()]


def _by_groups(groups, fn, *planes, tile_dim: int = 1):
    """Run ``fn(tile_index, *sub_planes) -> (sub_dcoef_or_None, out_planes)``
    per group of tiles and reassemble the tiles in order."""
    if len(groups) == 1:
        return fn(None, *planes)
    dev = planes[0].device
    outs, order = [], []
    for tiles, par in groups:
        idx = torch.tensor(tiles, device=dev)
        outs.append(fn((idx, par), *(q.index_select(tile_dim, idx)
                                     for q in planes)))
        order += tiles
    inv = torch.tensor(order, device=dev).argsort()
    first = (None if outs[0][0] is None else
             torch.cat([o[0] for o in outs]).index_select(0, inv))
    return first, tuple(torch.cat([o[1][k] for o in outs], tile_dim)
                        .index_select(tile_dim, inv) for k in range(4))


def _grid_sweep(coef: torch.Tensor, groups, planes):
    """The stacked forward sweep: ``coef [T, C, 8, P]``, planes
    ``[B, T, P]``."""
    def run(sel, *sub):
        cc, par = (coef, groups[0][1]) if sel is None else (
            coef.index_select(0, sel[0]), sel[1])
        cols = cc.movedim(-2, 0)                      # [8, G, C, P]
        for c, pc in enumerate(par):
            sub = _column(cols[:, :, c], pc, *sub)
        return None, sub

    return _by_groups(groups, run, *planes)[1]


def _grid_sweep_bwd(coef: torch.Tensor, groups, y_planes, g_planes):
    """The stacked reversed sweep: ``(dcoef [T, C, 8, P], dx planes)``."""
    def run(sel, *sub):
        cc, par = (coef, groups[0][1]) if sel is None else (
            coef.index_select(0, sel[0]), sel[1])
        inv = inverse_coefficients(cc).movedim(-2, 0)   # [8, G, C, P]
        adj = adjoint_coefficients(cc).movedim(-2, 0)
        rows, g = _sweep_bwd(lambda c: inv[:, :, c], lambda c: adj[:, :, c],
                             par, sub[:4], sub[4:])
        return torch.stack(rows, 2).movedim(0, -2), g   # [G, C, 8, P]

    return _by_groups(groups, run, *y_planes, *g_planes)


def _to_tiles(planes, to: int, ti: int, across: bool):
    """[B, Ti, P] input planes (``across=False``) or [B, To, P] row planes
    (``across=True``) -> the stacked [B, To * Ti, P] tile planes."""
    b, _, p = planes[0].shape
    if across:
        return tuple(q[:, :, None].expand(b, to, ti, p).reshape(b, to * ti, p)
                     for q in planes)
    return tuple(q[:, None].expand(b, to, ti, p).reshape(b, to * ti, p)
                 for q in planes)


def _row_sums(z, to: int, ti: int):
    """The matched-line combine: each row sums its Ti tile outputs."""
    b, _, p = z[0].shape
    return tuple(q.reshape(b, to, ti, p).sum(2) for q in z)


def _deep_setup(coef_v, par_v, par_u, gains):
    n_layers, to, ti, c, _, p = coef_v.shape
    t = to * ti
    pv = par_v.reshape(n_layers, t, c).tolist()
    pu = par_u.reshape(n_layers, t, c).tolist()
    return (n_layers, to, ti, c, p,
            [_tile_groups(r) for r in pv], [_tile_groups(r) for r in pu],
            [gains[l].reshape(t, 12, p).movedim(-2, 0)
             for l in range(n_layers)])


def deep_grid_planes(coef_v: torch.Tensor, par_v, coef_u: torch.Tensor,
                     par_u, gains: torch.Tensor, x: torch.Tensor, *,
                     detect_last: bool):
    """The deep grid as kernels B6/B7 compute it.

    coef_v, coef_u: [L, To, Ti, C, 8, P]; parities [L, To, Ti, C]; gains
    [L, To, Ti, 12, P] (rows 0-3 g0, 4-7 g1, 8-11 g2; each even re, even
    im, odd re, odd im); x: complex [B, Ti * n].  Returns ``(out, sv,
    su)``: the last layer's rows, float32 magnitudes (``detect_last``) or
    complex64, ``[B, To * n]`` in channel order; and every tile's post-V
    and post-U stage boundaries, complex64 [L, B, To, Ti, n], both taken
    before their gain.  A complex128 ``x`` with float64 coefficients and
    gains runs the same steps in float64.
    """
    n_layers, to, ti, c, p, gv, gu, gl = _deep_setup(coef_v, par_v, par_u,
                                                     gains)
    n, t, b = 2 * p, to * ti, x.shape[0]
    state = split_channels(x.reshape(b, ti, n))
    svs, sus = [], []
    for l in range(n_layers):
        s0 = _gain(_to_tiles(state, to, ti, False), _gain_planes(gl[l], 0))
        v = _grid_sweep(coef_v[l].reshape(t, c, 8, p), gv[l], s0)
        u = _grid_sweep(coef_u[l].reshape(t, c, 8, p), gu[l],
                        _gain(v, _gain_planes(gl[l], 4)))
        svs.append(merge_channels(*v))
        sus.append(merge_channels(*u))
        z_row = _row_sums(_gain(u, _gain_planes(gl[l], 8)), to, ti)
        state = _detect(z_row)
    if detect_last:
        out = torch.stack([state[0], state[2]], -1).reshape(b, to * n)
    else:
        out = merge_channels(*z_row).reshape(b, to * n)
    shape = (n_layers, b, to, ti, n)
    return out, torch.stack(svs).reshape(shape), torch.stack(sus).reshape(shape)


def deep_grid_planes_bwd(coef_v: torch.Tensor, par_v, coef_u: torch.Tensor,
                         par_u, gains: torch.Tensor, x: torch.Tensor,
                         sv: torch.Tensor, su: torch.Tensor, g: torch.Tensor,
                         *, detect_last: bool):
    """The VJP of :func:`deep_grid_planes`, as kernel B8 computes it.

    Layers in reverse, from the saved boundaries ``sv``, ``su`` and the
    input ``x``: the readout's |.| backward (``detect_last``; ``g`` float32
    [B, To * n]) or the complex cotangent ``g``; per layer every tile's g2
    gradient, U's reversed sweep, the g1 gradient, V's reversed sweep and
    the g0 gradient, then the combine's transpose (each input tile sums its
    cotangent over the To rows).  A layer boundary rebuilds its input rows
    from the previous layer's saved post-U and g2 (no sweep) and carries
    only the real cotangent back through their |.|.  Returns ``(dcv, dcu
    [L, To, Ti, C, 8, P], dg [L, To, Ti, 12, P], dx)`` with ``dx``
    complex64 [B, Ti * n] (dL/dRe + i dL/dIm).
    """
    n_layers, to, ti, c, p, gv, gu, gl = _deep_setup(coef_v, par_v, par_u,
                                                     gains)
    n, t, b = 2 * p, to * ti, x.shape[0]
    u_pl = [split_channels(su[l].reshape(b, t, n)) for l in range(n_layers)]
    z_rows = [_row_sums(_gain(u_pl[l], _gain_planes(gl[l], 8)), to, ti)
              for l in range(n_layers)]
    if detect_last:
        gr = g.reshape(b, to, n).float()
        gz = _detect_bwd(z_rows[-1], gr[..., 0::2], gr[..., 1::2])
    else:
        gz = split_channels(g.reshape(b, to, n))
    dcv, dcu, dg = [None] * n_layers, [None] * n_layers, [None] * n_layers
    for l in reversed(range(n_layers)):
        g0, g1, g2 = (_gain_planes(gl[l], k) for k in (0, 4, 8))
        gz_t = _to_tiles(gz, to, ti, True)
        v, u = split_channels(sv[l].reshape(b, t, n)), u_pl[l]
        dg2 = _gain_grad_rows(u, gz_t)
        dcu[l], gh = _grid_sweep_bwd(coef_u[l].reshape(t, c, 8, p), gu[l], u,
                                     _gain_adjoint(gz_t, g2))
        dg1 = _gain_grad_rows(v, gh)
        dcv[l], gs0 = _grid_sweep_bwd(coef_v[l].reshape(t, c, 8, p), gv[l],
                                      v, _gain_adjoint(gh, g1))
        x_in = (split_channels(x.reshape(b, ti, n)) if l == 0
                else _detect(z_rows[l - 1]))
        dg0 = _gain_grad_rows(_to_tiles(x_in, to, ti, False), gs0)
        dg[l] = torch.cat([dg0, dg1, dg2]).movedim(0, -2)   # [T, 12, P]
        gx = _gain_adjoint(gs0, g0)
        d_in = tuple(q.reshape(b, to, ti, p).sum(1) for q in gx)
        if l > 0:
            gz = _detect_bwd(z_rows[l - 1], d_in[0], d_in[2])
    shape = (n_layers, to, ti)
    return (torch.stack(dcv).reshape(shape + (c, 8, p)).to(coef_v.dtype),
            torch.stack(dcu).reshape(shape + (c, 8, p)).to(coef_u.dtype),
            torch.stack(dg).reshape(shape + (12, p)).to(gains.dtype),
            merge_channels(*d_in).reshape(b, ti * n))


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        scale: float = 0.0) -> torch.Tensor:
    """Dense-softmax twin of the flash attention kernel (B9).

    q: [B, H, Sq, hd], k, v: [B, H, Skv, hd] -> [B, H, Sq, hd] in q's dtype,
    float32 math, the scores times ``scale`` (0: divided by sqrt(hd));
    causal masks key > query with -1e30, as the kernel.
    """
    hd = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    s = s * scale if scale else s / math.sqrt(hd)
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        mask = (torch.arange(sk, device=s.device)[None, :]
                > torch.arange(sq, device=s.device)[:, None])
        s = s.masked_fill(mask, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)
