"""Plain-PyTorch twin of the mesh kernels (forward B1 and backward B2).

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
