"""Plain-PyTorch twin of the mesh kernel.

Re-expresses the mesh semantics in the de-interleaved (even/odd channel)
layout the column sweep is written in, so the CUDA kernel can be held
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


def mesh_apply_planes(coef: torch.Tensor, parity, xer, xei, xor, xoi):
    """The kernel's column sweep on the de-interleaved planes.

    coef: [C, 8, P]; parity: [C] (0 or 1 per column); planes: [..., P].
    Parity 0 rotates (even_i, odd_i); parity 1 rotates (odd_i, even_{i+1})
    with the last slot passing through.
    """
    par = [int(v) for v in torch.as_tensor(parity).reshape(-1).tolist()]
    if len(par) != coef.shape[0]:
        raise ValueError(f"{len(par)} parities for {coef.shape[0]} columns")
    er, ei, orr, oi = xer, xei, xor, xoi
    for c, pc in enumerate(par):
        cc = coef[c]
        if pc == 0:
            er, ei, orr, oi = _rotate_pair(cc, er, ei, orr, oi)
        else:
            a2r, a2i, b2r, b2i = _rotate_pair(
                cc[:, :-1], orr[..., :-1], oi[..., :-1], er[..., 1:],
                ei[..., 1:])
            orr = torch.cat([a2r, orr[..., -1:]], -1)
            oi = torch.cat([a2i, oi[..., -1:]], -1)
            er = torch.cat([er[..., :1], b2r], -1)
            ei = torch.cat([ei[..., :1], b2i], -1)
    return er, ei, orr, oi


def mesh_apply_ref(coef: torch.Tensor, parity, x: torch.Tensor) -> torch.Tensor:
    """``y = T_{C-1} ... T_0 x`` for complex ``x[B, n]`` (complex64 out)."""
    planes = mesh_apply_planes(coef, parity, *split_channels(x))
    return merge_channels(*planes)
