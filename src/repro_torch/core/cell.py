"""The 2x2 reconfigurable linear RF analog processor unit cell.

Implements the physics of the paper's unit cell (Fig. 2): two quadrature
(90 deg) hybrids and two phase shifters (theta between the hybrids on channel
1, phi at the output of channel 1).  The forward voltage transfer matrix is
paper Eq. (5):

    t(theta, phi) = j e^{-j theta/2} [ e^{-j phi} sin(th/2)  e^{-j phi} cos(th/2) ]
                                     [          cos(th/2)            -sin(th/2)  ]

with t t^H = I (Eq. 18), i.e. an element of U(2).

Everything here is plain PyTorch and differentiable w.r.t. (theta, phi);
the hardware-imperfect variant lives in :mod:`repro_torch.core.hardware`.
Results follow the device of the inputs.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Paper constants
# ---------------------------------------------------------------------------

#: Table I — discrete phase differences (degrees) of the six switched lines.
TABLE_I_PHASES_DEG: tuple[float, ...] = (29.0, 53.0, 75.0, 104.0, 135.0, 154.0)

#: Table I in radians, as a numpy array (used by the quantizer).
TABLE_I_PHASES_RAD: np.ndarray = np.deg2rad(np.asarray(TABLE_I_PHASES_DEG))

#: Design center frequency of the prototype (Hz).
F0_HZ: float = 2.0e9

#: Characteristic impedance of the transmission lines (ohm).
Z0_OHM: float = 50.0

#: Number of discrete states per phase shifter (SP6T switch pair).
N_DISCRETE_STATES: int = 6


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def as_complex(x) -> torch.Tensor:
    """Input -> complex64; real inputs (float32, bf16, ...) via float32."""
    x = torch.as_tensor(x)
    if x.is_complex():
        return x.to(torch.complex64)
    return x.to(torch.float32).to(torch.complex64)


def expj(phase: torch.Tensor) -> torch.Tensor:
    """e^{-j phase} as complex64 (the negative-delay convention)."""
    return torch.exp(-1j * phase.to(torch.complex64))


def cmatmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Product of broadcast stacks of small complex matrices, written out.

    Elementwise, so no BLAS call (and no TF32 setting) is involved.
    """
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


# ---------------------------------------------------------------------------
# Ideal quadrature hybrid and cell transfer
# ---------------------------------------------------------------------------

def quadrature_hybrid(device=None) -> torch.Tensor:
    """Forward 2x2 voltage block of an ideal 3-dB 90-degree hybrid.

    From the 4-port S-matrix (paper Eq. 3/4), keeping the forward path
    (P1, P4) -> (P2, P3):  (-1/sqrt(2)) [[j, 1], [1, j]].
    """
    m = torch.tensor([[1j, 1.0], [1.0, 1j]], dtype=torch.complex64,
                     device=device)
    return (-1.0 / math.sqrt(2.0)) * m


def phase_shifter(phase: torch.Tensor) -> torch.Tensor:
    """diag(e^{-j phase}, 1): a delay line on channel 1 (negative convention)."""
    e = expj(_f32(phase))
    z = torch.zeros_like(e)
    o = torch.ones_like(e)
    return torch.stack([torch.stack([e, z], -1), torch.stack([z, o], -1)], -2)


def cell_matrix(theta, phi) -> torch.Tensor:
    """t(theta, phi), paper Eq. (5).  Broadcasts over leading dims.

    Returns a complex64 tensor of shape ``theta.shape + (2, 2)``.
    """
    theta, phi = torch.broadcast_tensors(_f32(theta), _f32(phi))
    half = 0.5 * theta
    s = torch.sin(half).to(torch.complex64)
    c = torch.cos(half).to(torch.complex64)
    glob = 1j * torch.exp(-0.5j * theta.to(torch.complex64))
    ephi = expj(phi)
    row0 = torch.stack([ephi * s, ephi * c], -1)
    row1 = torch.stack([c, -s], -1)
    return glob[..., None, None] * torch.stack([row0, row1], -2)


def cell_matrix_structural(theta, phi) -> torch.Tensor:
    """t(theta, phi) built structurally: Phi . H . Theta . H."""
    theta, phi = _f32(theta), _f32(phi)
    h = quadrature_hybrid(theta.device)
    return cmatmul(cmatmul(cmatmul(phase_shifter(phi), h),
                           phase_shifter(theta)), h)


# ---------------------------------------------------------------------------
# S-parameters and power transfer (paper Eqs. 6-17)
# ---------------------------------------------------------------------------

def s_parameters(theta, phi) -> dict[str, torch.Tensor]:
    """The four forward S-parameters of the cell, Eqs. (6)-(9)."""
    t = cell_matrix(theta, phi)
    return {"s21": t[..., 0, 0], "s24": t[..., 0, 1],
            "s31": t[..., 1, 0], "s34": t[..., 1, 1]}


def output_voltages(theta, phi, p1_w, p4_w, z0: float = Z0_OHM):
    """Complex output voltage phasors at (P2, P3) for in-phase power feeds.

    Paper Eqs. (10)-(13): V_nm = sqrt(2 Z0 P_m) S_nm, summed per port.
    ``p1_w``/``p4_w`` are input powers in watts.
    """
    t = cell_matrix(theta, phi)
    v1 = torch.sqrt(2.0 * z0 * _f32(p1_w, t.device)).to(torch.complex64)
    v4 = torch.sqrt(2.0 * z0 * _f32(p4_w, t.device)).to(torch.complex64)
    v2 = t[..., 0, 0] * v1 + t[..., 0, 1] * v4
    v3 = t[..., 1, 0] * v1 + t[..., 1, 1] * v4
    return v2, v3


def output_powers(theta, phi, p1_w, p4_w, z0: float = Z0_OHM):
    """Measured powers at (P2, P3), Eqs. (14)-(15)."""
    v2, v3 = output_voltages(theta, phi, p1_w, p4_w, z0)
    p2 = v2.abs() ** 2 / (2.0 * z0)
    p3 = v3.abs() ** 2 / (2.0 * z0)
    return p2, p3


def output_powers_closed_form(theta, p1_w, p4_w):
    """Closed-form Eqs. (16)-(17): P2=(P1+P4) sin^2(th/2+D), P3=(P1+P4) cos^2."""
    p1, p4, theta = _f32(p1_w), _f32(p4_w), _f32(theta)
    tot = p1 + p4
    delta = torch.arccos(torch.sqrt(p1 / torch.clamp_min(tot, 1e-30)))
    p2 = tot * torch.sin(0.5 * theta + delta) ** 2
    p3 = tot * torch.cos(0.5 * theta + delta) ** 2
    return p2, p3


def is_unitary(t: torch.Tensor, atol: float = 1e-5) -> bool:
    """Check t t^H = I over the trailing (2, 2) axes."""
    eye = torch.eye(t.shape[-1], dtype=t.dtype, device=t.device)
    prod = cmatmul(t, t.conj().transpose(-1, -2))
    return bool(((prod - eye).abs() < atol).all())
