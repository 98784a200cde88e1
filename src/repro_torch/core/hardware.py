"""Hardware-imperfection model of the RF analog processor (paper Sec. III/V).

Models the measured non-idealities the paper reports:

* imperfect quadrature hybrids (amplitude imbalance + phase error) — Fig. 6
  shows measured |S| peaks below the theoretical 1/sqrt(2) level;
* insertion loss per cell — Sec. V quotes ~0.25 dB per wavelength of
  microstrip with a ~1-wavelength unit cell;
* phase-shifter deviation from the nominal Table I values;
* power detection at the outputs: the detector reads |V| (the paper's
  natural ``abs`` activation) with a sensitivity floor (~-60 dBm) and
  additive measurement noise.

The model composes structurally: Phi_err . H_err . Theta_err . H_err with a
scalar loss factor.  Random draws (phase noise, detector noise) come from a
CPU ``torch.Generator`` and are moved to the data's device, so one seed
gives the same draws on every device.  A calibrated device binds its phase
noise as *frozen* draws instead (:func:`frozen_draws`): standard normals
made once and passed as ``draws``, so every apply sees the same device.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core import mesh as mesh_lib
from repro_torch.core.cell import (Z0_OHM, _f32, as_complex, cmatmul,
                                   phase_shifter)


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    """Imperfection parameters of one 2x2 cell and its readout chain."""

    #: hybrid amplitude imbalance epsilon: through/coupled amplitude ratio
    #: (1+eps)/(1-eps); 0 = ideal 3-dB split.
    hybrid_imbalance: float = 0.03
    #: hybrid quadrature phase error (radians) added to the 90-deg arm.
    hybrid_phase_err: float = np.deg2rad(2.0)
    #: insertion loss per cell (dB); Sec. V: ~0.25 dB/lambda, cell ~ 1 lambda.
    cell_loss_db: float = 0.25
    #: rms random deviation of each phase shifter from nominal (radians).
    phase_sigma: float = np.deg2rad(1.5)
    #: detector sensitivity floor (dBm) — readings below this are noise.
    detector_floor_dbm: float = -60.0
    #: relative rms detector noise on measured voltage magnitude.
    detector_sigma: float = 0.01

    @property
    def cell_gain(self) -> float:
        return 10.0 ** (-self.cell_loss_db / 20.0)


IDEAL = HardwareModel(hybrid_imbalance=0.0, hybrid_phase_err=0.0,
                      cell_loss_db=0.0, phase_sigma=0.0,
                      detector_floor_dbm=-300.0, detector_sigma=0.0)


def normal_like(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Standard normal draws of ``x``'s shape, made on the CPU, on x's device."""
    z = torch.randn(x.shape, generator=generator, dtype=torch.float32)
    return z.to(x.device)


def imperfect_hybrid(hw: HardwareModel, device=None) -> torch.Tensor:
    """Forward block of a lossy, imbalanced quadrature hybrid.

    ``hw``'s hybrid fields may be tensors of one shape ``L`` (one device
    each); the result is then ``L + (2, 2)``.
    """
    e = _f32(hw.hybrid_imbalance, device)
    thru = (1.0 + e) * torch.exp(1j * _f32(hw.hybrid_phase_err, device)
                                 .to(torch.complex64)) * 1j
    coup = (1.0 - e).to(torch.complex64)
    m = torch.stack([torch.stack([thru, coup], -1),
                     torch.stack([coup, thru], -1)], -2).to(torch.complex64)
    # keep passive: renormalize worst-case row power to <= 1, then 3-dB split
    scale = torch.sqrt((m.abs() ** 2).sum(-1).amax(-1))
    return -m / scale[..., None, None]


def imperfect_cell_matrix(theta, phi, hw: HardwareModel,
                          generator: torch.Generator | None = None,
                          draws: dict | None = None) -> torch.Tensor:
    """t(theta, phi) under the hardware model; broadcasts like cell_matrix.

    With a ``generator``, theta then phi get rms ``hw.phase_sigma`` noise.
    With ``draws`` (``{"theta": z, "phi": z}``, standard normals of theta's
    and phi's shapes: a device's frozen draw) they get ``hw.phase_sigma *
    z`` instead.  Where ``hw``'s hybrid and loss fields are tensors of shape
    ``L`` (several devices), theta and phi lead with ``L`` once the noise
    is added (as draws of shape ``L + theta.shape`` give them) and the
    cells are ``L + theta.shape[len(L):] + (2, 2)``: every device in one
    pass.
    """
    if generator is not None and draws is not None:
        raise ValueError("pass a generator or frozen draws, not both")
    theta, phi = _f32(theta), _f32(phi)
    if generator is not None:
        theta = theta + hw.phase_sigma * normal_like(theta, generator)
        phi = phi + hw.phase_sigma * normal_like(phi, generator)
    elif draws is not None:
        theta = theta + hw.phase_sigma * draws["theta"].to(theta.device)
        phi = phi + hw.phase_sigma * draws["phi"].to(phi.device)
    h = imperfect_hybrid(hw, theta.device)
    gain = hw.cell_gain
    lead = h.shape[:-2]
    if lead:  # one device per leading index: align with theta's lead
        ones = (1,) * (theta.dim() - len(lead))
        h = h.reshape(*lead, *ones, 2, 2)
        gain = _f32(gain, theta.device).reshape(*lead, *ones, 1, 1)
    t = cmatmul(cmatmul(cmatmul(phase_shifter(phi), h),
                        phase_shifter(theta)), h)
    return gain * t


def frozen_draws(key: int, mesh_params, *, layer: int,
                 position: int | None = None) -> tuple[dict, ...]:
    """The frozen phase-noise draws of one device, deterministic in
    ``(key, position, layer)``.

    ``mesh_params``: the device's mesh param dicts in order (V then U).
    Returns one ``{"theta": z, "phi": z}`` per dict, standard normals of its
    theta's and phi's shapes on its device, all from one CPU generator
    seeded from ``key`` (an integer), the physical grid ``position`` (None
    for a layer outside a grid) and the ``layer`` index, so the same
    arguments give the same draws on every device and in every call.  The
    calibrate passes and the yield probes all derive their draws here.
    """
    spawn = (layer,) if position is None else (position, layer)
    seed = np.random.SeedSequence(int(key), spawn_key=spawn).generate_state(
        1, np.uint64)[0]
    gen = torch.Generator().manual_seed(int(seed))
    return tuple({k: normal_like(p[k], gen) for k in ("theta", "phi")}
                 for p in mesh_params)


def apply_mesh_hw(plan: mesh_lib.MeshPlan, params: dict, x: torch.Tensor,
                  hw: HardwareModel,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """Propagate through the mesh with per-cell hardware imperfections."""
    if x.shape[-1] != plan.n:
        raise ValueError(f"expected trailing dim {plan.n}, got {tuple(x.shape)}")
    x = mesh_lib.apply_screens(as_complex(x), params.get("alpha_in"))
    t_all = imperfect_cell_matrix(params["theta"], params["phi"], hw,
                                  generator)
    x = mesh_lib.scan_columns(plan, t_all, x)
    return mesh_lib.apply_screens(x, params.get("alpha"))


def detect_magnitude(v: torch.Tensor, hw: HardwareModel,
                     generator: torch.Generator | None = None,
                     z0: float = Z0_OHM) -> torch.Tensor:
    """Power-detector readout: measured |V| with floor and noise.

    This is the paper's ``abs`` activation as the hardware actually provides
    it (Sec. IV-A: "the absolute function is naturally applied").
    """
    mag = v.abs()
    if generator is not None and hw.detector_sigma > 0:
        mag = mag * (1.0 + hw.detector_sigma * normal_like(mag, generator))
    # sensitivity floor: power below floor reads as the floor's voltage.
    floor_w = 10.0 ** (hw.detector_floor_dbm / 10.0) * 1e-3
    return torch.clamp_min(mag, math.sqrt(2.0 * z0 * floor_w))
