"""The analytic efficiency model of paper Sec. V / Table II, plus a
Monte-Carlo manufacturing-yield sweep over sampled hardware draws.

The JAX package's ``paper/efficiency.py`` on torch.  The closed forms are
float64 numpy, copied as they are:

  * reconfigurable power: 0.12 mW per RF switch, N(N+1) switches for an
    N x N unitary -> P = 0.12 * N * (N+1) mW;
  * passive energy/FLOP: detection rate f_d = 10 MHz performs 1e7
    N-dim MVMs/s = 2 N^2 * 1e7 FLOP/s; required output power ~ 1e-5 * N mW
    (-60 dBm detector sensitivity + 10 dB insertion loss) ->
    E/FLOP = P / (2 N^2 f_d) = 1/(2N) fJ/FLOP;
  * unit-cell length ~1 wavelength (12 mm at 10 GHz on eps_r=10 PCB),
    processor depth 2N+1 columns of cells + routing -> delay at light speed
    in the substrate (ns scale), vs us-scale digital dispatch.

The yield sweep draws its devices from a ``torch.Generator`` and binds each
device's phase noise as frozen draws (``core/hardware.frozen_draws``) in
place of the JAX package's per-draw PRNG keys; it builds every draw's cells
in one ``imperfect_cell_matrix`` pass over a leading draw axis and runs them through the mesh
kernel B1 (``ops.mesh_apply_cells``), one launch a draw.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

C0 = 299_792_458.0


@dataclasses.dataclass(frozen=True)
class RFNNPlatform:
    f0_hz: float = 10e9
    eps_eff: float = 6.7          # microstrip on eps_r=10
    detector_dbm: float = -60.0
    insertion_loss_db: float = 10.0
    detect_rate_hz: float = 10e6
    switch_power_mw: float = 0.12

    @property
    def wavelength_m(self) -> float:
        return C0 / np.sqrt(self.eps_eff) / self.f0_hz


def rfnn_energy_per_flop_fj(n: int, p: RFNNPlatform = RFNNPlatform()) -> float:
    """Passive design: minimum output power / computation rate."""
    out_power_w = n * 10 ** ((p.detector_dbm + p.insertion_loss_db) / 10) * 1e-3
    flops_per_s = 2 * n * n * p.detect_rate_hz
    return out_power_w / flops_per_s * 1e15


def rfnn_reconfig_power_mw(n: int, p: RFNNPlatform = RFNNPlatform()) -> float:
    return p.switch_power_mw * n * (n + 1)


def rfnn_length_cm(n: int, p: RFNNPlatform = RFNNPlatform()) -> float:
    # triangular mesh depth 2N-3 columns + Sigma column + feed lines
    cells = 2 * n - 1
    return cells * p.wavelength_m * 100


def rfnn_delay_ns(n: int, p: RFNNPlatform = RFNNPlatform()) -> float:
    return rfnn_length_cm(n) / 100 / (C0 / np.sqrt(p.eps_eff)) * 1e9


# ---------------------------------------------------------------------------
# Monte-Carlo yield over sampled hardware draws (Sec. III/V robustness)
# ---------------------------------------------------------------------------

def sample_hardware_draws(generator: torch.Generator, n_draws: int,
                          base=None, spread: float = 0.5, *,
                          mesh_params: dict) -> dict:
    """Sample per-device imperfection parameters around a base model.

    Fabrication variation model: hybrid imbalance is |N(base, spread*base)|
    (a magnitude), quadrature phase error is N(base, spread*base)
    (sign-symmetric), per-cell insertion loss is N(base, spread*base)
    clipped at 0 dB.  Returns a dict of [n_draws] float32 tensors on the
    generator's device, plus ``"noise"``: each device's frozen phase-noise
    draws ``{"theta": z, "phi": z}``, standard normals ``[n_draws, C, P]``
    of ``mesh_params``' theta and phi shapes on their device
    (``frozen_draws`` of an integer drawn from ``generator``, layer d for
    draw d).
    """
    from repro_torch.core.hardware import frozen_draws

    if base is None:
        from repro_torch.paper.prototype import PROTOTYPE
        base = PROTOTYPE
    dev = generator.device

    def around(mean):
        z = torch.randn((n_draws,), generator=generator, device=dev)
        return mean * (1.0 + spread * z)

    out = {"hybrid_imbalance": around(base.hybrid_imbalance).abs(),
           "hybrid_phase_err": around(base.hybrid_phase_err),
           "cell_loss_db": torch.clamp(around(base.cell_loss_db), min=0.0)}
    key = int(torch.randint(0, 2**62, (1,), generator=generator, device=dev))
    per = [frozen_draws(key, (mesh_params,), layer=d)[0]
           for d in range(n_draws)]
    out["noise"] = {k: torch.stack([p[k] for p in per]) for k in ("theta",
                                                                  "phi")}
    return out


def monte_carlo_yield(n: int = 8, n_draws: int = 32, *, base=None,
                      spread: float = 0.5, error_threshold: float = 0.25,
                      seed: int = 0, backend: str = "kernel",
                      batch: int = 8, device=None, params: dict | None = None,
                      x=None, draws: dict | None = None) -> dict:
    """Manufacturing-yield estimate: fraction of sampled devices in spec.

    A fixed seeded mesh program (Clements, no output screen) and probe
    batch are propagated through ``n_draws`` sampled hardware realizations.
    A device is *in spec* when the relative L2 error of its detected output
    against the ideal device stays below ``error_threshold``.  The program,
    the probe batch and the draws come from one CPU generator seeded
    ``seed`` (the same on every device) and run on ``device`` (CUDA when
    None).  With ``backend="kernel"`` the ideal baseline and every draw go
    through kernel B1 (``ops.mesh_apply``, ``ops.mesh_apply_cells``), one
    launch each; ``"reference"`` takes the plain column scan.  ``params``
    (theta, phi [C, P]), ``x`` (complex [batch, n]) and ``draws`` (as
    :func:`sample_hardware_draws` returns them) replace the drawn ones, so
    another package's can be carried in.
    """
    from repro_torch.core import mesh as mesh_lib
    from repro_torch.core.cell import as_complex
    from repro_torch.core.hardware import imperfect_cell_matrix
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops

    if backend not in ("kernel", "reference"):
        raise ValueError(f"backend must be 'kernel' or 'reference', got "
                         f"{backend!r}")
    if base is None:
        from repro_torch.paper.prototype import PROTOTYPE
        base = PROTOTYPE
    dev = resolve_device(device)
    plan = mesh_lib.clements_plan(n)
    gen = torch.Generator().manual_seed(seed)
    if params is None:
        params = mesh_lib.init_mesh_params(gen, plan, with_sigma=False)
    def to_dev(t):
        if isinstance(t, dict):
            return {k: to_dev(v) for k, v in t.items()}
        if not isinstance(t, torch.Tensor):
            t = torch.from_numpy(np.array(t))
        return t.to(dev)

    params = to_dev(params)
    if x is None:
        x = torch.complex(torch.randn((batch, n), generator=gen),
                          torch.randn((batch, n), generator=gen))
    x = as_complex(to_dev(x))
    if draws is None:
        draws = sample_hardware_draws(gen, n_draws, base=base, spread=spread,
                                      mesh_params=params)
    draws = to_dev(draws)
    n_draws = int(draws["hybrid_imbalance"].shape[0])
    with torch.no_grad():
        if backend == "kernel":
            y_ideal = ops.mesh_apply(params, x, n=n).abs()
        else:
            y_ideal = mesh_lib.apply_mesh(plan, params, x).abs()
        hw = dataclasses.replace(base, **{
            k: draws[k].float() for k in ("hybrid_imbalance",
                                          "hybrid_phase_err",
                                          "cell_loss_db")})
        t_all = imperfect_cell_matrix(params["theta"], params["phi"], hw,
                                      draws=draws["noise"])   # [D,C,P,2,2]
        if backend == "kernel":
            ys = [ops.mesh_apply_cells(t_all[d], x, plan=plan)
                  for d in range(n_draws)]
        else:
            ys = [mesh_lib.scan_columns(plan, t_all[d], x)
                  for d in range(n_draws)]
        mag = torch.stack(ys).abs()                            # [D,batch,n]
        # digital post-scaling (the paper's gamma, Fig. 11) recovers any
        # overall insertion loss; yield therefore measures the residual
        # *distortion* after the optimal scalar compensation
        gamma = ((mag * y_ideal).sum((1, 2))
                 / torch.clamp((mag * mag).sum((1, 2)), min=1e-12))
        errors = (torch.linalg.vector_norm(
            gamma[:, None, None] * mag - y_ideal, dim=(1, 2))
            / torch.clamp(torch.linalg.vector_norm(y_ideal), min=1e-12))
    in_spec = errors <= error_threshold
    return {
        "n": n, "n_draws": n_draws, "spread": spread,
        "error_threshold": error_threshold,
        "errors": errors,
        "yield": float(in_spec.float().mean()),
        "mean_error": float(errors.mean()),
        "worst_error": float(errors.max()),
    }


def table2_rows(n: int = 20) -> list[dict]:
    """Reproduce Table II (N=20): platform comparison."""
    p = RFNNPlatform()
    return [
        {"platform": "GPU (V100)", "length_cm": 30.0, "cell_len_lambda": None,
         "complexity": "O(N^2)", "fj_per_flop": 3.1e4, "cost": "medium",
         "delay": "us"},
        {"platform": "FPGA (Arria 10)", "length_cm": 24.0,
         "cell_len_lambda": None, "complexity": "O(N^2)",
         "fj_per_flop": 6.2e4, "cost": "medium", "delay": "us"},
        {"platform": "ONN", "length_cm": 0.76, "cell_len_lambda": 64,
         "complexity": "O(N)", "fj_per_flop": 0.25, "cost": "high",
         "delay": "ps"},
        {"platform": "RFNN (this work)", "length_cm": rfnn_length_cm(n, p),
         "cell_len_lambda": 1, "complexity": "O(N)",
         "fj_per_flop": rfnn_energy_per_flop_fj(n, p), "cost": "low",
         "delay": "ns"},
    ]
