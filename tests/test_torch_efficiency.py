"""The port's Sec.-V efficiency model against the JAX package's.

``table2_rows`` and the four closed forms are float64 numpy in both
packages and must agree within 1e-12 relative.  ``monte_carlo_yield`` is
held per draw within 1e-5 of the JAX package's errors, given the JAX
package's mesh program, probe batch and hardware draws (its phase noise
carried across as the standard normals its keys stand for), on the port's
kernel path (B1, its plain version on the CPU) against the JAX package's
Pallas path in interpret mode and on both reference paths.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import mesh as j_mesh  # noqa: E402
from repro.paper import efficiency as je  # noqa: E402
from repro.paper.prototype import PROTOTYPE as J_PROTOTYPE  # noqa: E402
from repro_torch.core.hardware import HardwareModel, frozen_draws  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.paper import efficiency as te  # noqa: E402
from repro_torch.paper.prototype import PROTOTYPE  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

NS = [2, 8, 16, 20, 64]


def _rel(got, want):
    return abs(got - want) / max(abs(want), 1e-300)


@pytest.mark.parametrize("n", NS)
def test_closed_forms_match_jax(n):
    for name in ("rfnn_energy_per_flop_fj", "rfnn_reconfig_power_mw",
                 "rfnn_length_cm", "rfnn_delay_ns"):
        got, want = getattr(te, name)(n), getattr(je, name)(n)
        assert _rel(got, want) <= 1e-12, name
    slow = te.RFNNPlatform(f0_hz=2.4e9, eps_eff=4.4, detect_rate_hz=1e6)
    want = je.RFNNPlatform(f0_hz=2.4e9, eps_eff=4.4, detect_rate_hz=1e6)
    assert _rel(te.rfnn_energy_per_flop_fj(n, slow),
                je.rfnn_energy_per_flop_fj(n, want)) <= 1e-12
    assert _rel(te.rfnn_length_cm(n, slow), je.rfnn_length_cm(n, want)) \
        <= 1e-12
    assert _rel(slow.wavelength_m, want.wavelength_m) <= 1e-12


@pytest.mark.parametrize("n", [8, 20])
def test_table2_rows_match_jax(n):
    got, want = te.table2_rows(n), je.table2_rows(n)
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    for g, w in zip(got, want):
        for k, v in w.items():
            if isinstance(v, float):
                assert _rel(g[k], v) <= 1e-12, (w["platform"], k)
            else:
                assert g[k] == v, (w["platform"], k)
    # the paper's RFNN row: 1/(2N) fJ/FLOP at N = 20
    assert _rel(te.table2_rows()[-1]["fj_per_flop"], 1 / 40) <= 1e-12


def _jax_inputs(n, n_draws, seed, base, spread, batch=8):
    """What ``je.monte_carlo_yield`` draws inside, as numpy: the mesh
    program, the probe batch and the draws, each key's phase noise as the
    standard normals ``imperfect_cell_matrix`` makes from it."""
    plan = j_mesh.clements_plan(n)
    kp, kx, kd = jax.random.split(jax.random.PRNGKey(seed), 3)
    params = j_mesh.init_mesh_params(kp, plan, with_sigma=False)
    x = (jax.random.normal(kx, (batch, n))
         + 1j * jax.random.normal(jax.random.fold_in(kx, 1),
                                  (batch, n))).astype(jnp.complex64)
    d = je.sample_hardware_draws(kd, n_draws, base=base, spread=spread)
    zt, zp = [], []
    for key in d["noise_key"]:
        k1, k2 = jax.random.split(key)
        zt.append(np.asarray(jax.random.normal(k1, params["theta"].shape)))
        zp.append(np.asarray(jax.random.normal(k2, params["phi"].shape)))
    draws = {k: np.asarray(d[k]) for k in ("hybrid_imbalance",
                                           "hybrid_phase_err",
                                           "cell_loss_db")}
    draws["noise"] = {"theta": np.stack(zt), "phi": np.stack(zp)}
    return ({k: np.asarray(v) for k, v in params.items()}, np.asarray(x),
            draws)


SWEEPS = {"prototype": dict(n=8, n_draws=6, seed=3, spread=0.5,
                            error_threshold=0.2),
          "wide_spread": dict(n=4, n_draws=5, seed=8, spread=1.5,
                              error_threshold=0.05)}


@pytest.mark.parametrize("backend", ["kernel", "reference"])
@pytest.mark.parametrize("sweep", sorted(SWEEPS))
def test_monte_carlo_yield_matches_jax(sweep, backend):
    kw = SWEEPS[sweep]
    want = je.monte_carlo_yield(
        **kw, backend="pallas" if backend == "kernel" else "reference")
    params, x, draws = _jax_inputs(kw["n"], kw["n_draws"], kw["seed"],
                                   J_PROTOTYPE, kw["spread"])
    before = dict(ops.KERNEL_PATH_CALLS)
    got = te.monte_carlo_yield(**kw, backend=backend, device="cpu",
                               params=params, x=x, draws=draws)
    want_err = np.asarray(want["errors"])
    assert got["errors"].shape == (kw["n_draws"],)
    assert np.abs(got["errors"].numpy() - want_err).max() <= 1e-5
    assert got["yield"] == want["yield"]
    assert 0.0 < got["yield"] < 1.0 or sweep == "prototype"
    for k in ("mean_error", "worst_error"):
        assert abs(got[k] - want[k]) <= 1e-5
    for k in ("n", "n_draws", "spread", "error_threshold"):
        assert got[k] == want[k]
    calls = {k: ops.KERNEL_PATH_CALLS[k] - before[k] for k in before}
    if backend == "kernel":  # the baseline, then one B1 launch a draw
        assert calls["mesh_apply"] == 1
        assert calls["mesh_apply_cells"] == kw["n_draws"]
    else:
        assert not any(calls.values())


def test_draw_cells_match_the_hardware_model_per_draw():
    """``imperfect_cell_matrix`` over a leading draw axis (the yield sweep's
    one pass) equals its calls draw by draw with each draw's hardware and
    frozen noise, and the hybrid alone broadcasts the same way."""
    from repro_torch.core import mesh as mesh_lib
    from repro_torch.core.hardware import (imperfect_cell_matrix,
                                           imperfect_hybrid)

    plan = mesh_lib.clements_plan(8)
    params = mesh_lib.init_mesh_params(torch.Generator().manual_seed(1), plan,
                                       with_sigma=False)
    draws = te.sample_hardware_draws(torch.Generator().manual_seed(2), 5,
                                     mesh_params=params)
    fields = ("hybrid_imbalance", "hybrid_phase_err", "cell_loss_db")
    cells = imperfect_cell_matrix(
        params["theta"], params["phi"],
        dataclasses.replace(PROTOTYPE, **{k: draws[k] for k in fields}),
        draws=draws["noise"])
    assert cells.shape == (5,) + tuple(params["theta"].shape) + (2, 2)
    for d in range(5):
        hw = dataclasses.replace(PROTOTYPE, **{
            k: float(draws[k][d]) for k in fields})
        want = imperfect_cell_matrix(
            params["theta"], params["phi"], hw,
            draws={k: v[d] for k, v in draws["noise"].items()})
        assert (cells[d] - want).abs().max() <= 1e-6
        assert torch.equal(imperfect_hybrid(hw), imperfect_hybrid(
            dataclasses.replace(PROTOTYPE, **{k: draws[k] for k in fields}))[d])


def test_sample_hardware_draws_follow_the_variation_model():
    """|N| imbalance, signed phase error, loss clipped at 0 dB, float32 on
    the generator's device; the noise is ``frozen_draws`` per draw, so one
    seed gives the same draws every call."""
    params = {"theta": torch.zeros(8, 4), "phi": torch.zeros(8, 4)}
    base = HardwareModel(hybrid_imbalance=0.05, hybrid_phase_err=0.03,
                         cell_loss_db=0.2)
    a = te.sample_hardware_draws(torch.Generator().manual_seed(5), 400,
                                 base=base, spread=2.0, mesh_params=params)
    b = te.sample_hardware_draws(torch.Generator().manual_seed(5), 400,
                                 base=base, spread=2.0, mesh_params=params)
    for k in ("hybrid_imbalance", "hybrid_phase_err", "cell_loss_db"):
        assert a[k].shape == (400,) and a[k].dtype == torch.float32
        assert torch.equal(a[k], b[k])
    assert (a["hybrid_imbalance"] >= 0).all()
    assert (a["hybrid_phase_err"] < 0).any()   # sign-symmetric spread
    assert (a["cell_loss_db"] >= 0).all() and (a["cell_loss_db"] == 0).any()
    assert a["noise"]["theta"].shape == (400, 8, 4)
    assert torch.equal(a["noise"]["phi"], b["noise"]["phi"])
    assert not torch.equal(a["noise"]["theta"][0], a["noise"]["theta"][1])
    key_gen = torch.Generator().manual_seed(5)
    for _ in range(3):
        torch.randn((400,), generator=key_gen)
    key = int(torch.randint(0, 2**62, (1,), generator=key_gen))
    assert torch.equal(a["noise"]["theta"][7],
                       frozen_draws(key, (params,), layer=7)[0]["theta"])


def test_monte_carlo_yield_on_its_own_draws():
    """Without parameters carried in: the kernel path (B1's plain version)
    and the reference path agree, a seed repeats, an ideal base is in spec
    with error 0, and the default device is the card."""
    a = te.monte_carlo_yield(n=8, n_draws=8, device="cpu")
    b = te.monte_carlo_yield(n=8, n_draws=8, device="cpu",
                             backend="reference")
    assert torch.equal(a["errors"], te.monte_carlo_yield(
        n=8, n_draws=8, device="cpu")["errors"])
    assert (a["errors"] - b["errors"]).abs().max() <= 1e-6
    assert 0.0 <= a["yield"] <= 1.0 and a["worst_error"] > 0
    ideal = HardwareModel(hybrid_imbalance=0.0, hybrid_phase_err=0.0,
                          cell_loss_db=0.0, phase_sigma=0.0)
    clean = te.monte_carlo_yield(n=8, n_draws=4, base=ideal, device="cpu")
    assert clean["yield"] == 1.0 and clean["worst_error"] <= 1e-6
    with pytest.raises(ValueError, match="backend"):
        te.monte_carlo_yield(n_draws=2, backend="pallas", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            te.monte_carlo_yield(n_draws=2)
