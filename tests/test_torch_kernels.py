"""The port's kernel path against the JAX package's.

Inputs are made with numpy from a seed and fed to both packages.  JAX runs
``ops.mesh_apply`` in Pallas interpret mode on the CPU; the port runs the
plain version of its CUDA kernel (a CPU tensor never reaches the kernel).
Noisy paths are held through ``mesh_apply_cells`` with cells drawn by JAX,
since the two packages' generators give different numbers.  Tolerance:
atol 1e-5 * n, the bound of ``tests/test_kernels.py`` (float32 sums in
another order).  Gradients (the plain version of kernel B2 and the
autograd path through it) are held to ``jax.vjp``/``jax.grad`` of the JAX
kernel path and of its plain oracle at atol 1e-4, the bound of
``tests/test_kernel_grads.py``.  The ``gpu`` tests hold the CUDA kernels
to their plain versions on the card and skip without one; they need no JAX
(where it is absent, run them with ``pytest --noconftest -m gpu``).
"""

import importlib.util

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import hardware as t_hw  # noqa: E402
from repro_torch.core import mesh as t_mesh  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    cuda_build,
    givens_mesh,
    ops,
    ref,
    schedule,
)
from repro_torch.paper.prototype import PROTOTYPE  # noqa: E402

if importlib.util.find_spec("jax") is None:
    jax = None  # the card's machine runs the gpu tests without JAX
else:  # with JAX present, a broken reference package fails the run
    import jax
    import jax.numpy as jnp

    from repro.core import hardware as j_hw
    from repro.core import mesh as j_mesh
    from repro.kernels import givens_mesh as j_givens
    from repro.kernels import ops as j_ops
    from repro.kernels import ref as j_ref
    from repro.kernels import schedule as j_sched
    from repro.core.hardware import IDEAL as J_IDEAL
    from repro.paper.prototype import PROTOTYPE as J_PROTOTYPE

    jax.config.update("jax_platform_name", "cpu")

needs_jax = pytest.mark.skipif(jax is None,
                               reason="needs the JAX reference package")


def _params(rng, plan, alpha=True, alpha_in=False):
    shape = plan.param_shape()
    p = {"theta": rng.uniform(0, np.pi, shape).astype(np.float32),
         "phi": rng.uniform(0, 2 * np.pi, shape).astype(np.float32)}
    if alpha:
        p["alpha"] = rng.uniform(0, 2 * np.pi, plan.n).astype(np.float32)
    if alpha_in:
        p["alpha_in"] = rng.uniform(0, 2 * np.pi, plan.n).astype(np.float32)
    return p


def _x(rng, b, n):
    return (rng.normal(size=(b, n))
            + 1j * rng.normal(size=(b, n))).astype(np.complex64)


def _jax(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _torch(p):
    return {k: torch.from_numpy(v.copy()) for k, v in p.items()}


def _mixed_cells(rng, n, k=None):
    """An ordered cell list whose greedy packing mixes parities."""
    k = k or 3 * n
    return [(int(rng.integers(0, n - 1)), float(rng.uniform(0, np.pi)),
             float(rng.uniform(0, 2 * np.pi))) for _ in range(k)]


# ---------------------------------------------------------------------------
# schedules and packing: exact
# ---------------------------------------------------------------------------

@needs_jax
@pytest.mark.parametrize("n", [2, 8, 16])
def test_schedule_from_plan_matches_jax_clements(n):
    js = j_sched.clements_schedule(n)
    ts = schedule.clements_schedule(n)
    assert (ts.n, ts.parity, ts.source) == (js.n, js.parity, js.source)
    np.testing.assert_array_equal(
        schedule.parity_array(ts).numpy(),
        np.asarray(j_sched.parity_array(js)).reshape(-1))


@needs_jax
def test_schedule_from_plan_matches_jax_mixed_parity():
    rng = np.random.default_rng(3)
    cells = _mixed_cells(rng, 8)
    jplan, _, _ = j_mesh.pack_cells_to_columns(8, cells)
    tplan, _, _ = t_mesh.pack_cells_to_columns(8, cells)
    assert tplan == t_mesh.MeshPlan(8, jplan.top, jplan.active, jplan.slot,
                                    jplan.role)
    js, ts = j_sched.schedule_from_plan(jplan), schedule.schedule_from_plan(tplan)
    assert (ts.parity, ts.source) == (js.parity, js.source)
    assert 0 in ts.parity and 1 in ts.parity
    # the plan mixes parities within a column, so the schedule is longer
    assert ts.n_columns > tplan.n_columns


@needs_jax
@pytest.mark.parametrize("mixed", [False, True])
def test_pack_cells_exact(mixed):
    rng = np.random.default_rng(4)
    if mixed:
        plan, _, _ = j_mesh.pack_cells_to_columns(8, _mixed_cells(rng, 8))
    else:
        plan = j_mesh.clements_plan(8)
    c, p = plan.param_shape()
    t_all = (rng.normal(size=(c, p, 2, 2))
             + 1j * rng.normal(size=(c, p, 2, 2))).astype(np.complex64)
    js = j_sched.schedule_from_plan(plan)
    tplan = t_mesh.MeshPlan(8, plan.top, plan.active, plan.slot, plan.role)
    ts = schedule.schedule_from_plan(tplan)
    cj = np.asarray(j_sched.pack_cells(js, jnp.asarray(t_all)))
    ct = schedule.pack_cells(ts, torch.from_numpy(t_all)).numpy()
    assert ct.shape == (ts.n_columns, 8, 4) and ct.dtype == np.float32
    np.testing.assert_array_equal(ct, cj)


def test_pack_cells_rejects_foreign_cells():
    sched = schedule.clements_schedule(8)
    with pytest.raises(ValueError):
        schedule.pack_cells(sched, torch.zeros(8, 3, 2, 2, dtype=torch.complex64))


# ---------------------------------------------------------------------------
# the plain twin
# ---------------------------------------------------------------------------

def test_split_merge_roundtrip():
    x = torch.from_numpy(_x(np.random.default_rng(0), 5, 8))
    torch.testing.assert_close(ref.merge_channels(*ref.split_channels(x)), x,
                               rtol=0, atol=0)


def test_plain_sweep_follows_parity_array_on_mixed_plan():
    """The twin reads parities from the schedule (not from c % 2), so a
    mixed-parity plan matches the reference column scan."""
    rng = np.random.default_rng(5)
    tplan, theta, phi = t_mesh.pack_cells_to_columns(8, _mixed_cells(rng, 8))
    sched = schedule.schedule_from_plan(tplan)
    assert list(sched.parity) != [c % 2 for c in range(sched.n_columns)]
    x = torch.from_numpy(_x(rng, 6, 8))
    params = {"theta": theta, "phi": phi}
    y_ref = t_mesh.apply_mesh(tplan, params, x)
    y = ops.mesh_apply(params, x, n=8, plan=tplan)
    torch.testing.assert_close(y, y_ref, rtol=0, atol=8e-5)


# ---------------------------------------------------------------------------
# mesh_apply / mesh_apply_cells against JAX
# ---------------------------------------------------------------------------

_SHAPES = [(n, b) for n in (2, 8, 16, 64) for b in (1, 7)] + [(8, 130)]


@needs_jax
@pytest.mark.parametrize("n,b", _SHAPES)
def test_mesh_apply_matches_jax(n, b):
    rng = np.random.default_rng(100 * n + b)
    plan = j_mesh.clements_plan(n)
    p = _params(rng, plan, alpha_in=(n == 8))
    x = _x(rng, b, n)
    calls = ops.KERNEL_PATH_CALLS["mesh_apply"]
    for jhw, thw in ((None, None), (J_PROTOTYPE, PROTOTYPE)):
        yj = np.asarray(j_ops.mesh_apply(_jax(p), jnp.asarray(x), n=n,
                                         hardware=jhw))
        yt = ops.mesh_apply(_torch(p), torch.from_numpy(x), n=n,
                            hardware=thw).numpy()
        np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-5 * n)
    assert ops.KERNEL_PATH_CALLS["mesh_apply"] == calls + 2


@needs_jax
@pytest.mark.parametrize("n,b", [(2, 7), (8, 7), (8, 130), (16, 1)])
def test_mesh_apply_cells_noisy_matches_jax(n, b):
    """Noisy cells drawn by JAX, handed to both packages."""
    rng = np.random.default_rng(7 * n + b)
    plan = j_mesh.clements_plan(n)
    p = _params(rng, plan, alpha_in=True)
    t_all = np.array(j_hw.imperfect_cell_matrix(
        jnp.asarray(p["theta"]), jnp.asarray(p["phi"]), J_PROTOTYPE,
        jax.random.PRNGKey(n)))
    x = _x(rng, b, n)
    yj = np.asarray(j_ops.mesh_apply_cells(
        jnp.asarray(t_all), jnp.asarray(x), plan=plan,
        alpha_in=jnp.asarray(p["alpha_in"]), alpha=jnp.asarray(p["alpha"])))
    yt = ops.mesh_apply_cells(
        torch.from_numpy(t_all), torch.from_numpy(x),
        plan=t_mesh.clements_plan(n),
        alpha_in=torch.from_numpy(p["alpha_in"]),
        alpha=torch.from_numpy(p["alpha"])).numpy()
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-5 * n)


@needs_jax
def test_mesh_apply_cells_mixed_parity_matches_jax():
    rng = np.random.default_rng(11)
    cells = _mixed_cells(rng, 16)
    jplan, theta, phi = j_mesh.pack_cells_to_columns(16, cells)
    tplan, _, _ = t_mesh.pack_cells_to_columns(16, cells)
    t_all = np.array(j_hw.imperfect_cell_matrix(theta, phi, J_PROTOTYPE,
                                                  jax.random.PRNGKey(1)))
    x = _x(rng, 7, 16)
    yj = np.asarray(j_ops.mesh_apply_cells(jnp.asarray(t_all), jnp.asarray(x),
                                           plan=jplan))
    yt = ops.mesh_apply_cells(torch.from_numpy(t_all), torch.from_numpy(x),
                              plan=tplan).numpy()
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-5 * 16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mesh_apply_casts_real_inputs(dtype):
    """float32/bf16 inputs are cast to complex64 first, as in the JAX ops."""
    rng = np.random.default_rng(2)
    plan = t_mesh.clements_plan(16)
    p = _torch(_params(rng, plan))
    x = torch.from_numpy(rng.normal(size=(5, 16)).astype(np.float32)).to(dtype)
    y = ops.mesh_apply(p, x, n=16)
    assert y.dtype == torch.complex64
    y_ref = t_mesh.apply_mesh(plan, p, x.float().to(torch.complex64))
    torch.testing.assert_close(y, y_ref, rtol=0, atol=1e-5 * 16)


def test_mesh_apply_batch_shapes_and_empty_batch():
    rng = np.random.default_rng(9)
    p = _torch(_params(rng, t_mesh.clements_plan(8)))
    x = torch.from_numpy(_x(rng, 6, 8)).reshape(2, 3, 8)
    y = ops.mesh_apply(p, x, n=8)
    assert y.shape == (2, 3, 8)
    torch.testing.assert_close(y.reshape(6, 8),
                               ops.mesh_apply(p, x.reshape(6, 8), n=8))
    empty = ops.mesh_apply(p, torch.zeros(0, 8, dtype=torch.complex64), n=8)
    assert empty.shape == (0, 8)


def test_mesh_apply_kernel_matches_reference_column_scan():
    """Kernel backend (plain version here) == core/mesh reference scan."""
    rng = np.random.default_rng(12)
    plan = t_mesh.clements_plan(8)
    p = _torch(_params(rng, plan, alpha_in=True))
    x = torch.from_numpy(_x(rng, 9, 8))
    torch.testing.assert_close(ops.mesh_apply(p, x, n=8),
                               t_mesh.apply_mesh(plan, p, x),
                               rtol=0, atol=8e-5)
    torch.testing.assert_close(
        ops.mesh_apply(p, x, n=8, hardware=PROTOTYPE),
        t_hw.apply_mesh_hw(plan, p, x, PROTOTYPE), rtol=0, atol=8e-5)


def test_mesh_forward_validates_inputs_and_devices():
    sched = schedule.clements_schedule(8)
    coef = torch.zeros(8, 8, 4)
    par = schedule.parity_array(sched)
    x = torch.zeros(3, 8, dtype=torch.complex64)
    with pytest.raises(ValueError):
        givens_mesh.mesh_forward(coef, par, x.real.contiguous())
    with pytest.raises(ValueError):
        givens_mesh.mesh_forward(coef[:, :, :3], par, x)
    with pytest.raises(ValueError):
        givens_mesh.mesh_forward(coef, par.long(), x)
    with pytest.raises(ValueError):  # neither cuda nor cpu: never the plain path
        givens_mesh.mesh_forward(coef.to("meta"), par.to("meta"), x.to("meta"))
    with pytest.raises(ValueError):  # the launcher refuses CPU tensors
        givens_mesh.launch(coef, par, x)


def test_cpu_tensor_never_launches_the_kernel():
    before = givens_mesh.LAUNCHES["mesh_fwd"]
    p = _torch(_params(np.random.default_rng(1), t_mesh.clements_plan(8)))
    ops.mesh_apply(p, torch.zeros(4, 8, dtype=torch.complex64), n=8)
    assert givens_mesh.LAUNCHES["mesh_fwd"] == before


# ---------------------------------------------------------------------------
# gradients: the plain version of kernel B2 and the autograd path
# ---------------------------------------------------------------------------

def _coef_case(rng, n, hw):
    """Packed coefficients of a random Clements mesh under ``hw``."""
    p = _params(rng, j_mesh.clements_plan(n), alpha=False)
    t_all = j_hw.imperfect_cell_matrix(jnp.asarray(p["theta"]),
                                       jnp.asarray(p["phi"]), hw)
    return np.array(j_sched.pack_cells(j_sched.clements_schedule(n), t_all))


@needs_jax
@pytest.mark.parametrize("n,b", [(n, b) for n in (2, 8, 16) for b in (1, 5, 130)])
@pytest.mark.parametrize("hw", ["ideal", "prototype"])
def test_mesh_backward_plain_matches_jax_vjp(n, b, hw):
    """``mesh_backward_plain`` against ``jax.vjp`` of the JAX package's plain
    sweep (``ref.mesh_apply_planes``) on the same coefficients, output
    cotangent and input."""
    rng = np.random.default_rng(1000 * n + b)
    coef = _coef_case(rng, n, J_PROTOTYPE if hw == "prototype" else J_IDEAL)
    x, g = _x(rng, b, n), _x(rng, b, n)
    planes = [np.asarray(a) for a in j_ref.split_channels(jnp.asarray(x))]
    y_planes, vjp = jax.vjp(j_ref.mesh_apply_planes, jnp.asarray(coef),
                            *map(jnp.asarray, planes))
    dj = vjp(tuple(j_ref.split_channels(jnp.asarray(g))))
    dx_j = np.asarray(j_ref.merge_channels(*dj[1:]))
    par = schedule.parity_array(schedule.clements_schedule(n))
    y = torch.from_numpy(np.array(j_ref.merge_channels(*y_planes)))
    dc, dx = givens_mesh.mesh_backward_plain(torch.from_numpy(coef), par, y,
                                             torch.from_numpy(g))
    assert dc.dtype == torch.float32 and dx.dtype == torch.complex64
    np.testing.assert_allclose(dc.numpy(), np.asarray(dj[0]), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(dx.numpy(), dx_j, rtol=0, atol=1e-4)
    if n > 2:  # the wrap slot of odd columns holds no cell
        assert np.all(dc.numpy()[1::2, :, -1] == 0)


@needs_jax
def test_coefficient_inverse_and_adjoint_match_jax():
    rng = np.random.default_rng(8)
    coef = _coef_case(rng, 8, J_PROTOTYPE)
    coef[3, :, 1] = 0.0  # a singular cell: the eps floor keeps it finite
    for tf, jf in ((givens_mesh.inverse_coefficients,
                    j_givens.inverse_coefficients),
                   (givens_mesh.adjoint_coefficients,
                    j_givens.adjoint_coefficients)):
        got = tf(torch.from_numpy(coef)).numpy()
        np.testing.assert_allclose(got, np.asarray(jf(jnp.asarray(coef))),
                                   rtol=1e-6, atol=1e-6)
        assert np.isfinite(got).all()


def _real_plane_grads_jax(fn, p, x):
    """jax.grad of sum(wr Re y + wi Im y) over params and (Re x, Im x)."""
    rng = np.random.default_rng(99)
    wr = rng.normal(size=x.shape).astype(np.float32)
    wi = rng.normal(size=x.shape).astype(np.float32)

    def loss(pp, xr, xi):
        y = fn(pp, xr + 1j * xi)
        return jnp.sum(wr * jnp.real(y) + wi * jnp.imag(y))

    g = jax.grad(loss, argnums=(0, 1, 2))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x.real),
        jnp.asarray(x.imag))
    return g, wr, wi


def _torch_grads(fn, p, x, wr, wi):
    pt = {k: torch.from_numpy(v.copy()).requires_grad_(True)
          for k, v in p.items()}
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    y = fn(pt, xt)
    (torch.from_numpy(wr) * y.real + torch.from_numpy(wi) * y.imag).sum() \
        .backward()
    return {k: v.grad.numpy() for k, v in pt.items()}, xt.grad.numpy()


@needs_jax
@pytest.mark.parametrize("n,b", [(2, 5), (8, 130), (16, 1)])
@pytest.mark.parametrize("hw", ["ideal", "prototype"])
def test_mesh_apply_grads_match_jax_kernel_vjp(n, b, hw):
    """The autograd path of ``ops.mesh_apply`` (with both phase screens)
    against ``jax.grad`` through the JAX kernel's custom VJP (Pallas,
    interpret mode).  PyTorch's complex gradient is dL/dRe + i dL/dIm."""
    jhw, thw = {"ideal": (J_IDEAL, t_hw.IDEAL),
                "prototype": (J_PROTOTYPE, PROTOTYPE)}[hw]
    rng = np.random.default_rng(31 * n + b)
    p = _params(rng, j_mesh.clements_plan(n), alpha_in=True)
    x = _x(rng, b, n)
    (gp, gxr, gxi), wr, wi = _real_plane_grads_jax(
        lambda pp, xx: j_ops.mesh_apply(pp, xx, n=n, hardware=jhw), p, x)
    tp, tx = _torch_grads(
        lambda pp, xx: ops.mesh_apply(pp, xx, n=n, hardware=thw), p, x, wr, wi)
    for k in p:
        np.testing.assert_allclose(tp[k], np.asarray(gp[k]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tx.real, np.asarray(gxr), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tx.imag, np.asarray(gxi), rtol=0, atol=1e-4)


@needs_jax
def test_mesh_apply_cells_grads_mixed_parity_match_jax_kernel():
    """A mixed-parity schedule (which the JAX kernel reads from its parity
    array): gradients in the cells and the input."""
    rng = np.random.default_rng(17)
    cells = _mixed_cells(rng, 8)
    jplan, theta, phi = j_mesh.pack_cells_to_columns(8, cells)
    tplan, _, _ = t_mesh.pack_cells_to_columns(8, cells)
    assert 1 in schedule.schedule_from_plan(tplan).parity[::2]
    t_all = np.array(j_hw.imperfect_cell_matrix(theta, phi, J_PROTOTYPE))
    p = {"tr": t_all.real.copy(), "ti": t_all.imag.copy()}
    x = _x(rng, 7, 8)
    (gp, gxr, gxi), wr, wi = _real_plane_grads_jax(
        lambda pp, xx: j_ops.mesh_apply_cells(pp["tr"] + 1j * pp["ti"], xx,
                                              plan=jplan), p, x)
    tp, tx = _torch_grads(
        lambda pp, xx: ops.mesh_apply_cells(torch.complex(pp["tr"], pp["ti"]),
                                            xx, plan=tplan), p, x, wr, wi)
    for k in p:
        np.testing.assert_allclose(tp[k], np.asarray(gp[k]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tx.real, np.asarray(gxr), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tx.imag, np.asarray(gxi), rtol=0, atol=1e-4)


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("hw", [None, PROTOTYPE])
def test_mesh_backward_plain_finite_difference(n, hw):
    """<grad, d> of the plain backward against float32 central differences
    along random unit directions in (theta, phi, alpha, x): rtol 2e-2,
    atol 5e-3, as ``tests/test_kernel_grads.py`` checks the JAX kernel."""
    rng = np.random.default_rng(n)
    p = _torch(_params(rng, t_mesh.clements_plan(n)))
    x = torch.from_numpy(_x(rng, 4, n))
    wr = torch.from_numpy(rng.normal(size=(4, n)).astype(np.float32))
    wi = torch.from_numpy(rng.normal(size=(4, n)).astype(np.float32))

    def loss(pp, xx):
        y = ops.mesh_apply(pp, xx, n=n, hardware=hw)
        return (wr * y.real + wi * y.imag).sum()

    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    xl = x.clone().requires_grad_(True)
    loss(leaves, xl).backward()
    grads = [leaves[k].grad for k in p] + [xl.grad]
    for i in range(2):
        dirs = [torch.from_numpy(rng.normal(size=t.shape).astype(np.float32))
                for t in p.values()]
        dirs.append(torch.from_numpy(_x(rng, 4, n)))
        norm = float(torch.sqrt(sum((d.abs() ** 2).sum() for d in dirs)))
        dirs = [d / norm for d in dirs]
        eps = 1e-3

        def shifted(t):
            pp = {k: v + t * d for (k, v), d in zip(p.items(), dirs)}
            return float(loss(pp, x + t * dirs[-1]))

        fd = (shifted(eps) - shifted(-eps)) / (2 * eps)
        # real pairing: for complex leaves <g, d> = Re(conj(g) d)
        dot = float(sum((g.conj() * d).real.sum() for g, d in zip(grads, dirs)))
        np.testing.assert_allclose(dot, fd, rtol=2e-2, atol=5e-3)


def test_mesh_backward_validates_and_never_launches_on_cpu():
    sched = schedule.clements_schedule(8)
    coef = torch.zeros(8, 8, 4)
    par = schedule.parity_array(sched)
    y = torch.zeros(3, 8, dtype=torch.complex64)
    with pytest.raises(ValueError, match="cotangent"):
        givens_mesh.mesh_backward_plain(coef, par, y, y[:2])
    with pytest.raises(ValueError):  # the launcher refuses CPU tensors
        givens_mesh.launch_backward(coef, par, y, y)
    dc, dx = givens_mesh.mesh_backward_plain(
        coef, par, y[:0], y[:0])  # B = 0: zero gradients, empty dx
    assert dx.shape == (0, 8) and torch.count_nonzero(dc) == 0
    before = givens_mesh.LAUNCHES["mesh_bwd"]
    p = {k: v.requires_grad_(True) for k, v in _torch(_params(
        np.random.default_rng(1), t_mesh.clements_plan(8))).items()}
    ops.mesh_apply(p, torch.ones(4, 8, dtype=torch.complex64), n=8) \
        .abs().sum().backward()
    assert givens_mesh.LAUNCHES["mesh_bwd"] == before
    assert all(v.grad is not None for v in p.values())


def test_library_path_hashes_shared_headers(tmp_path, monkeypatch):
    """An edit to a shared ``*.cuh`` header changes every library's file
    name, so no stale library is loaded after it (checked on a copy)."""
    import shutil

    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, csrc)
    headers = sorted(csrc.glob("*.cuh"))
    assert headers, "no shared header under csrc/"
    monkeypatch.setattr(cuda_build, "CSRC", csrc)
    names = sorted(p.stem for p in csrc.glob("*.cu"))
    assert {"mesh_fwd", "mesh_bwd", "rfnn_fwd", "rfnn_bwd"} <= set(names)
    before = {name: cuda_build.library_path(name) for name in names}
    assert before == {name: cuda_build.library_path(name) for name in names}
    headers[0].write_bytes(headers[0].read_bytes() + b"\n// edited\n")
    after = {name: cuda_build.library_path(name) for name in names}
    assert all(after[name] != before[name] for name in names)
    (csrc / "rfnn_fwd.cu").write_bytes(b"// another source\n")
    assert cuda_build.library_path("rfnn_fwd") != after["rfnn_fwd"]
    assert cuda_build.library_path("mesh_fwd") == after["mesh_fwd"]


# ---------------------------------------------------------------------------
# the CUDA kernels on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the mesh kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n", [2, 8, 16, 64, 128])
def test_mesh_kernel_matches_plain_on_card(cuda_device, n):
    rng = np.random.default_rng(n)
    plan = t_mesh.clements_plan(n)
    p = _torch(_params(rng, plan))
    sched = schedule.clements_schedule(n)
    for hw in (None, PROTOTYPE):
        coef = ops._mesh_coefficients(sched, p, hw, None)
        par = schedule.parity_array(sched)
        for b in (1, 7, 130, 4096):
            x = torch.from_numpy(_x(rng, b, n))
            y_plain = givens_mesh.mesh_forward_plain(coef, par, x)
            before = givens_mesh.LAUNCHES["mesh_fwd"]
            y = givens_mesh.mesh_forward(coef.to(cuda_device),
                                         par.to(cuda_device),
                                         x.to(cuda_device))
            torch.cuda.synchronize()
            assert givens_mesh.LAUNCHES["mesh_fwd"] == before + 1
            torch.testing.assert_close(y.cpu(), y_plain, rtol=0,
                                       atol=1e-5 * n)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [2, 8, 16, 64])
def test_mesh_backward_kernel_matches_plain_on_card(cuda_device, n):
    """Kernel B2 against its plain version on the same card inputs, ideal
    and PROTOTYPE cells, ragged batches; dcoef bit-identical across calls."""
    rng = np.random.default_rng(50 + n)
    p = _torch(_params(rng, t_mesh.clements_plan(n)))
    sched = schedule.clements_schedule(n)
    par = schedule.parity_array(sched, cuda_device)
    for hw in (None, PROTOTYPE):
        coef = ops._mesh_coefficients(sched, p, hw, None).to(cuda_device)
        for b in (1, 7, 130, 4096):
            x = torch.from_numpy(_x(rng, b, n)).to(cuda_device)
            g = torch.from_numpy(_x(rng, b, n)).to(cuda_device)
            y = givens_mesh.launch(coef, par, x)
            before = givens_mesh.LAUNCHES["mesh_bwd"]
            dc, dx = givens_mesh.launch_backward(coef, par, y, g)
            dc2, _ = givens_mesh.launch_backward(coef, par, y, g)
            torch.cuda.synchronize()
            assert givens_mesh.LAUNCHES["mesh_bwd"] == before + 2
            assert torch.equal(dc, dc2)
            pc, px = givens_mesh.mesh_backward_plain(coef, par, y, g)
            for got, want in ((dc, pc), (dx, px)):
                scale = float(want.abs().max())
                assert float((got - want).abs().max()) <= 1e-5 * n * scale
            if n > 2 and sched.parity[1] == 1:
                assert torch.all(dc[1::2, :, -1] == 0)  # odd columns' wrap slot


@pytest.mark.gpu
def test_mesh_gradient_on_card_launches_backward_kernel(cuda_device):
    """A gradient through ``mesh_apply`` on CUDA tensors runs kernel B2 and
    matches the same gradient on the CPU; B = 0 launches nothing."""
    rng = np.random.default_rng(0)
    p_cpu = _torch(_params(rng, t_mesh.clements_plan(8), alpha_in=True))
    x_cpu = torch.from_numpy(_x(rng, 33, 8))
    grads = {}
    for dev in ("cpu", cuda_device):
        p = {k: v.detach().to(dev).requires_grad_(True)
             for k, v in p_cpu.items()}
        x = x_cpu.detach().to(dev).requires_grad_(True)
        before = givens_mesh.LAUNCHES["mesh_bwd"]
        y = ops.mesh_apply(p, x, n=8, hardware=PROTOTYPE)
        y.abs().sum().backward()
        launched = givens_mesh.LAUNCHES["mesh_bwd"] - before
        assert launched == (0 if dev == "cpu" else 1)
        grads[str(dev)] = [t.grad.cpu() for t in (*p.values(), x)]
    for got, want in zip(grads[str(cuda_device)], grads["cpu"]):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    sched = schedule.clements_schedule(8)
    coef = ops._mesh_coefficients(sched, {k: v.to(cuda_device) for k, v in
                                          p_cpu.items()}, None, None)
    empty = torch.zeros(0, 8, dtype=torch.complex64, device=cuda_device)
    before = givens_mesh.LAUNCHES["mesh_bwd"]
    dc, dx = givens_mesh.launch_backward(
        coef, schedule.parity_array(sched, cuda_device), empty, empty)
    assert givens_mesh.LAUNCHES["mesh_bwd"] == before
    assert dx.shape == (0, 8) and torch.count_nonzero(dc) == 0


@pytest.mark.gpu
def test_mesh_kernels_read_conjugate_views_on_card(cuda_device):
    """A lazily conjugated input or cotangent (conj bit set) is read as its
    conjugate values, not as the memory under the view."""
    rng = np.random.default_rng(4)
    p = _torch(_params(rng, t_mesh.clements_plan(8)))
    sched = schedule.clements_schedule(8)
    coef = ops._mesh_coefficients(sched, p, PROTOTYPE, None).to(cuda_device)
    par = schedule.parity_array(sched, cuda_device)
    x = torch.from_numpy(_x(rng, 9, 8)).to(cuda_device)
    g = torch.from_numpy(_x(rng, 9, 8)).to(cuda_device)
    assert x.conj().is_conj()
    y = givens_mesh.launch(coef, par, x.conj())
    torch.testing.assert_close(y, givens_mesh.launch(coef, par,
                                                     x.conj().resolve_conj()),
                               rtol=0, atol=0)
    dc, dx = givens_mesh.launch_backward(coef, par, y, g.conj())
    dc2, dx2 = givens_mesh.launch_backward(coef, par, y,
                                           g.conj().resolve_conj())
    assert torch.equal(dc, dc2) and torch.equal(dx, dx2)
