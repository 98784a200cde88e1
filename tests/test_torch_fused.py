"""The port's fused analog linear layer (kernels B3/B4/B5) and
``AnalogLinear`` against the JAX package's.

Inputs are made with numpy from a seed and fed to both packages.  JAX runs
``ops.rfnn_linear`` in Pallas interpret mode on the CPU (n <= 8, B <= 16);
the port runs the plain versions of its CUDA kernels (a CPU tensor never
reaches a kernel).  Tolerances: the forward within 1e-5 * n of each
output's largest magnitude (float32 sums in another order, as
``tests/test_kernels.py``); gradients at atol 1e-4, the bound of
``tests/test_kernel_grads.py``; programmed params within 1e-6.  The ``gpu``
tests hold the CUDA kernels to their plain versions on the card and skip
without one; they need no JAX (where it is absent, run them with
``pytest --noconftest -m gpu``).
"""

import dataclasses
import importlib.util

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import interop  # noqa: E402
from repro_torch.core import decompose as t_decompose  # noqa: E402
from repro_torch.core import hardware as t_hw  # noqa: E402
from repro_torch.core import mesh as t_mesh  # noqa: E402
from repro_torch.core.analog_linear import AnalogLinear  # noqa: E402
from repro_torch.kernels import givens_mesh, ops, ref, schedule  # noqa: E402
from repro_torch.paper.prototype import PROTOTYPE  # noqa: E402

if importlib.util.find_spec("jax") is None:
    jax = None  # the card's machine runs the gpu tests without JAX
else:  # with JAX present, a broken reference package fails the run
    import jax
    import jax.numpy as jnp

    from repro.core import decompose as j_decompose
    from repro.core.analog_linear import AnalogLinear as JAnalogLinear
    from repro.core.hardware import IDEAL as J_IDEAL
    from repro.kernels import ops as j_ops
    from repro.paper.prototype import PROTOTYPE as J_PROTOTYPE

    jax.config.update("jax_platform_name", "cpu")

needs_jax = pytest.mark.skipif(jax is None,
                               reason="needs the JAX reference package")


def _x(rng, b, n):
    return (rng.normal(size=(b, n))
            + 1j * rng.normal(size=(b, n))).astype(np.complex64)


def _mesh_params(rng, plan, screens):
    shape = plan.param_shape()
    p = {"theta": rng.uniform(0, np.pi, shape).astype(np.float32),
         "phi": rng.uniform(0, 2 * np.pi, shape).astype(np.float32)}
    if screens:
        p["alpha"] = rng.uniform(0, 2 * np.pi, plan.n).astype(np.float32)
        p["alpha_in"] = rng.uniform(0, 2 * np.pi, plan.n).astype(np.float32)
    return p


def _layer_case(rng, n, plans, screens):
    """Params of both meshes (numpy), the attenuation and both packages'
    plans.  ``plans="reck"`` puts V on an analytic Reck program (more
    columns than U's Clements rectangle: Cv != Cu)."""
    jplan_u = tplan_u = None
    if plans == "reck":
        u = j_decompose.random_unitary(n, seed=n)
        jplan_v, vp = j_decompose.reck_program(u)
        tplan_v, _ = t_decompose.reck_program(u, device="cpu")
        vp = {k: np.asarray(v) for k, v in vp.items()}
        if screens:
            vp["alpha"] = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
        else:
            vp.pop("alpha_in")
    else:
        jplan_v = tplan_v = None
        vp = _mesh_params(rng, t_mesh.clements_plan(n), screens)
    up = _mesh_params(rng, t_mesh.clements_plan(n), screens)
    atten = rng.uniform(0.1, 0.9, n).astype(np.float32)
    return vp, up, atten, (jplan_v, jplan_u), (tplan_v, tplan_u)


def _jax(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _torch(p, grad=False):
    return {k: torch.from_numpy(np.array(v)).requires_grad_(grad)
            for k, v in p.items()}


# ---------------------------------------------------------------------------
# ops.rfnn_linear against JAX
# ---------------------------------------------------------------------------

@needs_jax
@pytest.mark.parametrize("n", [2, 4, 8, 16, 32])
@pytest.mark.parametrize("plans", ["clements", "reck"])
def test_rfnn_linear_matches_jax(n, plans):
    """Forward, with and without the screens, ideal and PROTOTYPE cells
    (noiseless): within 1e-5 * n of each output's largest magnitude.  n =
    16 and 32 are widths of B3/B4's register path."""
    rng = np.random.default_rng(10 * n + (plans == "reck"))
    x = _x(rng, 7, n)
    calls = ops.KERNEL_PATH_CALLS["rfnn_linear"]
    for screens in (False, True):
        vp, up, atten, jplans, tplans = _layer_case(rng, n, plans, screens)
        if plans == "reck":
            cv = schedule.schedule_from_plan(tplans[0]).n_columns
            assert cv != schedule.clements_schedule(n).n_columns or n == 2
        for jhw, thw in ((None, None), (J_PROTOTYPE, PROTOTYPE)):
            yj = np.asarray(j_ops.rfnn_linear(
                _jax(vp), jnp.asarray(atten), _jax(up), jnp.asarray(x), n=n,
                scale=1.3, v_plan=jplans[0], u_plan=jplans[1], hardware=jhw))
            yt = ops.rfnn_linear(
                _torch(vp), torch.from_numpy(atten), _torch(up),
                torch.from_numpy(x), n=n, scale=1.3, v_plan=tplans[0],
                u_plan=tplans[1], hardware=thw)
            assert yt.dtype == torch.float32 and yt.shape == (7, n)
            np.testing.assert_allclose(yt.numpy(), yj, rtol=0,
                                       atol=1e-5 * n * np.abs(yj).max())
    assert ops.KERNEL_PATH_CALLS["rfnn_linear"] == calls + 4


@needs_jax
@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("plans", ["clements", "reck"])
@pytest.mark.parametrize("hw", ["ideal", "prototype"])
def test_rfnn_linear_grads_match_jax(n, plans, hw):
    """Gradients in both meshes' params, the attenuation, the scale and x
    against ``jax.grad`` through the Pallas custom VJP (interpret mode):
    atol 1e-4.  PyTorch's complex gradient is dL/dRe + i dL/dIm."""
    jhw, thw = {"ideal": (J_IDEAL, t_hw.IDEAL),
                "prototype": (J_PROTOTYPE, PROTOTYPE)}[hw]
    rng = np.random.default_rng(3 * n + (plans == "reck"))
    vp, up, atten, jplans, tplans = _layer_case(rng, n, plans, True)
    x = _x(rng, 6, n)
    w = rng.normal(size=(6, n)).astype(np.float32)

    def loss_j(v, a, u, s, xr, xi):
        return jnp.sum(w * j_ops.rfnn_linear(
            v, a, u, xr + 1j * xi, n=n, scale=s, v_plan=jplans[0],
            u_plan=jplans[1], hardware=jhw))

    gj = jax.grad(loss_j, argnums=range(6))(
        _jax(vp), jnp.asarray(atten), _jax(up), jnp.float32(1.3),
        jnp.asarray(x.real), jnp.asarray(x.imag))
    tv, tu = _torch(vp, True), _torch(up, True)
    ta = torch.from_numpy(atten).requires_grad_(True)
    ts = torch.tensor(1.3, requires_grad=True)
    tx = torch.from_numpy(x).requires_grad_(True)
    y = ops.rfnn_linear(tv, ta, tu, tx, n=n, scale=ts, v_plan=tplans[0],
                        u_plan=tplans[1], hardware=thw)
    (torch.from_numpy(w) * y).sum().backward()
    for tp, jp in ((tv, gj[0]), (tu, gj[2])):
        for k in tp:
            np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jp[k]),
                                       rtol=0, atol=1e-4)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(gj[1]), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(float(ts.grad), float(gj[3]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tx.grad.numpy().real, np.asarray(gj[4]),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(tx.grad.numpy().imag, np.asarray(gj[5]),
                               rtol=0, atol=1e-4)


# tests/test_hw_kernels.py::test_fused_rfnn_linear_differential's example
# that Hypothesis stored and replays (ROADMAP C-ref9): at it the JAX fused
# kernel's gradient reads 1.0048e-5 against the composite reference
CREF9_SEED, CREF9_N = 1_891_098_766, 16


@needs_jax
def test_rfnn_linear_matches_jax_at_cref9_input(capsys):
    """ROADMAP C-ref9's input, exactly as the JAX test draws it (non-ideal
    hardware from ``default_rng(seed)``, params, attenuation, x and the
    noise keys from ``PRNGKey(seed + i)``): the port's fused layer (B3/B5's
    plain versions) against JAX's ``ops.rfnn_linear`` (interpret mode),
    forward and the full gradient (both meshes' params, the attenuation and
    x), within 1e-5 relative in norm, the JAX test's bound.  JAX's phase
    noise is carried as the normals its keys stand for, added to the phases
    (the port draws noise from a generator).  The port's distance to the
    composite reference, the comparison the JAX test gates, is printed."""
    from repro.core import hardware as j_hw
    from repro.core import mesh as j_mesh

    seed, n = CREF9_SEED, CREF9_N
    rng = np.random.default_rng(seed)
    jhw = j_hw.HardwareModel(
        hybrid_imbalance=float(rng.uniform(0.0, 0.08)),
        hybrid_phase_err=float(rng.uniform(0.0, np.deg2rad(4.0))),
        cell_loss_db=float(rng.uniform(0.0, 0.6)),
        phase_sigma=float(rng.uniform(0.0, np.deg2rad(2.0))),
        detector_floor_dbm=-300.0, detector_sigma=0.0)
    thw = t_hw.HardwareModel(**dataclasses.asdict(jhw))
    plan = j_mesh.clements_plan(n)
    vp = j_mesh.init_mesh_params(jax.random.PRNGKey(seed), plan)
    up = j_mesh.init_mesh_params(jax.random.PRNGKey(seed + 1), plan)
    atten = jax.random.uniform(jax.random.PRNGKey(seed + 2), (n,),
                               minval=0.2, maxval=0.9)
    x = jax.random.normal(jax.random.PRNGKey(seed + 3), (5, n))
    w = jax.random.normal(jax.random.PRNGKey(seed + 4), (5, n))
    kv, ku = jax.random.split(jax.random.PRNGKey(seed + 5))
    scale = 1.3

    def fwd_k(v, a, u, xx):
        return j_ops.rfnn_linear(v, a, u, xx, n=n, scale=scale, hardware=jhw,
                                 key_v=kv, key_u=ku, block_b=8)

    def fwd_r(v, a, u, xx):
        h = j_hw.apply_mesh_hw(plan, v, xx.astype(jnp.complex64), jhw, kv)
        y = j_hw.apply_mesh_hw(plan, u, h * a.astype(jnp.complex64), jhw, ku)
        return jnp.abs(scale * y)

    args = (vp, atten, up, x)
    want = {name: (np.asarray(f(*args)), jax.grad(
        lambda *a, f=f: jnp.sum(w * f(*a)), argnums=(0, 1, 2, 3))(*args))
        for name, f in (("kernel", fwd_k), ("reference", fwd_r))}

    def noisy(p, key):
        k1, k2 = jax.random.split(key)
        sigma = np.float32(jhw.phase_sigma)
        out = _torch(p, True)
        z = {"theta": jax.random.normal(k1, p["theta"].shape),
             "phi": jax.random.normal(k2, p["phi"].shape)}
        moved = {k: out[k] + sigma * torch.from_numpy(np.array(z[k]))
                 for k in z}
        return out, dict(out, **moved)

    tv, tv_noisy = noisy(vp, kv)
    tu, tu_noisy = noisy(up, ku)
    ta = torch.from_numpy(np.array(atten)).requires_grad_(True)
    tx = torch.from_numpy(np.array(x)).requires_grad_(True)
    y = ops.rfnn_linear(tv_noisy, ta, tu_noisy, tx, n=n, scale=scale,
                        hardware=thw)
    (torch.from_numpy(np.array(w)) * y).sum().backward()
    got_y = y.detach().numpy()

    def flat(tree):
        return np.concatenate([np.asarray(t).ravel()
                               for t in jax.tree.leaves(tree)])

    got_g = np.concatenate([
        flat({k: tv[k].grad.numpy() for k in vp}), ta.grad.numpy(),
        flat({k: tu[k].grad.numpy() for k in up}), tx.grad.numpy().ravel()])

    def rel(a, b):
        return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))

    errs = {name: (rel(got_y, wy), rel(got_g, flat(wg)))
            for name, (wy, wg) in want.items()}
    jax_gap = (rel(want["kernel"][0], want["reference"][0]),
               rel(flat(want["kernel"][1]), flat(want["reference"][1])))
    with capsys.disabled():
        print(f"\n[C-ref9] port vs JAX kernel: forward {errs['kernel'][0]:.3e}, "
              f"gradient {errs['kernel'][1]:.3e}; port vs composite "
              f"reference: forward {errs['reference'][0]:.3e}, gradient "
              f"{errs['reference'][1]:.3e}; JAX kernel vs composite: "
              f"forward {jax_gap[0]:.3e}, gradient {jax_gap[1]:.3e}")
    assert errs["kernel"][0] <= 1e-5
    assert errs["kernel"][1] <= 1e-5


def _kernel_inputs(rng, n, hw, reck=False, zero_gain=False):
    """Coefficients, parities and gains of a fused layer in the kernels'
    layout (torch, CPU)."""
    plan_u = t_mesh.clements_plan(n)
    if reck:
        plan_v, vp = t_decompose.reck_program(
            t_decompose.random_unitary(n, seed=n + 1), device="cpu")
    else:
        plan_v = plan_u
        vp = _torch(_mesh_params(rng, plan_u, False))
    up = _torch(_mesh_params(rng, plan_u, False))
    sv, su = schedule.schedule_from_plan(plan_v), schedule.clements_schedule(n)
    coef_v = ops._mesh_coefficients(sv, vp, hw, None)
    coef_u = ops._mesh_coefficients(su, up, hw, None)
    gains = torch.from_numpy(rng.normal(size=(8, n // 2)).astype(np.float32))
    if zero_gain:  # a rank-deficient program: exact zeros in g1
        gains[2:4, : max(1, n // 4)] = 0.0
    return (coef_v, schedule.parity_array(sv), coef_u,
            schedule.parity_array(su), gains)


@pytest.mark.parametrize("n", [2, 8, 16])
@pytest.mark.parametrize("case", ["ideal", "prototype", "reck_zero_gain"])
def test_rfnn_backward_plain_matches_autograd_of_plain_forward(n, case):
    """The plain B5 against autograd through the plain B4 on the same
    inputs, with Cv != Cu and exact zeros in g1 (the reason both stage
    boundaries are saved): each output within 1e-5 * n of its largest
    magnitude."""
    rng = np.random.default_rng(n)
    inputs = _kernel_inputs(rng, n, PROTOTYPE if case == "prototype" else None,
                            reck=case.startswith("reck"),
                            zero_gain=case.endswith("zero_gain"))
    coef_v, par_v, coef_u, par_u, gains = inputs
    x = torch.from_numpy(_x(rng, 9, n))
    g = torch.from_numpy(rng.normal(size=(9, n)).astype(np.float32))
    out, v, u = givens_mesh.rfnn_forward_plain(*inputs, x)
    got = givens_mesh.rfnn_backward_plain(*inputs, v, u, g)
    leaves = [t.clone().requires_grad_(True) for t in (coef_v, coef_u, gains, x)]
    out2, _, _ = ref.rfnn_linear_planes(leaves[0], par_v, leaves[1], par_u,
                                        leaves[2], leaves[3])
    torch.testing.assert_close(out2, out, rtol=0, atol=0)
    want = torch.autograd.grad(out2, leaves, grad_outputs=g)
    for name, a, b in zip(("dcv", "dcu", "dg", "dx"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-5 * n * max(scale, 1e-30), name
    if n > 2:  # the wrap slot of parity-1 columns holds no cell
        assert torch.all(got[0][par_v == 1, :, -1] == 0)


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("hw", [None, PROTOTYPE])
def test_rfnn_linear_finite_difference(n, hw):
    """<grad, d> of the plain backward against float32 central differences
    along random unit directions in (V, U, atten, scale, x): rtol 2e-2,
    atol 5e-3, as ``tests/test_kernel_grads.py`` checks the JAX kernel."""
    rng = np.random.default_rng(20 + n)
    plan = t_mesh.clements_plan(n)
    p = {**{f"v_{k}": v for k, v in _torch(_mesh_params(rng, plan, True)).items()},
         **{f"u_{k}": v for k, v in _torch(_mesh_params(rng, plan, True)).items()},
         "atten": torch.from_numpy(rng.uniform(0.2, 0.8, n).astype(np.float32)),
         "scale": torch.tensor(1.4)}
    x = torch.from_numpy(_x(rng, 4, n))
    w = torch.from_numpy(rng.normal(size=(4, n)).astype(np.float32))

    def loss(pp, xx):
        vv = {k[2:]: v for k, v in pp.items() if k.startswith("v_")}
        uu = {k[2:]: v for k, v in pp.items() if k.startswith("u_")}
        return (w * ops.rfnn_linear(vv, pp["atten"], uu, xx, n=n,
                                    scale=pp["scale"], hardware=hw)).sum()

    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    xl = x.clone().requires_grad_(True)
    loss(leaves, xl).backward()
    grads = [leaves[k].grad for k in p] + [xl.grad]
    for _ in range(2):
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
        dot = float(sum((g.conj() * d).real.sum() for g, d in zip(grads, dirs)))
        np.testing.assert_allclose(dot, fd, rtol=2e-2, atol=5e-3)


def test_rfnn_linear_zero_input_row_and_zero_attenuation_give_finite_grads():
    """|.| at the origin: a zero input row (and a zero attenuation) gives
    exactly zero, finite gradients, not NaN."""
    rng = np.random.default_rng(0)
    plan = t_mesh.clements_plan(8)
    vp, up = (_torch(_mesh_params(rng, plan, True), True) for _ in range(2))
    atten = torch.from_numpy(rng.uniform(0.1, 0.9, 8).astype(np.float32))
    atten[2] = 0.0
    atten.requires_grad_(True)
    x = torch.from_numpy(_x(rng, 4, 8))
    x[1] = 0
    x.requires_grad_(True)
    y = ops.rfnn_linear(vp, atten, up, x, n=8, scale=0.7, hardware=PROTOTYPE)
    assert torch.all(y[1] == 0)
    y.sum().backward()
    for t in (*vp.values(), *up.values(), atten, x):
        assert torch.isfinite(t.grad).all()
    assert torch.all(x.grad[1] == 0)


def test_rfnn_linear_batch_shapes_empty_batch_and_reference_oracle():
    rng = np.random.default_rng(5)
    plan = t_mesh.clements_plan(8)
    vp, up = (_torch(_mesh_params(rng, plan, False)) for _ in range(2))
    vp["alpha"] = torch.from_numpy(rng.uniform(0, 6, 8).astype(np.float32))
    up["alpha"] = torch.from_numpy(rng.uniform(0, 6, 8).astype(np.float32))
    atten = torch.from_numpy(rng.uniform(0.1, 0.9, 8).astype(np.float32))
    x = torch.from_numpy(_x(rng, 6, 8))
    y = ops.rfnn_linear(vp, atten, up, x.reshape(2, 3, 8), n=8, scale=1.1)
    assert y.shape == (2, 3, 8)
    want = ref.rfnn_linear_ref(vp, atten, up, x, 8, 1.1)
    torch.testing.assert_close(y.reshape(6, 8), want, rtol=0, atol=8e-5)
    empty = ops.rfnn_linear(vp, atten, up, x[:0], n=8)
    assert empty.shape == (0, 8) and empty.dtype == torch.float32


def test_rfnn_forward_takes_the_residual_free_path_without_grad():
    """Without a gradient the forward skips the autograd Function (B3 on the
    card, which writes no residuals); with one it goes through it (B4)."""
    rng = np.random.default_rng(2)
    inputs = _kernel_inputs(rng, 8, None)
    x = torch.from_numpy(_x(rng, 5, 8))
    assert givens_mesh.rfnn_forward(*inputs, x).grad_fn is None
    xg = x.clone().requires_grad_(True)
    with torch.no_grad():
        assert givens_mesh.rfnn_forward(*inputs, xg).grad_fn is None
    y = givens_mesh.rfnn_forward(*inputs, xg)
    assert type(y.grad_fn).__name__ == "_RfnnSweepBackward"
    torch.testing.assert_close(y, givens_mesh.rfnn_forward(*inputs, x),
                               rtol=0, atol=0)


def test_rfnn_forward_validates_inputs_and_devices():
    rng = np.random.default_rng(3)
    coef_v, par_v, coef_u, par_u, gains = _kernel_inputs(rng, 8, None)
    x = torch.from_numpy(_x(rng, 3, 8))
    with pytest.raises(ValueError, match="gains"):
        givens_mesh.rfnn_forward(coef_v, par_v, coef_u, par_u, gains[:4], x)
    with pytest.raises(ValueError):
        givens_mesh.rfnn_forward(coef_v, par_v, coef_u[:, :, :3], par_u,
                                 gains, x)
    with pytest.raises(ValueError):  # neither cuda nor cpu: never the plain path
        givens_mesh.rfnn_forward(*(t.to("meta") for t in (
            coef_v, par_v, coef_u, par_u, gains, x)))
    with pytest.raises(ValueError):  # the launchers refuse CPU tensors
        givens_mesh.launch_rfnn(coef_v, par_v, coef_u, par_u, gains, x)
    _, v, u = givens_mesh.rfnn_forward_plain(coef_v, par_v, coef_u, par_u,
                                             gains, x)
    g = torch.ones(3, 8)
    with pytest.raises(ValueError):
        givens_mesh.launch_rfnn_backward(coef_v, par_v, coef_u, par_u, gains,
                                         v, u, g)
    with pytest.raises(ValueError, match="cotangent"):
        givens_mesh.rfnn_backward_plain(coef_v, par_v, coef_u, par_u, gains,
                                        v, u, g.double())
    before = dict(givens_mesh.LAUNCHES)
    ops.rfnn_linear(_torch(_mesh_params(rng, t_mesh.clements_plan(8), False)),
                    torch.ones(8),
                    _torch(_mesh_params(rng, t_mesh.clements_plan(8), False)),
                    x, n=8)
    assert givens_mesh.LAUNCHES == before


# ---------------------------------------------------------------------------
# AnalogLinear against JAX
# ---------------------------------------------------------------------------

def _requires_grad(tree):
    if isinstance(tree, dict):
        return {k: _requires_grad(v) for k, v in tree.items()}
    return tree.requires_grad_(True)


def _grads(tree):
    if isinstance(tree, dict):
        return {k: _grads(v) for k, v in tree.items()}
    return tree.grad.numpy()


def _assert_trees_close(got, want, atol):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_trees_close(got[k], want[k], atol)
    else:
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol)


@needs_jax
@pytest.mark.parametrize("output", ["abs", "real", "complex"])
@pytest.mark.parametrize("quantize", [None, "table1"])
def test_analog_linear_matches_jax_pallas(output, quantize):
    """Loss and gradients of ``AnalogLinear`` (params exported from JAX)
    against the JAX package's pallas backend: atol 1e-4."""
    jl = JAnalogLinear(in_dim=6, out_dim=8, quantize=quantize, output=output,
                       backend="pallas")
    jp = jl.init(jax.random.PRNGKey(3))
    rng = np.random.default_rng(4)
    x = rng.normal(size=(5, 6)).astype(np.float32)
    w = rng.normal(size=(5, 8)).astype(np.float32)

    def loss_j(p):
        y = jl.apply(p, jnp.asarray(x))
        return jnp.sum(w * (jnp.abs(y) if output == "complex" else y))

    lj, gj = jax.value_and_grad(loss_j)(jp)
    tl = AnalogLinear(in_dim=6, out_dim=8, quantize=quantize, output=output)
    tp = _requires_grad(interop.params_from_numpy(
        jax.tree.map(np.asarray, jp), device="cpu"))
    y = tl.apply(tp, torch.from_numpy(x))
    assert y.shape == (5, 8)
    lt = (torch.from_numpy(w) * (y.abs() if output == "complex" else y)).sum()
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=0,
                               atol=1e-4)
    _assert_trees_close(_grads(tp), gj, atol=1e-4)


@needs_jax
@pytest.mark.parametrize("shape", [(4, 6), (6, 4), (8, 8)])
def test_init_from_matrix_matches_jax_and_realizes_matmul(shape):
    """The Reck plans equal JAX's, the params agree within 1e-6, and the
    programmed layer computes ``x @ W.T`` within 1e-4."""
    out_d, in_d = shape
    w = np.random.default_rng(0).normal(size=shape)
    jl = JAnalogLinear(in_dim=in_d, out_dim=out_d, output="real")
    jp = jl.init_from_matrix(w)
    tl = AnalogLinear(in_dim=in_d, out_dim=out_d, output="real")
    tp = tl.init_from_matrix(w, device="cpu")
    for tplan, jplan in ((tl.u_plan, jl.u_plan), (tl.v_plan, jl.v_plan)):
        assert tplan == t_mesh.MeshPlan(jplan.n, jplan.top, jplan.active,
                                        jplan.slot, jplan.role)
    _assert_trees_close(interop.params_to_numpy(tp),
                        jax.tree.map(np.asarray, jp), atol=1e-6)
    x = np.random.default_rng(1).normal(size=(5, in_d)).astype(np.float32)
    with torch.no_grad():
        y = tl.apply(tp, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), x @ w.T, rtol=0, atol=1e-4)
    assert tl.n_cells() == jl.n_cells()


def test_analog_linear_backends_agree_draw_for_draw():
    """The kernel backend (fused layer for "abs") and the reference column
    scan consume one generator in the same order (V's phase noise, U's,
    then the detector's) and give the same readouts."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(7, 5)).astype(np.float32))
    for output in ("abs", "real"):
        layer = AnalogLinear(in_dim=5, out_dim=6, hardware=PROTOTYPE,
                             quantize="table1", output=output)
        ref_layer = dataclasses.replace(layer, backend="reference")
        params = layer.init(torch.Generator().manual_seed(1), device="cpu")
        y_k = layer.apply(params, x, generator=torch.Generator().manual_seed(9))
        y_r = ref_layer.apply(params, x,
                              generator=torch.Generator().manual_seed(9))
        assert y_k.shape == (7, 6)
        torch.testing.assert_close(y_k, y_r, rtol=0, atol=1e-5)
        y_quiet = layer.apply(params, x)
        assert float((y_k - y_quiet).abs().max()) > 1e-4  # noise was drawn
    assert layer.n_cells() == 2 * 15


def test_analog_linear_programmed_abs_matches_abs_matmul_and_trains():
    """A programmed "abs" layer computes |W x| through the fused path, and a
    few SGD steps through it lower a loss."""
    from repro_torch.train import make_sgd_step

    rng = np.random.default_rng(7)
    w = rng.normal(size=(8, 8))
    layer = AnalogLinear(in_dim=8, out_dim=8, output="abs")
    params = layer.init_from_matrix(w, device="cpu")
    x = rng.normal(size=(16, 8)).astype(np.float32)
    with torch.no_grad():
        y = layer.apply(params, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.abs(x @ w.T), rtol=0,
                               atol=1e-4 * np.abs(x @ w.T).max())
    target = torch.from_numpy(np.abs(x @ w.T).astype(np.float32))
    student = AnalogLinear(in_dim=8, out_dim=8, output="abs")
    p = student.init(torch.Generator().manual_seed(0), device="cpu")

    def loss_fn(pp, xb, yb):
        loss = ((student.apply(pp, xb) - yb) ** 2).mean()
        return loss, loss

    step = make_sgd_step(loss_fn, lr=0.05)
    xt = torch.from_numpy(x)
    losses = []
    for _ in range(20):
        p, (loss, _) = step(p, xt, target)
        losses.append(float(loss))
    assert losses[-1] < losses[0]


def test_analog_linear_init_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the CUDA default would run")
    with pytest.raises(RuntimeError, match="CUDA"):
        AnalogLinear(in_dim=4, out_dim=4).init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        AnalogLinear(in_dim=4, out_dim=4).init_from_matrix(np.eye(4))
    with pytest.raises(ValueError, match="backend"):
        AnalogLinear(in_dim=4, out_dim=4, backend="pallas")


# ---------------------------------------------------------------------------
# launch plans of B5 (computed on the host)
# ---------------------------------------------------------------------------

def _two_per_sm(reg, n, lanes, threads, smem):
    return 2


@pytest.mark.parametrize("n,b,cv,cu,path,rows,lanes,blocks,kernels", [
    (8, 10, 8, 8, 1, 32, 1, 1, 1),        # a batch in one warp: one kernel
    (8, 256, 13, 13, 1, 256, 1, 1, 1),    # the most one block holds
    (8, 257, 8, 8, 1, 8, 4, 33, 2),       # lanes a row, spread, summed
    (8, 1000, 8, 8, 1, 8, 4, 125, 2),     # the fused layer's training step
    (16, 4096, 29, 16, 1, 16, 8, 256, 2),  # rows shrunk to fit their terms
    (2, 31, 1, 2, 1, 32, 1, 1, 1),
    (2, 1000, 1, 2, 1, 32, 1, 32, 2),     # n = 2: one lane is one thread
    (4, 100, 5, 4, 1, 128, 1, 1, 1),
    (16, 33, 29, 16, 1, 64, 1, 1, 1),
    (32, 100, 61, 61, 1, 32, 1, 4, 2),    # one warp's accumulator fits
    (32, 1000, 61, 61, 1, 32, 1, 32, 2),  # two rows' terms would not
    (64, 7, 64, 64, 0, 4, 1, 2, 2),       # n = 64 keeps the general path
    (6, 130, 6, 6, 0, 42, 1, 4, 2),       # no register path at n = 6
])
def test_rfnn_bwd_layouts_choose_path_rows_and_blocks(n, b, cv, cu, path,
                                                       rows, lanes, blocks,
                                                       kernels):
    plan = givens_mesh.rfnn_bwd_layout(b, n, cv, cu, 132, _two_per_sm)
    assert plan["register_path"] == path
    assert plan["rows"] == rows and plan["blocks"] == blocks
    assert plan["lanes"] == lanes and plan["kernels"] == kernels
    assert plan["threads"] == (rows * lanes if path else 128)
    assert plan["shared_bytes"] <= 232448
    if path:  # whole warps, blocks no more than the batch's row tiles
        assert plan["threads"] % 32 == 0 and blocks <= -(-b // rows)


def test_rfnn_bwd_layout_fits_shared_memory_and_refuses_no_rows():
    """Wide Reck meshes take fewer warps, then the general path: never a
    launch that the card refuses."""
    narrow = givens_mesh.rfnn_bwd_layout(256, 32, 61, 61, 132, _two_per_sm)
    assert narrow["register_path"] == 1 and narrow["rows"] == 32
    assert narrow["kernels"] == 2
    wide = givens_mesh.rfnn_bwd_layout(10, 32, 200, 200, 132, _two_per_sm)
    assert wide["register_path"] == 0
    with pytest.raises(ValueError):
        givens_mesh.rfnn_bwd_layout(0, 8, 8, 8, 132, _two_per_sm)


def test_rfnn_bwd_plans_are_cached_per_card_and_shape(monkeypatch):
    calls = []

    def occupancy(*args):
        calls.append(args)
        return 3

    monkeypatch.setattr(givens_mesh, "_PLANS", {})
    monkeypatch.setattr(givens_mesh, "_SMS", {0: 132, 1: 66})
    monkeypatch.setattr(givens_mesh, "_rfnn_occupancy", occupancy)
    first = givens_mesh._cached_plan("rfnn_bwd", 0, 1000, 8, 8, 8)
    assert givens_mesh._cached_plan("rfnn_bwd", 0, 1000, 8, 8, 8) is first
    assert len(calls) == 1
    assert givens_mesh._cached_plan("rfnn_bwd", 1, 1000, 8, 8, 8)["rows"] \
        == 16                                 # ceil(1000 / 66) rows a block
    assert givens_mesh._cached_plan("rfnn_bwd", 0, 1000, 8, 13, 13) \
        is not first
    assert givens_mesh._cached_plan("rfnn_bwd", 0, 10, 8, 8, 8)["kernels"] \
        == 1
    assert len(calls) == 3                    # one block needs no wave
    assert len(givens_mesh._PLANS) == 4


# ---------------------------------------------------------------------------
# launch plans of B3/B4 (computed on the host)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,b,cv,cu,path,rows,lanes,blocks,smem", [
    (8, 1, 13, 13, 1, 32, 4, 1, 3568),        # at least 128 threads
    (8, 1000, 8, 8, 1, 32, 4, 32, 2240),      # the fused layer's training step
    (8, 4096, 13, 13, 1, 32, 4, 128, 3568),   # the programmed processor
    (8, 16383, 13, 13, 1, 64, 4, 256, 3568),  # lanes: at most 256 threads
    (8, 16384, 13, 13, 1, 128, 1, 128, 3568),  # one thread a row from here
    (8, 65536, 13, 13, 1, 256, 1, 256, 3568),
    (2, 1000, 1, 2, 1, 32, 1, 32, 144),       # n = 2: one lane is one thread
    (4, 100, 5, 4, 1, 64, 2, 2, 688),
    (16, 33, 29, 16, 1, 16, 8, 3, 11968),
    (16, 4096, 29, 16, 1, 32, 8, 128, 11968),  # ceil(B / SMs) rows a block
    (32, 10, 61, 61, 1, 8, 16, 2, 63472),     # Reck's 61 + 61 columns fit
    (64, 7, 64, 64, 0, 4, 1, 2, 2048),        # n = 64 keeps the general path
    (6, 130, 6, 6, 0, 42, 1, 4, 2016),        # no register path at n = 6
])
def test_rfnn_fwd_layouts_choose_path_rows_lanes_and_blocks(
        n, b, cv, cu, path, rows, lanes, blocks, smem):
    plan = givens_mesh.rfnn_fwd_layout(b, n, cv, cu, 132)
    assert plan == {"register_path": path, "rows": rows, "lanes": lanes,
                    "threads": rows * lanes if path else 128,
                    "blocks": blocks, "shared_bytes": smem}
    if path:  # whole warps; every row in a block
        assert plan["threads"] % 32 == 0 and plan["threads"] <= 256
        assert (blocks - 1) * rows < b <= blocks * rows
        assert lanes == (n // 2 if n >= 4 and b < givens_mesh
                         .RFNN_FWD_LANES_BELOW else 1)


def test_rfnn_fwd_layout_fits_shared_memory_and_refuses_no_rows():
    """Reck's 61 + 61 columns at n = 32 stage in one block; meshes whose
    cells would not fit take the general path; no batch, no plan."""
    reck = givens_mesh.rfnn_fwd_layout(4096, 32, 61, 61, 132)
    assert reck["register_path"] == 1 and reck["lanes"] == 16
    assert reck["shared_bytes"] == givens_mesh._rfnn_fwd_smem(32, 61, 61) \
        <= givens_mesh._MAX_SHARED
    wide = givens_mesh.rfnn_fwd_layout(10, 32, 400, 400, 132)
    assert wide["register_path"] == 0
    for b in (0, -1):
        with pytest.raises(ValueError):
            givens_mesh.rfnn_fwd_layout(b, 8, 8, 8, 132)
    for n, lanes in ((2, 2), (8, 2), (6, 1)):
        with pytest.raises(ValueError):
            givens_mesh.rfnn_fwd_register_plan(10, n, 8, 8, 132, lanes)
    assert givens_mesh.rfnn_fwd_general_plan(130, 8) == {
        "register_path": 0, "rows": 32, "lanes": 1, "threads": 128,
        "blocks": 5, "shared_bytes": 2048}
    with pytest.raises(ValueError):
        givens_mesh.rfnn_fwd_general_plan(0, 8)


def test_rfnn_fwd_plans_are_cached_per_card_and_shape(monkeypatch):
    monkeypatch.setattr(givens_mesh, "_PLANS", {})
    monkeypatch.setattr(givens_mesh, "_SMS", {0: 132, 1: 66})
    first = givens_mesh._cached_plan("rfnn_fwd", 0, 4096, 8, 8, 8)
    assert givens_mesh._cached_plan("rfnn_fwd", 0, 4096, 8, 8, 8) is first
    assert first == givens_mesh.rfnn_fwd_layout(4096, 8, 8, 8, 132)
    assert first["rows"] == 32
    assert givens_mesh._cached_plan("rfnn_fwd", 1, 4096, 8, 8, 8)["rows"] \
        == 64                                 # ceil(4096 / 66) rows a block
    other = givens_mesh._cached_plan("rfnn_fwd", 0, 4096, 8, 13, 13)
    assert other is not first and other["shared_bytes"] == 3568
    monkeypatch.setattr(givens_mesh, "_rfnn_occupancy", lambda *args: 2)
    givens_mesh._cached_plan("rfnn_bwd", 0, 4096, 8, 8, 8)
    assert len(givens_mesh._PLANS) == 4       # B5's plan is kept apart
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    plan = givens_mesh.rfnn_fwd_plan(4096, 8, 8, 8)
    assert plan["rows"] == 64 and len(givens_mesh._PLANS) == 4
    plan["rows"] = 0                          # a copy: the cache is intact
    assert givens_mesh.rfnn_fwd_plan(4096, 8, 8, 8)["rows"] == 64


# ---------------------------------------------------------------------------
# the CUDA kernels on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused kernels have no CPU mode")
    return torch.device("cuda")


def _close(got, want, n):
    scale = float(want.abs().max()) if want.numel() else 0.0
    return float((got - want).abs().max()) <= 1e-5 * n * max(scale, 1e-30) \
        if want.numel() else True


@pytest.mark.gpu
@pytest.mark.parametrize("n", [2, 8, 16, 64])
def test_rfnn_kernels_match_plain_on_card(cuda_device, n):
    """B3, B4 and B5 against their plain versions on the same card inputs:
    ideal and PROTOTYPE cells, a Reck V (Cv != Cu) with zeros in g1, ragged
    batches; the gradients bit-identical across two calls."""
    rng = np.random.default_rng(70 + n)
    for hw, reck in ((None, False), (PROTOTYPE, False), (PROTOTYPE, True)):
        inputs = [t.to(cuda_device) for t in _kernel_inputs(
            rng, n, hw, reck=reck, zero_gain=reck)]
        for b in (1, 7, 130, 4096):
            x = torch.from_numpy(_x(rng, b, n)).to(cuda_device)
            g = torch.from_numpy(rng.normal(size=(b, n)).astype(np.float32)) \
                .to(cuda_device)
            before = dict(givens_mesh.LAUNCHES)
            out3 = givens_mesh.launch_rfnn(*inputs, x)
            out4, v, u = givens_mesh.launch_rfnn(*inputs, x, save_stages=True)
            grads = givens_mesh.launch_rfnn_backward(*inputs, v, u, g)
            grads2 = givens_mesh.launch_rfnn_backward(*inputs, v, u, g)
            torch.cuda.synchronize()
            for k in ("rfnn_fwd", "rfnn_fwd_res"):
                assert givens_mesh.LAUNCHES[k] == before[k] + 1
            assert givens_mesh.LAUNCHES["rfnn_bwd"] == before["rfnn_bwd"] + 2
            assert torch.equal(out3, out4)
            for a, c in zip(grads[:3], grads2[:3]):
                assert torch.equal(a, c)
            pout, pv, pu = givens_mesh.rfnn_forward_plain(*inputs, x)
            for got, want in ((out3, pout), (v, pv), (u, pu)):
                assert _close(got, want, n)
            want = givens_mesh.rfnn_backward_plain(*inputs, v, u, g)
            for got, w in zip(grads, want):
                assert _close(got, w, n)


@pytest.mark.gpu
def test_rfnn_launch_choice_and_gradient_on_card(cuda_device):
    """Inference launches only B3; a gradient launches B4 then B5 once each
    and matches the same gradient on the CPU; B = 0 launches nothing."""
    rng = np.random.default_rng(1)
    plan = t_mesh.clements_plan(8)
    vp0, up0 = _mesh_params(rng, plan, True), _mesh_params(rng, plan, True)
    atten0 = rng.uniform(0.1, 0.9, 8).astype(np.float32)
    x0 = _x(rng, 33, 8)
    grads = {}
    for dev in ("cpu", cuda_device):
        vp = {k: torch.from_numpy(v).to(dev).requires_grad_(True)
              for k, v in vp0.items()}
        up = {k: torch.from_numpy(v).to(dev).requires_grad_(True)
              for k, v in up0.items()}
        atten = torch.from_numpy(atten0).to(dev).requires_grad_(True)
        x = torch.from_numpy(x0).to(dev).requires_grad_(True)
        before = dict(givens_mesh.LAUNCHES)
        with torch.no_grad():
            ops.rfnn_linear(vp, atten, up, x, n=8, hardware=PROTOTYPE)
        y = ops.rfnn_linear(vp, atten, up, x, n=8, scale=1.2,
                            hardware=PROTOTYPE)
        y.sum().backward()
        on_card = dev != "cpu"
        assert {k: givens_mesh.LAUNCHES[k] - before[k]
                for k in ("rfnn_fwd", "rfnn_fwd_res", "rfnn_bwd")} == \
            {"rfnn_fwd": int(on_card), "rfnn_fwd_res": int(on_card),
             "rfnn_bwd": int(on_card)}
        grads[str(dev)] = [t.grad.cpu() for t in (*vp.values(), *up.values(),
                                                  atten, x)]
    for got, want in zip(grads[str(cuda_device)], grads["cpu"]):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    inputs = [t.to(cuda_device) for t in _kernel_inputs(rng, 8, None)]
    empty = torch.zeros(0, 8, dtype=torch.complex64, device=cuda_device)
    before = dict(givens_mesh.LAUNCHES)
    out, v, u = givens_mesh.launch_rfnn(*inputs, empty, save_stages=True)
    dcv, dcu, dg, dx = givens_mesh.launch_rfnn_backward(
        *inputs, v, u, torch.zeros(0, 8, device=cuda_device))
    assert givens_mesh.LAUNCHES == before
    assert out.shape == (0, 8) and dx.shape == (0, 8)
    assert not (dcv.any() or dcu.any() or dg.any())


@pytest.mark.gpu
@pytest.mark.parametrize("n", list(givens_mesh.REG_WIDTHS))
def test_rfnn_backward_register_path_edges_on_card(cuda_device, n):
    """B5's register path at every width and at batches around a warp (31,
    32, 33) and one block (255, 256, 257) and at the training step's 1000:
    against its plain version, bit-identical twice, exact zeros in the wrap
    slots and one kernel a call where one block covers the batch (up to 256
    rows for n <= 16; its own generator)."""
    rng = np.random.default_rng(190 + n)
    inputs = [t.to(cuda_device) for t in _kernel_inputs(
        rng, n, PROTOTYPE, reck=n > 2, zero_gain=True)]
    for b in (1, 31, 32, 33, 255, 256, 257, 1000):
        x = torch.from_numpy(_x(rng, b, n)).to(cuda_device)
        x[::7] = 0
        g = torch.from_numpy(rng.normal(size=(b, n)).astype(np.float32)) \
            .to(cuda_device)
        _, v, u = givens_mesh.launch_rfnn(*inputs, x, save_stages=True)
        grads = givens_mesh.launch_rfnn_backward(*inputs, v, u, g)
        grads2 = givens_mesh.launch_rfnn_backward(*inputs, v, u, g)
        torch.cuda.synchronize()
        for a, c in zip(grads[:3], grads2[:3]):
            assert torch.equal(a, c)
        for got, want in zip(grads, givens_mesh.rfnn_backward_plain(
                *inputs, v, u, g)):
            assert _close(got, want, n)
        for coef, par in ((grads[0], inputs[1]), (grads[1], inputs[3])):
            assert (coef[par == 1, :, -1] == 0).all()
        plan = givens_mesh.rfnn_bwd_plan(b, n, inputs[0].shape[0],
                                         inputs[2].shape[0])
        assert plan["register_path"] == 1
        assert (plan["kernels"] == 1) == (b <= plan["rows"])
        if n <= 16:  # every warp's accumulator fits: 256 rows a block
            assert plan["kernels"] == (1 if b <= 256 else 2)


def _bits(t):
    t = torch.view_as_real(t) if t.is_complex() else t
    return t.contiguous().view(torch.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("n", list(givens_mesh.REG_WIDTHS))
def test_rfnn_forward_register_path_edges_on_card(cuda_device, n):
    """B3/B4's register path at every width and at batches around a warp
    and one block, the main path's 1000 and 4096 and the lane layout's
    switch point, with a Clements and a Reck V (Cv != Cu), zero rows and
    zeros in g1: against the plain version, B3's out B4's bits, and with
    Clements meshes (no slot skipped) out, v and u the general kernel's
    bits; a plan the kernel cannot run raises (its own generator)."""
    rng = np.random.default_rng(200 + n)
    switch = givens_mesh.RFNN_FWD_LANES_BELOW
    for reck in (False, True):
        inputs = [t.to(cuda_device) for t in _kernel_inputs(
            rng, n, PROTOTYPE, reck=reck, zero_gain=True)]
        cv, cu = inputs[0].shape[0], inputs[2].shape[0]
        for b in (1, 31, 32, 33, 255, 256, 257, 1000, 4096, switch - 1,
                  switch):
            x = torch.from_numpy(_x(rng, b, n)).to(cuda_device)
            x[::7] = 0
            before = dict(givens_mesh.LAUNCHES)
            out3 = givens_mesh.launch_rfnn(*inputs, x)
            out4, v, u = givens_mesh.launch_rfnn(*inputs, x, save_stages=True)
            torch.cuda.synchronize()
            for k in ("rfnn_fwd", "rfnn_fwd_res"):
                assert givens_mesh.LAUNCHES[k] == before[k] + 1
            assert torch.equal(_bits(out3), _bits(out4))
            pout, pv, pu = givens_mesh.rfnn_forward_plain(*inputs, x)
            for got, want in ((out3, pout), (v, pv), (u, pu)):
                assert _close(got, want, n)
            plan = givens_mesh.rfnn_fwd_plan(b, n, cv, cu)
            assert plan["register_path"] == 1
            assert plan["lanes"] == (n // 2 if n >= 4 and b < switch else 1)
            if not reck:
                got = givens_mesh.launch_rfnn(
                    *inputs, x, save_stages=True,
                    plan=givens_mesh.rfnn_fwd_general_plan(b, n))
                for a, c in zip((out4, v, u), got):
                    assert torch.equal(_bits(a), _bits(c))
    for bad in (dict(plan, lanes=3), dict(plan, shared_bytes=16),
                dict(plan, register_path=0)):
        with pytest.raises(RuntimeError, match="rfnn_fwd"):
            givens_mesh.launch_rfnn(*inputs, x, plan=bad)
