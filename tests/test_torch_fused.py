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
@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("plans", ["clements", "reck"])
def test_rfnn_linear_matches_jax(n, plans):
    """Forward, with and without the screens, ideal and PROTOTYPE cells
    (noiseless): within 1e-5 * n of each output's largest magnitude."""
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
