"""The port's paper pipelines against the JAX package's.

MNIST RFNN logits at the paper's full width (784 -> 8x8 mesh -> 10), with
params made by the JAX package and exported through
``repro_torch.interop``: rtol and atol 1e-5 (float32 sums in another
order).  The pinned MNIST goldens are not the bar, because the JAX
package's own ``PRNGKey(0)`` params moved with its version (ROADMAP
C-ref1); the 2x2 goldens are, at their own 2e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.hardware import IDEAL as J_IDEAL  # noqa: E402
from repro.paper import mnist_rfnn as j_mnist  # noqa: E402
from repro.paper import rfnn2x2 as j_2x2  # noqa: E402
from repro.paper.prototype import PROTOTYPE as J_PROTOTYPE  # noqa: E402
from repro_torch.core import analog_linear  # noqa: E402
from repro_torch.core.hardware import IDEAL  # noqa: E402
from repro_torch.data.digits import load_digits  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.paper import mnist_rfnn, rfnn2x2  # noqa: E402
from repro_torch.paper.prototype import PROTOTYPE  # noqa: E402
from test_golden import (  # noqa: E402
    _GOLDEN_2X2_MAP,
    _GOLDEN_2X2_MAP_PROTO,
    _2X2_PARAMS,
)

jax.config.update("jax_platform_name", "cpu")

_HW = {None: (None, None), "prototype": (J_PROTOTYPE, PROTOTYPE),
       "ideal": (J_IDEAL, IDEAL)}


@pytest.fixture(scope="module")
def digits():
    _, _, x, y = load_digits(n_train=0, n_test=16, seed=1)
    return x, y


def _jax_params(analog, seed=0):
    model = j_mnist.MnistRFNN(analog=analog)
    return jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("backend", ["kernel", "reference"])
@pytest.mark.parametrize("hw", [None, "prototype"])
def test_mnist_logits_match_jax_full_width(digits, hw, backend):
    jhw, thw = _HW[hw]
    x, _ = digits
    tree = _jax_params(True)
    jm = j_mnist.MnistRFNN(hardware=jhw, quantize="table1",
                           backend="pallas" if backend == "kernel"
                           else "reference")
    tm = mnist_rfnn.MnistRFNN(hardware=thw, quantize="table1", backend=backend)
    assert tm.d_hidden == 8 and tm.mesh.n_cells() == 28
    yj = np.asarray(jm.apply(jax.tree.map(jnp.asarray, tree), jnp.asarray(x)))
    calls = ops.KERNEL_PATH_CALLS["mesh_apply"]
    yt = tm.apply(params_from_numpy(tree, "cpu"), torch.from_numpy(x))
    assert ops.KERNEL_PATH_CALLS["mesh_apply"] == calls + (backend == "kernel")
    assert yt.shape == (16, 10) and torch.isfinite(yt).all()
    np.testing.assert_allclose(yt.numpy(), yj, rtol=1e-5, atol=1e-5)


def test_mnist_digital_baseline_matches_jax(digits):
    x, _ = digits
    tree = _jax_params(False)
    yj = np.asarray(j_mnist.MnistRFNN(analog=False).apply(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x)))
    yt = mnist_rfnn.MnistRFNN(analog=False).apply(
        params_from_numpy(tree, "cpu"), x)
    np.testing.assert_allclose(yt.numpy(), yj, rtol=1e-5, atol=1e-5)


def test_mnist_loss_eval_confusion_match_jax(digits):
    x, y = digits
    tree = _jax_params(True, seed=2)
    jm = j_mnist.MnistRFNN(hardware=J_PROTOTYPE)
    tm = mnist_rfnn.MnistRFNN(hardware=PROTOTYPE)
    pj, pt = jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu")
    nll_j, acc_j = jm.loss(pj, jnp.asarray(x), jnp.asarray(y))
    nll_t, acc_t = tm.loss(pt, x, y)
    assert float(nll_t) == pytest.approx(float(nll_j), rel=1e-5)
    assert float(acc_t) == float(acc_j)
    assert float(mnist_rfnn._eval(tm, pt, x, y)) == float(
        j_mnist._eval(jm, pj, x, y))
    np.testing.assert_array_equal(mnist_rfnn.confusion_matrix(tm, pt, x, y),
                                  j_mnist.confusion_matrix(jm, pj, x, y))


def test_mnist_init_shapes_and_depth_guard():
    m = mnist_rfnn.MnistRFNN()
    p = m.init(torch.Generator().manual_seed(0), device="cpu")
    assert {k: tuple(v.shape) for k, v in p.items() if k != "mesh"} == {
        "w1": (784, 8), "b1": (8,), "w3": (8, 10), "b3": (10,)}
    assert {k: tuple(v.shape) for k, v in p["mesh"].items()} == {
        "theta": (8, 4), "phi": (8, 4), "alpha": (8,)}
    assert "w2" in mnist_rfnn.MnistRFNN(analog=False).init(
        torch.Generator(), device="cpu")
    # analog_depth > 1: the Sec.-V stack on the deep-grid kernels
    deep = mnist_rfnn.MnistRFNN(analog_depth=2)
    assert isinstance(deep.mesh, analog_linear.AnalogSequence)
    layers = deep.init(torch.Generator(), device="cpu")["mesh"]["layers"]
    assert len(layers) == 2 and layers[1]["u"]["theta"].shape == (8, 4)
    assert mnist_rfnn.MnistRFNN(analog=False, analog_depth=2).init(
        torch.Generator(), device="cpu")["w2"].shape == (2, 8, 8)


def test_noisy_backends_agree_draw_for_draw():
    """Kernel and reference backends consume one generator identically."""
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(6, 784)).astype(np.float32))
    params = mnist_rfnn.MnistRFNN().init(torch.Generator().manual_seed(3),
                                         device="cpu")
    out = {}
    for backend in ("kernel", "reference"):
        m = mnist_rfnn.MnistRFNN(hardware=PROTOTYPE, backend=backend)
        out[backend] = m.apply(params, x, torch.Generator().manual_seed(9))
    torch.testing.assert_close(out["kernel"], out["reference"], rtol=1e-5,
                               atol=1e-5)
    clean = mnist_rfnn.MnistRFNN(hardware=PROTOTYPE).apply(params, x)
    assert (clean - out["kernel"]).abs().max() > 1e-6
    with pytest.raises(ValueError):
        analog_linear.AnalogUnitary(n=8, backend="pallas")


# ---------------------------------------------------------------------------
# the 2x2 RFNN
# ---------------------------------------------------------------------------

_T_2X2_PARAMS = {k: np.array(v) for k, v in _2X2_PARAMS.items()}


@pytest.mark.parametrize("backend", ["kernel", "reference"])
@pytest.mark.parametrize("hw,golden", [("ideal", _GOLDEN_2X2_MAP),
                                       ("prototype", _GOLDEN_2X2_MAP_PROTO)])
def test_rfnn2x2_decision_map_goldens(hw, golden, backend):
    net = rfnn2x2.RFNN2x2(hardware=_HW[hw][1], backend=backend, device="cpu")
    calls = ops.KERNEL_PATH_CALLS["mesh_apply"]
    grid, zmap = rfnn2x2.decision_map(net, _T_2X2_PARAMS, 3, 5, lim=30.0, n=5)
    assert ops.KERNEL_PATH_CALLS["mesh_apply"] == calls + (backend == "kernel")
    np.testing.assert_allclose(grid, np.linspace(0.0, 30.0, 5), atol=0)
    np.testing.assert_allclose(zmap, golden, atol=2e-5)


@pytest.mark.parametrize("hw", ["ideal", "prototype"])
def test_rfnn2x2_full_map_and_outputs_match_jax(hw):
    jhw, thw = _HW[hw]
    jnet = j_2x2.RFNN2x2(hardware=jhw)
    tnet = rfnn2x2.RFNN2x2(hardware=thw, device="cpu")
    _, zj = j_2x2.decision_map(jnet, _2X2_PARAMS, 1, 4, lim=30.0, n=41)
    _, zt = rfnn2x2.decision_map(tnet, _T_2X2_PARAMS, 1, 4, lim=30.0, n=41)
    assert zt.shape == (41, 41)
    np.testing.assert_allclose(zt, zj, atol=2e-5)
    x = np.random.default_rng(0).uniform(0, 30, (9, 2)).astype(np.float32)
    for tc, pc in ((0, 0), (2, 5), (5, 3)):
        np.testing.assert_allclose(
            tnet.device_output(tc, pc, x).numpy(),
            np.asarray(jnet.device_output(tc, pc, jnp.asarray(x))),
            rtol=1e-5, atol=1e-6)
    y = (x[:, 0] > x[:, 1]).astype(np.int32)
    assert rfnn2x2.accuracy(tnet, _T_2X2_PARAMS, 2, 5, x, y) == \
        j_2x2.accuracy(jnet, _2X2_PARAMS, 2, 5, x, y)


def test_rfnn2x2_noisy_backends_agree_draw_for_draw():
    x = np.random.default_rng(1).uniform(0, 30, (20, 2)).astype(np.float32)
    out = [rfnn2x2.RFNN2x2(backend=b, device="cpu").device_output(
        2, 4, x, torch.Generator().manual_seed(5))
        for b in ("kernel", "reference")]
    torch.testing.assert_close(out[0], out[1], rtol=1e-5, atol=1e-6)
