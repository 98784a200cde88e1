"""The port's deep analog models against the JAX package's:
``AnalogSequence``, ``TiledAnalogLinear``, ``MnistRFNN(analog_depth > 1)``
and the params that carry them across (``repro_torch.interop``).

Params are made by the JAX package and exported as numpy; inputs are made
with numpy.  JAX runs its reference backend (the per-layer and per-tile
compositions), the port both of its backends on CPU tensors (the deep grid
through the plain versions of kernels B6/B7/B8).  Noise is compared only on
noise-free paths (IDEAL, or PROTOTYPE without a key): the two packages'
generators differ.  Tolerances: outputs within 1e-5 of their largest
magnitude (float32 sums in another order); gradients and params after SGD
steps within 1e-4 (the bound of ``.claude/skills/verify``).
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import analog_linear as j_al  # noqa: E402
from repro.core.hardware import IDEAL as J_IDEAL  # noqa: E402
from repro.paper import mnist_rfnn as j_mnist  # noqa: E402
from repro.paper.prototype import PROTOTYPE as J_PROTOTYPE  # noqa: E402
from repro.train.step import make_sgd_step as j_make_sgd_step  # noqa: E402
from repro_torch.core import analog_linear as t_al  # noqa: E402
from repro_torch.core.hardware import IDEAL  # noqa: E402
from repro_torch.data.digits import load_digits  # noqa: E402
from repro_torch.interop import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.paper import mnist_rfnn  # noqa: E402
from repro_torch.paper.prototype import PROTOTYPE  # noqa: E402
from repro_torch.train import make_sgd_step  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

_HW = {"ideal": (J_IDEAL, IDEAL), "prototype": (J_PROTOTYPE, PROTOTYPE)}


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


def _trees_close(t_tree, j_tree, atol):
    t_np, j_np = params_to_numpy(t_tree), jax.tree.map(np.asarray, j_tree)
    assert jax.tree.structure(t_np) == jax.tree.structure(j_np)
    for a, b in zip(jax.tree.leaves(t_np), jax.tree.leaves(j_np)):
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)


def _features(rng, b, d, complex_=False):
    x = rng.normal(size=(b, d))
    if complex_:
        x = x + 1j * rng.normal(size=(b, d))
    return x.astype(np.complex64 if complex_ else np.float32)


# ---------------------------------------------------------------------------
# AnalogSequence
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantize", [None, "table1"])
@pytest.mark.parametrize("output", ["abs", "real", "complex"])
@pytest.mark.parametrize("hw", ["ideal", "prototype"])
def test_analog_sequence_matches_jax(quantize, output, hw):
    jhw, thw = _HW[hw]
    jm = j_al.AnalogSequence(n=4, depth=3, quantize=quantize, hardware=jhw,
                             output=output)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(2)))
    x = _features(np.random.default_rng(1), 6, 4, complex_=True)
    want = np.asarray(jm.apply(jax.tree.map(jnp.asarray, tree),
                               jnp.asarray(x)))
    params = params_from_numpy(tree, "cpu")
    assert isinstance(params["layers"], tuple) and len(params["layers"]) == 3
    calls = ops.KERNEL_PATH_CALLS["rfnn_network"]
    for backend in ("kernel", "reference"):
        tm = t_al.AnalogSequence(n=4, depth=3, quantize=quantize,
                                 hardware=thw, output=output, backend=backend)
        _close(tm.apply(params, torch.from_numpy(x)).numpy(), want)
    assert ops.KERNEL_PATH_CALLS["rfnn_network"] == calls + 1


def test_analog_sequence_backends_agree_draw_for_draw():
    """Under PROTOTYPE noise both backends draw, layer by layer, V's phase
    noise, U's, then the detector's, from one generator."""
    tm = t_al.AnalogSequence(n=4, depth=3, hardware=PROTOTYPE)
    params = tm.init(torch.Generator().manual_seed(0), device="cpu")
    x = torch.from_numpy(_features(np.random.default_rng(0), 5, 4))
    out = {}
    for backend in ("kernel", "reference"):
        m = t_al.AnalogSequence(n=4, depth=3, hardware=PROTOTYPE,
                                backend=backend)
        gen = torch.Generator().manual_seed(9)
        out[backend] = m.apply(params, x, generator=gen)
        out[backend + "_next"] = torch.randn(3, generator=gen)
    torch.testing.assert_close(out["kernel"], out["reference"], rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(out["kernel_next"], out["reference_next"])
    clean = tm.apply(params, x)
    assert (clean - out["kernel"]).abs().max() > 1e-6
    with pytest.raises(ValueError, match="depth"):
        t_al.AnalogSequence(n=4, depth=0)


def test_analog_sequence_gradients_match_jax():
    """Gradients of a weighted sum of the outputs in every layer's params,
    through the deep grid's plain B7/B8 (Table-I STE phases): within 1e-4."""
    jm = j_al.AnalogSequence(n=4, depth=3, quantize="table1")
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(5)))
    rng = np.random.default_rng(5)
    x, w = _features(rng, 7, 4), rng.normal(size=(7, 4)).astype(np.float32)
    g_j = jax.grad(lambda p: jnp.sum(jm.apply(p, jnp.asarray(x)) * w))(
        jax.tree.map(jnp.asarray, tree))
    tm = t_al.AnalogSequence(n=4, depth=3, quantize="table1")
    step = make_sgd_step(lambda p: ((tm.apply(p, torch.from_numpy(x))
                                     * torch.from_numpy(w)).sum(),) * 2, lr=1.0)
    params = params_from_numpy(tree, "cpu")
    new, _ = step(params)
    g_t = jax.tree.map(lambda a, b: a - b, params_to_numpy(params),
                       params_to_numpy(new))
    _trees_close(params_from_numpy(g_t), g_j, atol=1e-4)


# ---------------------------------------------------------------------------
# TiledAnalogLinear
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantize", [None, "table1"])
@pytest.mark.parametrize("output", ["abs", "real", "complex"])
@pytest.mark.parametrize("hw", ["ideal", "prototype"])
def test_tiled_analog_linear_matches_jax(quantize, output, hw):
    jhw, thw = _HW[hw]
    jm = j_al.TiledAnalogLinear(in_dim=12, out_dim=8, tile_size=4,
                                quantize=quantize, hardware=jhw, output=output)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(3)))
    x = _features(np.random.default_rng(3), 5, 12)
    want = np.asarray(jm.apply(jax.tree.map(jnp.asarray, tree),
                               jnp.asarray(x)))
    params = params_from_numpy(tree, "cpu")
    assert params["u"]["theta"].shape[:2] == (2, 3)
    calls = ops.KERNEL_PATH_CALLS["tiled_apply"]
    for backend in ("kernel", "reference"):
        tm = t_al.TiledAnalogLinear(in_dim=12, out_dim=8, tile_size=4,
                                    quantize=quantize, hardware=thw,
                                    output=output, backend=backend)
        _close(tm.apply(params, torch.from_numpy(x)).numpy(), want)
    assert ops.KERNEL_PATH_CALLS["tiled_apply"] == calls + 1


def test_tiled_analog_linear_sgd_steps_match_jax():
    """Three SGD steps of a toy regression through the tile grid's plain
    B7/B8: params within 1e-4 of the JAX package's (pallas backend)."""
    jm = j_al.TiledAnalogLinear(in_dim=8, out_dim=8, tile_size=4,
                                output="abs", backend="pallas")
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(7)))
    rng = np.random.default_rng(7)
    x, y = _features(rng, 6, 8), np.abs(rng.normal(size=(6, 8))).astype(
        np.float32)

    def j_loss(p, xx, yy):
        loss = jnp.mean((jm.apply(p, xx) - yy) ** 2)
        return loss, loss

    j_step = j_make_sgd_step(j_loss, lr=0.3)
    pj = jax.tree.map(jnp.asarray, tree)
    for _ in range(3):
        pj, _ = j_step(pj, jnp.asarray(x), jnp.asarray(y))
    tm = t_al.TiledAnalogLinear(in_dim=8, out_dim=8, tile_size=4,
                                output="abs")

    def t_loss(p, xx, yy):
        loss = ((tm.apply(p, xx) - yy) ** 2).mean()
        return loss, loss

    t_step = make_sgd_step(t_loss, lr=0.3)
    pt = params_from_numpy(tree, "cpu")
    packs = ops.PACK_EVENTS["tiled_apply"]
    for _ in range(3):
        pt, _ = t_step(pt, torch.from_numpy(x), torch.from_numpy(y))
    assert ops.PACK_EVENTS["tiled_apply"] == packs + 3  # grad: never cached
    _trees_close(pt, pj, atol=1e-4)


def test_tiled_analog_linear_init_order_and_validation():
    """Tiles are drawn row by row, each as AnalogLinear.init, and stacked."""
    tm = t_al.TiledAnalogLinear(in_dim=8, out_dim=4, tile_size=4)
    p = tm.init(torch.Generator().manual_seed(4), device="cpu")
    g = torch.Generator().manual_seed(4)
    first, second = (tm.tile.init(g, device="cpu") for _ in range(2))
    assert p["u"]["theta"].shape == (1, 2) + first["u"]["theta"].shape
    assert torch.equal(p["atten_logit"][0, 1], second["atten_logit"])
    assert torch.equal(p["v"]["phi"][0, 0], first["v"]["phi"])
    assert tm.n_cells() == 2 * tm.tile.n_cells()
    with pytest.raises(ValueError, match="multiples"):
        t_al.TiledAnalogLinear(in_dim=6, out_dim=4, tile_size=4)
    with pytest.raises(ValueError, match="even"):
        t_al.TiledAnalogLinear(in_dim=6, out_dim=6, tile_size=3)


# ---------------------------------------------------------------------------
# MnistRFNN(analog_depth > 1)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def digits():
    x, y, _, _ = load_digits(n_train=40, n_test=0, seed=2)
    return x, y


@pytest.mark.parametrize("analog", [True, False])
def test_mnist_depth3_logits_match_jax(digits, analog):
    """Logits of the Sec.-V multi-layer network (analog, Table-I phases,
    PROTOTYPE cells) and of its digital twin from exported params."""
    x, _ = digits
    jm = j_mnist.MnistRFNN(analog=analog, hardware=J_PROTOTYPE,
                           analog_depth=3)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    want = np.asarray(jm.apply(jax.tree.map(jnp.asarray, tree),
                               jnp.asarray(x)))
    tm = mnist_rfnn.MnistRFNN(analog=analog, hardware=PROTOTYPE,
                              analog_depth=3)
    assert isinstance(tm.mesh, t_al.AnalogSequence)
    got = tm.apply(params_from_numpy(tree, "cpu"), x).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_mnist_depth3_sgd_steps_match_jax(digits):
    """Five STE SGD steps (batch 10, Table-I phases) from the JAX package's
    params: params and losses within 1e-4."""
    x, y = digits
    jm = j_mnist.MnistRFNN(hardware=None, quantize="table1", analog_depth=3)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1)))
    j_step = j_make_sgd_step(lambda p, xi, yi: jm.loss(p, xi, yi), lr=0.05)
    tm = mnist_rfnn.MnistRFNN(hardware=None, quantize="table1",
                              analog_depth=3)
    t_step = make_sgd_step(tm.loss, lr=0.05)
    pj, pt = jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu")
    for i in range(5):
        rows = slice(10 * (i % 4), 10 * (i % 4) + 10)
        xb, yb = x[rows], y[rows]
        pj, (lj, _) = j_step(pj, jnp.asarray(xb), jnp.asarray(yb))
        pt, (lt, _) = t_step(pt, torch.from_numpy(xb), torch.from_numpy(yb))
        assert abs(float(lt) - float(lj)) <= 1e-4
    _trees_close(pt, pj, atol=1e-4)


def test_mnist_depth_algorithm1_warns_and_trains_ste(digits):
    x, y = digits
    with pytest.warns(UserWarning, match="algorithm1"):
        res = mnist_rfnn.train_mnist(x, y, x[:10], y[:10], analog_depth=2,
                                     schedule="algorithm1", epochs=1,
                                     batch=10, log_every=1, device="cpu")
    assert res["model"].analog_depth == 2
    assert len(res["params"]["mesh"]["layers"]) == 2
    assert len(res["history"]) == 1 and np.isfinite(res["history"][0]["loss"])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        mnist_rfnn.train_mnist(x, y, x[:10], y[:10], analog_depth=2,
                               schedule="ste", epochs=1, batch=20,
                               device="cpu")


# ---------------------------------------------------------------------------
# interop
# ---------------------------------------------------------------------------

def test_interop_carries_tuples_and_lists():
    """An AnalogSequence params tree exported from JAX round-trips exactly,
    tuples kept; lists stay lists."""
    jm = j_al.AnalogSequence(n=4, depth=2)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    params = params_from_numpy(tree, "cpu")
    assert type(params["layers"]) is tuple
    assert params["layers"][1]["u"]["theta"].dtype == torch.float32
    back = params_to_numpy(params)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    mixed = params_from_numpy({"a": [np.ones(2, np.float64), (np.int32(3),)]})
    assert type(mixed["a"]) is list and type(mixed["a"][1]) is tuple
    assert mixed["a"][0].dtype == torch.float32
    assert params_to_numpy(mixed)["a"][1][0] == 3
