"""The port's training path against the JAX package's.

Inputs and initial params are made with numpy or by the JAX package and
handed to both packages as numpy arrays; random draws that differ between
the packages' generators (DSPSA perturbations, the 2x2 post-processing's
first draw) are fed from the JAX side.  The port runs on CPU tensors, so
every mesh goes through the plain versions of kernels B1 and B2.

Tolerances: 1e-4 on params after SGD steps (the JAX package's own bound
between its kernel and reference backends, ``tests/test_kernel_grads.py``);
1e-5 for the 2x2 post-processing after its Adam loop; exact integer codes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _propcheck import given, settings, strategies as st  # noqa: E402
from repro.core import activations as j_act  # noqa: E402
from repro.core import dspsa as j_dspsa  # noqa: E402
from repro.data.toys import make_toy_dataset  # noqa: E402
from repro.paper import mnist_rfnn as j_mnist  # noqa: E402
from repro.paper import rfnn2x2 as j_2x2  # noqa: E402
from repro.paper.prototype import PROTOTYPE as J_PROTOTYPE  # noqa: E402
from repro.train.step import make_sgd_step as j_make_sgd_step  # noqa: E402
from repro_torch.core import activations, dspsa  # noqa: E402
from repro_torch.data.digits import load_digits  # noqa: E402
from repro_torch.interop import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.kernels import givens_mesh  # noqa: E402
from repro_torch.paper import mnist_rfnn, rfnn2x2  # noqa: E402
from repro_torch.paper.prototype import PROTOTYPE  # noqa: E402
from repro_torch.train import make_sgd_step  # noqa: E402

jax.config.update("jax_platform_name", "cpu")


def _assert_trees_close(t_tree, j_tree, atol):
    t_np, j_np = params_to_numpy(t_tree), jax.tree.map(np.asarray, j_tree)
    assert jax.tree.structure(t_np) == jax.tree.structure(j_np)
    for a, b in zip(jax.tree.leaves(t_np), jax.tree.leaves(j_np)):
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(j_act.ACTIVATIONS))
def test_activations_match_jax(name):
    x = np.random.default_rng(0).normal(size=(4, 6)).astype(np.float32) * 3
    yj = np.asarray(j_act.get_activation(name)(jnp.asarray(x)))
    yt = activations.get_activation(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(yt, yj, rtol=1e-6, atol=1e-6)


def test_activation_helpers_and_unknown_name():
    x = torch.tensor([[-2.0, 0.5], [1.0, -0.25]])
    torch.testing.assert_close(activations.leaky_relu(x, 0.1),
                               torch.where(x > 0, x, 0.1 * x))
    torch.testing.assert_close(activations.softmax(x, axis=0).sum(0),
                               torch.ones(2))
    assert torch.equal(activations.abs_detect(torch.tensor([3 + 4j])),
                       torch.tensor([5.0]))
    with pytest.raises(KeyError, match="unknown activation"):
        activations.get_activation("swish")


# ---------------------------------------------------------------------------
# make_sgd_step
# ---------------------------------------------------------------------------

def _sgd_batch():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(10, 784)).astype(np.float32) * 0.1,
            np.arange(10) % 10)


@pytest.mark.parametrize("freeze", [(), ("mesh",)])
@pytest.mark.parametrize("backend", ["kernel", "reference"])
def test_sgd_steps_match_jax(backend, freeze):
    """Three SGD steps of the Table-I quantized MNIST RFNN (STE phases)
    from the JAX package's params: params within 1e-4."""
    x, y = _sgd_batch()
    jm = j_mnist.MnistRFNN(hardware=None, quantize="table1")
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1)))
    j_step = j_make_sgd_step(lambda p, xi, yi: jm.loss(p, xi, yi), lr=0.05,
                             freeze=freeze)
    pj = jax.tree.map(jnp.asarray, tree)
    for _ in range(3):
        pj, (lj, _) = j_step(pj, jnp.asarray(x), jnp.asarray(y))

    tm = mnist_rfnn.MnistRFNN(hardware=None, quantize="table1",
                              backend=backend)
    t_step = make_sgd_step(lambda p, xi, yi: tm.loss(p, xi, yi), lr=0.05,
                           freeze=freeze)
    pt = params_from_numpy(tree, "cpu")
    before = givens_mesh.LAUNCHES["mesh_bwd"]
    for _ in range(3):
        pt, (lt, at) = t_step(pt, torch.from_numpy(x), torch.from_numpy(y))
    assert givens_mesh.LAUNCHES["mesh_bwd"] == before  # CPU: plain version
    assert lt.dim() == 0 and not lt.requires_grad and at.dim() == 0
    np.testing.assert_allclose(float(lt), float(lj), atol=1e-4)
    _assert_trees_close(pt, pj, atol=1e-4)
    if freeze:
        for k, v in pt["mesh"].items():
            np.testing.assert_array_equal(v.numpy(), tree["mesh"][k])


def test_sgd_step_is_functional():
    """The step returns new params and leaves its input untouched."""
    x, y = _sgd_batch()
    tm = mnist_rfnn.MnistRFNN(hardware=None, quantize=None)
    p0 = tm.init(torch.Generator().manual_seed(0), device="cpu")
    copy = {k: (v.clone() if torch.is_tensor(v) else
                {kk: vv.clone() for kk, vv in v.items()})
            for k, v in p0.items()}
    step = make_sgd_step(lambda p, xi, yi: tm.loss(p, xi, yi), lr=0.1)
    p1, (loss, _) = step(p0, torch.from_numpy(x), torch.from_numpy(y))
    _assert_trees_close(p0, params_to_numpy(copy), atol=0)
    assert not torch.equal(p1["w1"], p0["w1"])
    assert not torch.equal(p1["mesh"]["theta"], p0["mesh"]["theta"])
    assert all(not v.requires_grad for v in p1.values() if torch.is_tensor(v))
    _, (loss2, _) = step(p1, torch.from_numpy(x), torch.from_numpy(y))
    assert float(loss2) < float(loss)


# ---------------------------------------------------------------------------
# the MNIST training loop (Algorithm I's SGD epochs)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def digits200():
    return load_digits(n_train=200, n_test=50, seed=3)


@pytest.mark.parametrize("freeze", [(), ("mesh",)])
def test_train_loop_epoch_matches_jax(digits200, freeze):
    """One epoch (20 steps at the paper's batch 10 and lr 0.005) on the
    PROTOTYPE device with continuous phases, the same minibatch order on
    both sides: params within 1e-4, logged loss within 1e-5."""
    x_tr, y_tr, x_te, y_te = digits200
    jm = j_mnist.MnistRFNN(hardware=J_PROTOTYPE, quantize=None,
                           backend="reference")
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(4)))
    kw = dict(epochs=1, batch=10, lr=0.005, seed=7, log_every=1,
              noisy_train=False, freeze=freeze)
    rj = j_mnist._train_loop(jm, jax.tree.map(jnp.asarray, tree), x_tr, y_tr,
                             x_te, y_te, **kw)
    tm = mnist_rfnn.MnistRFNN(hardware=PROTOTYPE, quantize=None)
    rt = mnist_rfnn._train_loop(tm, params_from_numpy(tree, "cpu"), x_tr,
                                y_tr, x_te, y_te, **kw)
    _assert_trees_close(rt["params"], rj["params"], atol=1e-4)
    assert len(rt["history"]) == len(rj["history"]) == 1
    assert rt["history"][0]["loss"] == pytest.approx(
        rj["history"][0]["loss"], abs=1e-5)
    assert rt["history"][0]["train_acc"] == pytest.approx(
        rj["history"][0]["train_acc"], abs=1e-6)
    assert rt["test_acc"] == pytest.approx(rj["test_acc"], abs=1e-6)


def test_train_mnist_algorithm1_runs_both_stages(digits200):
    """The two-stage schedule on the CPU: stage-1 history, three stage-2
    rounds, deployed mesh phases on the Table-I codebook."""
    x_tr, y_tr, x_te, y_te = digits200
    res = mnist_rfnn.train_mnist(x_tr[:100], y_tr[:100], x_te, y_te,
                                 epochs=3, log_every=1, device="cpu")
    assert [h["epoch"] for h in res["history"]] == [1, 2, 1, 1, 1]
    assert all(np.isfinite(h["loss"]) for h in res["history"])
    assert res["history"][1]["loss"] < res["history"][0]["loss"]
    cb = torch.as_tensor(rfnn2x2.TABLE_I_PHASES_RAD, dtype=torch.float32)
    for k in ("theta", "phi"):
        assert torch.isin(res["params"]["mesh"][k], cb).all()
    assert 0.0 <= res["test_acc"] <= 1.0
    with pytest.raises(NotImplementedError, match="A7"):
        mnist_rfnn.train_mnist(x_tr, y_tr, x_te, y_te, analog_depth=2,
                               device="cpu")


def test_noisy_epoch_consumes_one_generator_per_epoch(digits200):
    """noisy_train draws hardware noise from a generator seeded with the
    epoch index: two runs agree exactly and differ from the noiseless one."""
    x_tr, y_tr, x_te, y_te = digits200
    tm = mnist_rfnn.MnistRFNN(hardware=PROTOTYPE, quantize=None)
    p0 = tm.init(torch.Generator().manual_seed(0), device="cpu")
    kw = dict(epochs=1, batch=10, lr=0.005, seed=0, log_every=1)
    runs = [mnist_rfnn._train_loop(tm, p0, x_tr[:50], y_tr[:50], x_te, y_te,
                                   noisy_train=noisy, **kw)["params"]["w1"]
            for noisy in (True, True, False)]
    assert torch.equal(runs[0], runs[1])
    assert (runs[0] - runs[2]).abs().max() > 1e-7


# ---------------------------------------------------------------------------
# DSPSA
# ---------------------------------------------------------------------------

def _jax_deltas(key, virtual):
    """The perturbations ``repro.core.dspsa.step`` draws from ``key``."""
    leaves, treedef = jax.tree.flatten(virtual)
    keys = jax.random.split(key, len(leaves))
    return jax.tree.unflatten(treedef, [
        np.asarray(jax.random.rademacher(k, l.shape, jnp.float32))
        for k, l in zip(keys, leaves)])


@pytest.mark.parametrize("start", [0, 3])
def test_dspsa_step_with_jax_deltas_matches_jax(start):
    rng = np.random.default_rng(start)
    codes = {"theta": rng.integers(0, 6, (8, 4)).astype(np.int32),
             "phi": rng.integers(0, 6, (8, 4)).astype(np.int32)}
    # integer targets: the losses are exact in float32 on both sides, so
    # the step's arithmetic is compared, not two orders of summation
    target = {k: rng.integers(0, 6, (8, 4)).astype(np.float32) for k in codes}

    def j_loss(c):
        return sum(jnp.sum((c[k] - target[k]) ** 2) for k in c)

    def t_loss(c):
        return sum(((c[k].float() - torch.from_numpy(target[k])) ** 2).sum()
                   for k in c)

    cfg_j, cfg_t = j_dspsa.DSPSAConfig(a=0.8), dspsa.DSPSAConfig(a=0.8)
    sj = j_dspsa.init(jax.tree.map(jnp.asarray, codes))
    sj.step = start
    st_ = dspsa.init({k: torch.from_numpy(v) for k, v in codes.items()})
    st_.step = start
    for i in range(3):
        key = jax.random.PRNGKey(10 + i)
        deltas = _jax_deltas(key, sj.virtual)
        sj, yj = j_dspsa.step(key, sj, j_loss, cfg_j)
        st_, yt = dspsa.step_with_deltas(
            st_, {k: torch.tensor(v) for k, v in deltas.items()}, t_loss,
            cfg_t)
        assert st_.step == sj.step
        assert float(yt) == float(yj)
        for k in codes:
            np.testing.assert_allclose(st_.virtual[k].numpy(),
                                       np.asarray(sj.virtual[k]), rtol=0,
                                       atol=1e-6)
        pj, pt = j_dspsa.project(sj, cfg_j), dspsa.project(st_, cfg_t)
        for k in codes:
            np.testing.assert_array_equal(pt[k].numpy(), np.asarray(pj[k]))


def test_dspsa_draws_and_minimize():
    """Rademacher draws are +-1, shaped like the iterate and reproducible
    from the generator; minimize tracks the best projected codes on a
    separable quadratic."""
    state = dspsa.init({"theta": torch.zeros(5, dtype=torch.int32),
                        "phi": torch.zeros(3, dtype=torch.int32)})
    d1 = dspsa.draw_deltas(torch.Generator().manual_seed(1), state)
    d2 = dspsa.draw_deltas(torch.Generator().manual_seed(1), state)
    assert list(d1) == list(state.virtual)
    for k in d1:
        assert d1[k].shape == state.virtual[k].shape
        assert torch.equal(d1[k], d2[k]) and set(d1[k].tolist()) <= {-1.0, 1.0}
    target = torch.tensor([4.0, 1.0, 3.0, 5.0, 2.0])

    def loss(c):
        return ((c["theta"].float() - target) ** 2).sum()

    codes0 = {"theta": torch.zeros(5, dtype=torch.int32)}
    best, hist = dspsa.minimize(torch.Generator().manual_seed(0), codes0, loss,
                                dspsa.DSPSAConfig(a=1.0), steps=60)
    assert len(hist) == 61 and np.isfinite(hist).all()
    assert float(loss(best)) == min(hist) < hist[0]
    best2, hist2 = dspsa.minimize(torch.Generator().manual_seed(0), codes0,
                                  loss, dspsa.DSPSAConfig(a=1.0), steps=60,
                                  measure_projection=False)
    assert len(hist2) == 60 and best2["theta"].dtype == torch.int32


# ---------------------------------------------------------------------------
# the 2x2 RFNN's training
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corner():
    return make_toy_dataset("corner", n=120, seed=2)


def test_fit_post_matches_jax_adam(corner):
    """The inline Adam loop from JAX's first draw on the same readings."""
    x, y = corner
    jnet = j_2x2.RFNN2x2(hardware=J_PROTOTYPE)
    pj, lj = j_2x2._train_post(jnet, 3, 5, x, y, steps=300, seed=4)
    mag = torch.from_numpy(np.array(jnet.device_output(3, 5, jnp.asarray(x))))
    w0 = np.array(0.1 * jax.random.normal(jax.random.PRNGKey(4), (2,)))
    pt, lt = rfnn2x2._fit_post({"w": torch.from_numpy(w0),
                                "b": torch.zeros(())}, mag, y, steps=300,
                               seed=4)
    _assert_trees_close(pt, pj, atol=1e-5)
    assert lt == pytest.approx(lj, abs=1e-6)


def test_train_rfnn2x2_search_matches_jax(corner, monkeypatch):
    """The exhaustive theta search from JAX's first draw: the same codes and
    post params within 1e-5."""
    x, y = corner
    _, pj, cj, ij = j_2x2.train_rfnn2x2(x, y, method="search", seed=1)
    w0 = np.array(0.1 * jax.random.normal(jax.random.PRNGKey(1), (2,)))
    monkeypatch.setattr(rfnn2x2, "_init_post", lambda seed, device=None: {
        "w": torch.from_numpy(w0).to(device), "b": torch.zeros((),
                                                               device=device)})
    _, pt, ct, it = rfnn2x2.train_rfnn2x2(x, y, method="search", seed=1,
                                          device="cpu")
    assert ct == cj
    _assert_trees_close(pt, pj, atol=1e-5)
    assert it["train_acc"] == pytest.approx(ij["train_acc"], abs=1e-6)


@settings(max_examples=3, deadline=None)
@given(seed=st.integers(0, 1000))
def test_train_rfnn2x2_dspsa_property(seed):
    """DSPSA over (theta, phi) codes: a finite history, the returned codes
    are the best measured, and the trained classifier beats chance."""
    x, y = make_toy_dataset("corner", n=80, seed=seed)
    net, params, codes, info = rfnn2x2.train_rfnn2x2(
        x, y, method="dspsa", steps=120, seed=seed, device="cpu")
    hist = info["dspsa_history"]
    assert len(hist) == 13 and np.isfinite(hist).all()
    assert min(hist) <= hist[0]
    assert 0 <= codes["theta"] < 6 and 0 <= codes["phi"] < 6
    _, best_loss = rfnn2x2._train_post(net, codes["theta"], codes["phi"], x,
                                       y, steps=80, seed=seed)
    assert best_loss == pytest.approx(min(hist), abs=1e-6)
    assert info["train_acc"] > 0.6
