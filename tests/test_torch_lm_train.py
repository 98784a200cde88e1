"""The port's LM training against the JAX package's.

The reduced configs run in float32 with the JAX package's params (and, for
the train step, its whole ``TrainState``) carried over as numpy, on the same
numpy batches:

* loss and every gradient leaf of the dense, vlm, moe, hybrid and encdec
  families within 1e-4 of the leaf's scale (its largest JAX magnitude);
* ``make_train_step`` for 3 steps at ``accum_steps`` 1 and 2: losses and
  ``grad_norm`` within 1e-4 relative, each leaf's update within 1e-3 of
  3 x lr, except elements whose JAX gradient is under 1e-4 of the leaf's
  largest at some step (AdamW's m / sqrt(v) turns float32 noise in a
  near-zero gradient into a full +-lr step), counted and printed;
* every ``remat`` mode's gradients equal to ``"none"``'s within 1e-6 (the
  port alone: recomputation changes no value);
* the paper's analog MLP (``linear_impl="rfnn"``): loss and gradients of
  the kernel backend within 1e-5 of JAX's reference, with and without
  ``remat="full"``, and the loss falling over 12 train steps;
* the flash kernel B9 is forward-only: a backward through
  ``attn_impl="pallas"`` raises, a ``no_grad`` prefill does not.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import ModelConfig as JModelConfig  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import cosine_schedule as j_cosine  # noqa: E402
from repro.train import step as j_step  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.interop import (params_from_numpy, params_to_numpy,  # noqa: E402
                                 train_state_from_numpy,
                                 train_state_to_numpy)
from repro_torch.models import Model, ModelConfig  # noqa: E402
from repro_torch.optim import AdamW, cosine_schedule  # noqa: E402
from repro_torch.train import (TrainState, init_state,  # noqa: E402
                               loss_and_grads, make_train_step)

jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tests run many small ops: one intra-op thread a test process
    keeps them from spinning against the other test processes' threads
    (the suite runs several workers on shared cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

ARCHS = ["tinyllama-1.1b", "internvl2-2b", "qwen2-moe-a2.7b", "zamba2-1.2b",
         "whisper-large-v3"]
B, S = 2, 32
TOL = 1e-4
LR = 1e-3                    # the schedule's peak (cosine, warmup 2 of 6)
STEPS = 3
RFNN_CFG = dict(name="rfnn-lm", family="dense", n_layers=2, d_model=64,
                n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=97,
                attn_chunk=16, dtype="float32", linear_impl="rfnn",
                rfnn_tile=16)
RFNN_LR = 0.01               # set on this test's CPU run (seed 0)


def _configs(arch, **over):
    return (dataclasses.replace(j_configs.get_reduced(arch), **over),
            dataclasses.replace(t_configs.get_reduced(arch), **over))


def _batch(cfg, b=B, seed=1, s=S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    batch = {"tokens": toks,
             "labels": np.concatenate([toks[:, 1:], -np.ones((b, 1), np.int32)],
                                      axis=1)}
    if cfg.family == "vlm":
        batch["vis_embed"] = rng.normal(
            size=(b, cfg.n_vis_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(
            size=(b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return batch


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _flat(tree):
    """{path: numpy leaf} of a JAX tree (paths as ``keystr``)."""
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tflat(tree):
    return {pytree.keystr(p): v
            for p, v in pytree.tree_flatten_with_path(tree)[0]}


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _port_grads(model, params, batch):
    """(loss, {path: grad}) of the port's ``Model.loss``."""
    grads, loss, _ = loss_and_grads(model.loss, params, _tensors(batch))
    return float(loss), {k: g.numpy() for k, g in _tflat(grads).items()}


def _jax_grads(model, params, batch):
    fn = jax.jit(jax.value_and_grad(lambda p, b: model.loss(p, b)[0]))
    loss, grads = fn(params, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), _flat(grads)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    jcfg, tcfg = _configs(arch, dtype="float32")
    jm, tm = JModel(jcfg), Model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    batch = _batch(jcfg)
    jl, jg = _jax_grads(jm, jp, batch)
    tl, tg = _port_grads(tm, tp, batch)
    assert abs(tl - jl) <= TOL * max(1.0, abs(jl))
    assert set(tg) == set(jg)
    worst = {k: _rel(tg[k], jg[k]) for k in jg}
    assert max(worst.values()) <= TOL, max(worst.items(), key=lambda kv: kv[1])
    # every leaf the loss reaches gets a gradient (the stacked leaves through
    # the Python loop over super-blocks, the hybrid's shared block from each
    # of its invocations)
    assert all(np.abs(jg[k]).max() == 0 or np.abs(tg[k]).max() > 0
               for k in jg)


def _jax_train(jcfg, accum, batches):
    model = JModel(jcfg)
    opt = JAdamW(lr=j_cosine(LR, 2, 6), weight_decay=0.01)
    state = j_step.init_state(model, opt, jax.random.PRNGKey(0))
    step = jax.jit(j_step.make_train_step(model, opt, accum_steps=accum))
    states, metrics = [jax.tree.map(np.asarray, state)], []
    for batch in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        states.append(jax.tree.map(np.asarray, state))
        metrics.append({k: float(v) for k, v in m.items()})
    return states, metrics


def _noisy_elements(states, path):
    """Elements of leaf ``path`` whose JAX gradient is nonzero but under
    1e-4 of the leaf's largest at some step.  The clipped gradient is read
    back from JAX's first moment, g_t = (m_t - b1 m_(t-1)) / (1 - b1); an
    element is zero at step t exactly when both moments only decayed
    (``m_t == fl(b1 m_(t-1))`` and the same for v)."""
    b1, b2 = np.float32(0.9), np.float32(0.95)
    ms = [_flat(s.opt.m)[path] for s in states]
    vs = [_flat(s.opt.v)[path] for s in states]
    noisy = np.zeros(ms[0].shape, bool)
    for t in range(1, len(ms)):
        zero = (ms[t] == ms[t - 1] * b1) & (vs[t] == vs[t - 1] * b2)
        g = np.abs((ms[t].astype(np.float64) - 0.9 * ms[t - 1]) / 0.1)
        noisy |= ~zero & (g < 1e-4 * g.max())
    return noisy


@pytest.mark.parametrize("arch,accum", [("tinyllama-1.1b", 1),
                                        ("tinyllama-1.1b", 2),
                                        ("qwen2-moe-a2.7b", 2)])
def test_train_step_matches_jax(arch, accum):
    """Three AdamW steps from JAX's exact ``TrainState``.  With
    accumulation the MoE's dispatch groups are the micro-batches in both
    packages, so its capacity drops agree."""
    jcfg, tcfg = _configs(arch, dtype="float32")
    batches = [_batch(jcfg, b=4, seed=10 + i) for i in range(STEPS)]
    states, jmetrics = _jax_train(jcfg, accum, batches)
    opt = AdamW(lr=cosine_schedule(LR, 2, 6), weight_decay=0.01)
    train_step = make_train_step(Model(tcfg), opt, accum_steps=accum)
    state = train_state_from_numpy(states[0], "cpu")
    tmetrics = []
    for batch in batches:
        state, m = train_step(state, _tensors(batch))
        tmetrics.append(m)
    expected = {"loss", "grad_norm", "step"} | (
        {"ce", "acc", "moe_aux"} if accum == 1 else set())
    assert set(tmetrics[0]) == expected == set(jmetrics[0])
    for t, (got, want) in enumerate(zip(tmetrics, jmetrics)):
        for k in ("loss", "grad_norm"):
            assert abs(float(got[k]) - want[k]) <= TOL * abs(want[k]), (t, k)
        assert int(got["step"]) == int(want["step"]) == t + 1
    got = train_state_to_numpy(state)
    assert int(got.opt.step) == STEPS
    p0, pj, pt = _flat(states[0].params), _flat(states[-1].params), \
        _tflat(got.params)
    exempt = total = 0
    for path in pj:
        noisy = _noisy_elements(states, path)
        err = np.abs((pt[path] - p0[path]) - (pj[path] - p0[path]))
        assert (err[~noisy] <= 1e-3 * STEPS * LR).all(), (
            path, float(err[~noisy].max()))
        exempt += int(noisy.sum())
        total += noisy.size
    print(f"{arch} accum {accum}: {exempt} of {total} elements exempt")
    assert exempt < 0.01 * total


REMAT_ARCHS = ["tinyllama-1.1b", "qwen2-moe-a2.7b", "zamba2-1.2b",
               "whisper-large-v3"]


@pytest.mark.parametrize("remat", ["full", "outputs", "dots"])
@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_grads_equal_none(arch, remat):
    _, cfg = _configs(arch, dtype="float32")
    params = Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    batch = _batch(cfg)
    want_l, want = _port_grads(Model(cfg), params, batch)
    got_l, got = _port_grads(
        Model(dataclasses.replace(cfg, remat=remat)), params, batch)
    assert got_l == pytest.approx(want_l, rel=1e-6)
    assert max(_rel(got[k], want[k]) for k in want) <= 1e-6


def test_unknown_remat_raises():
    _, cfg = _configs("tinyllama-1.1b", dtype="float32", remat="everything")
    params = Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="remat"):
        Model(cfg).loss(params, _tensors(_batch(cfg)))


def test_rfnn_lm_grads_match_jax_and_train():
    """``tests/test_rfnn_lm.py``'s config and batch shape (B 2, S 16): the
    port's kernel backend (the plain B7/B8 on the CPU), with and without
    ``remat="full"``, against JAX's reference backend within 1e-5 (the JAX
    package's own pallas-vs-reference bound; the port's reference backend is
    held there by ``tests/test_torch_lm.py``); then, as
    ``test_rfnn_lm_trains``, 12 train steps on the same batch lower the
    loss."""
    tcfg = ModelConfig(**RFNN_CFG)
    tp = Model(tcfg).init(torch.Generator().manual_seed(0), device="cpu")
    jp = jax.tree.map(jnp.asarray, params_to_numpy(tp))
    batch = _batch(tcfg, s=16)
    jl, jg = _jax_grads(JModel(JModelConfig(**RFNN_CFG)), jp, batch)
    scale = max(np.abs(g).max() for g in jg.values())
    for remat in ("none", "full"):
        tm = Model(ModelConfig(**RFNN_CFG, rfnn_backend="pallas",
                               remat=remat))
        tl, tg = _port_grads(tm, tp, batch)
        assert abs(tl - jl) <= 1e-5 * abs(jl), remat
        err = max(np.abs(tg[k] - jg[k]).max() for k in jg)
        assert err <= 1e-5 * scale, (remat, err / scale)
        assert np.abs(tg["['blocks']['l0_dense']['mlp']['wi']['u']['theta']"]
                      ).sum() > 0  # the phases receive gradients

    model = Model(ModelConfig(**RFNN_CFG, rfnn_backend="pallas"))
    opt = AdamW(lr=RFNN_LR)
    step = make_train_step(model, opt)
    state = TrainState(params=tp, opt=opt.init(tp))
    tb = _tensors(batch)
    losses = []
    for _ in range(13):
        state, m = step(state, tb)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses


def test_flash_kernel_is_forward_only():
    """B9 has no backward: under autograd ``attn_impl="pallas"`` raises (on
    the CPU too, where its plain version could differentiate), and a
    ``no_grad`` prefill or forward runs."""
    _, cfg = _configs("tinyllama-1.1b", dtype="float32", attn_impl="pallas")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = _tensors(_batch(cfg))
    live = pytree.tree_map(lambda t: t.detach().requires_grad_(True), params)
    with pytest.raises(ValueError, match="forward-only"):
        model.loss(live, batch)
    with pytest.raises(ValueError, match="forward-only"):
        make_train_step(model, AdamW())(init_state(
            model, AdamW(), torch.Generator().manual_seed(0), device="cpu"),
            batch)
    with torch.no_grad():
        logits, _ = model.prefill(live, batch)
        loss, _ = model.loss(live, batch)
    assert torch.isfinite(logits).all() and torch.isfinite(loss)
    # evaluation without grad-requiring inputs needs no no_grad
    assert torch.isfinite(model.loss(params, batch)[0])
