"""The port's LM across ranks: every family under ``use_mesh_and_rules`` on
a (data 2 x model 2) mesh of four CPU ranks, against the single-device port
and the JAX package.

One spawn of four gloo ranks (``tests/_torch_ranks.py``) runs, for dense
(``remat="outputs"``), moe, ssm, hybrid, vlm (``remat="full"``), encdec
and the rfnn LM at reduced size (float32):
the forward logits, a prefill of 8 tokens plus 4 teacher-forced decode
steps (the cache redistributed to the ``decode_32k`` cell's layout: its
positions split over "model"), and one train step (``loss_and_grads`` and ``make_train_step`` with
AdamW), each on params and a batch laid out as DTensors by
``launch/specs.resolve_shardings`` under ``default_rules``, and each beside
the same call on one device.  The params and inputs are JAX's, exported as
numpy.  The test process computes JAX's forward, prefill/decode and
gradients while the ranks run.

Bounds: 1e-5 of each output's largest magnitude (logits) and of each
gradient leaf's largest magnitude, against the single-device port and
against JAX; the loss and the step's gradient norm within 1e-5 relative.
After the AdamW step every rank holds the same params, bit for bit (the
first AdamW step divides each gradient by its own magnitude, so entries
near ``eps`` carry no 1e-5 bound against the single-device step).
"""

import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import Model as JModel  # noqa: E402
from repro.models import ModelConfig as JConfig  # noqa: E402

from _torch_ranks import Ranks  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

TOL = 1e-5
B, S, PREFIX, STEPS, MAX_LEN = 4, 16, 8, 4, 24
BASE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
            vocab_size=96, attn_chunk=16, dtype="float32")
EXTRA = {
    "dense": dict(remat="outputs"),
    "moe": dict(n_experts=4, top_k=2, d_ff_expert=32, n_shared_experts=1,
                d_ff_shared=32, moe_interleave=2, capacity_factor=8.0,
                expert_groups=2),
    "ssm": dict(ssm_state=16, ssm_headdim=16, ssm_chunk=8),
    "hybrid": dict(ssm_state=16, ssm_headdim=16, ssm_chunk=8, attn_every=2),
    "vlm": dict(n_vis_tokens=8, remat="full"),
    "encdec": dict(n_enc_layers=2, enc_seq=24),
    "rfnn": dict(linear_impl="rfnn", rfnn_tile=16),
}
FAMILIES = list(EXTRA)


def cfg_kwargs(name):
    family = "dense" if name == "rfnn" else name
    return dict(name=name, family=family, **BASE, **EXTRA[name])


_BODY = r"""
import contextlib
import pickle

from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.launch import specs
from repro_torch.models import Model, ModelConfig
from repro_torch.optim.adamw import AdamW
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import sharding as sh
from repro_torch.train.step import TrainState, loss_and_grads, make_train_step
from torch.distributed.tensor import DTensor

with open(WORK + "/in.pkl", "rb") as f:
    cases = pickle.load(f)
coll.route_functional_collectives("CPU")   # the card's path, on the host
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
rules = sh.default_rules()
# the decode cells' rules (launch/specs.rules_for): positions over "model"
decode_rules = sh.ShardingRules(rules=dict(rules.rules, kv_seq="model",
                                           kv_heads=None))
B, PREFIX, STEPS, MAX_LEN = 4, 8, 4, 24


def full(t):
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().numpy()


def tree_full(tree):
    if isinstance(tree, dict):
        return {k: tree_full(v) for k, v in tree.items()}
    return full(tree)


def serve(model, params, batch, decode_tokens):
    pre = {k: v[:, :PREFIX] if k in ("tokens", "labels") else v
           for k, v in batch.items()}
    at = PREFIX + (model.cfg.n_vis_tokens if model.cfg.family == "vlm" else 0)
    logits, cache = model.prefill(params, pre, max_len=MAX_LEN)
    out = [full(logits)]
    meshed = sh.active_mesh() is not None
    if meshed:   # the decode cell's cache layout
        cache = specs.distribute(cache, specs.resolve_shardings(
            mesh, decode_rules, model.cache_specs(), cache))
    for i in range(STEPS):
        with (sh.use_mesh_and_rules(mesh, decode_rules) if meshed
              else contextlib.nullcontext()):
            logits, cache = model.decode_step(params, decode_tokens[:, i],
                                              cache, at + i)
        out.append(full(logits))
    return np.stack(out)


results = {}
for name, case in cases.items():
    cfg = ModelConfig(**case["cfg"])
    model = Model(cfg)
    params = params_from_numpy(case["params"], "cpu")
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    dec = torch.from_numpy(case["decode"])
    opt = AdamW(lr=1e-2)
    step = make_train_step(model, opt)
    state = TrainState(params=params, opt=opt.init(params))
    res = {}
    with torch.no_grad():
        res["fwd"] = full(model.forward(params, batch)[0])
        res["serve"] = serve(model, params, batch, dec)
    grads, loss, _ = loss_and_grads(model.loss, params, batch)
    res["loss"], res["grads"] = float(loss), params_to_numpy(grads)
    new, metrics = step(state, batch)
    res["stepped"], res["gnorm"] = params_to_numpy(new.params), float(
        metrics["grad_norm"])

    psh = specs.resolve_shardings(mesh, rules, model.param_specs(), params)
    bsh = {k: v for k, v in specs.batch_shardings(mesh, rules).items()
           if k in batch}
    dparams = specs.distribute(params, psh)
    dbatch = specs.distribute(batch, bsh)
    dstate = TrainState(params=dparams, opt=specs.distribute(
        opt.init(params), specs.resolve_shardings(
            mesh, rules, opt.state_specs(model.param_specs()),
            opt.init(params))))
    with sh.use_mesh_and_rules(mesh, rules):
        with torch.no_grad():
            res["m_fwd"] = full(model.forward(dparams, dbatch)[0])
            res["m_serve"] = serve(model, dparams, dbatch, dec)
        grads, loss, _ = loss_and_grads(model.loss, dparams, dbatch)
        res["m_loss"], res["m_grads"] = float(full(loss)), tree_full(grads)
        new, metrics = step(dstate, dbatch)
        res["m_stepped"] = tree_full(new.params)
        res["m_gnorm"] = float(full(metrics["grad_norm"]))
    results[name] = res
    print(name, "done", flush=True)
results["routed"] = dict(coll.FUNCTIONAL)

with open(f"{WORK}/out{RANK}.pkl", "wb") as f:
    pickle.dump(results, f)
"""


def _inputs(name, rng):
    cfg = JConfig(**cfg_kwargs(name))
    params = jax.tree.map(np.asarray, jax.jit(JModel(cfg).init)(
        jax.random.PRNGKey(0)))
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], -np.ones((B, 1), np.int32)], 1)
    batch = {"tokens": tokens, "labels": labels}
    if cfg.family == "vlm":
        batch["vis_embed"] = rng.normal(
            size=(B, cfg.n_vis_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(
            size=(B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return {"cfg": cfg_kwargs(name), "params": params, "batch": batch,
            "decode": tokens[:, PREFIX:PREFIX + STEPS].copy()}


def _jax_refs(case):
    cfg = JConfig(**case["cfg"])
    model = JModel(cfg)
    params = jax.tree.map(jnp.asarray, case["params"])
    batch = {k: jnp.asarray(v) for k, v in case["batch"].items()}
    ref = {"fwd": np.asarray(jax.jit(model.forward)(params, batch)[0])}
    pre = {k: v[:, :PREFIX] if k in ("tokens", "labels") else v
           for k, v in batch.items()}
    logits, cache = jax.jit(lambda p, b: model.prefill(p, b, max_len=MAX_LEN))(
        params, pre)
    out = [np.asarray(logits)]
    at = PREFIX + (cfg.n_vis_tokens if cfg.family == "vlm" else 0)
    decode = jax.jit(model.decode_step)
    for i in range(STEPS):
        logits, cache = decode(params, jnp.asarray(case["decode"][:, i]),
                               cache, jnp.int32(at + i))
        out.append(np.asarray(logits))
    ref["serve"] = np.stack(out)
    (loss, _), grads = jax.jit(jax.value_and_grad(model.loss, has_aux=True))(
        params, batch)
    ref["loss"] = float(loss)
    ref["grads"] = jax.tree.map(np.asarray, grads)
    return ref


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    rng = np.random.default_rng(0)
    cases = {name: _inputs(name, rng) for name in FAMILIES}
    work = tmp_path_factory.mktemp("lm_sharded")
    with open(work / "in.pkl", "wb") as f:
        pickle.dump(cases, f)
    running = Ranks(work, _BODY, 4, timeout=600.0)
    try:  # JAX's references while the ranks run
        refs = {name: _jax_refs(case) for name, case in cases.items()}
    finally:
        running.join()
    outs = []
    for r in range(4):
        with open(work / f"out{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return refs, outs


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= TOL * scale, f"{what}: {err:.3g} > {TOL} x {scale:.3g}"


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def _close_trees(got, want, what):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys(), what
    for k in want:
        _close(got[k], want[k], f"{what} {k}")


def test_dtensor_collectives_ran_through_the_routed_kernels(ranks):
    """The ranks route DTensor's functional collectives as chip_smoke's
    phase 26 does on gloo's CUDA path; every kind DTensor issued here ran
    through them."""
    _, outs = ranks
    for out in outs:
        routed = out["routed"]
        assert routed.get("all_gather_into_tensor", 0) > 0
        assert routed.get("all_reduce", 0) > 0
        assert routed == outs[0]["routed"]


@pytest.mark.parametrize("family", FAMILIES)
def test_sharded_forward_and_serve_match_single_device_and_jax(ranks,
                                                               family):
    refs, outs = ranks
    ref, res = refs[family], outs[0][family]
    for key in ("fwd", "serve"):
        _close(res[f"m_{key}"], res[key], f"{key} mesh vs one device")
        _close(res[f"m_{key}"], ref[key], f"{key} mesh vs JAX")
    for r in range(1, 4):
        for key in ("m_fwd", "m_serve"):
            assert np.array_equal(outs[r][family][key], res[key]), (r, key)


@pytest.mark.parametrize("family", FAMILIES)
def test_sharded_train_step_matches_single_device_and_jax(ranks, family):
    refs, outs = ranks
    ref, res = refs[family], outs[0][family]
    assert abs(res["m_loss"] - res["loss"]) <= TOL * abs(res["loss"])
    assert abs(res["m_loss"] - ref["loss"]) <= TOL * abs(ref["loss"])
    _close_trees(res["m_grads"], res["grads"], "grads mesh vs one device")
    _close_trees(res["m_grads"], ref["grads"], "grads mesh vs JAX")
    assert abs(res["m_gnorm"] - res["gnorm"]) <= TOL * res["gnorm"]
    for r in range(1, 4):
        got = dict(_leaves(outs[r][family]["m_stepped"]))
        for k, v in _leaves(res["m_stepped"]):
            assert np.array_equal(got[k], v), (r, k)
