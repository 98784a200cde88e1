"""The port's ``repro_torch.parallel`` and ``launch.mesh`` against the JAX
package's ``repro.parallel`` and ``repro.launch.mesh``.

In this process: ``ShardingRules``/``default_rules`` specs (a port spec is a
tuple compared element by element with ``tuple(PartitionSpec)``), the mesh
context, ``tile_grid_shard_specs``, ``bubble_fraction``, and
``make_production_mesh``/``mesh_dp_shards``/``describe`` on 256- and
512-rank meshes over a fake process group.

On CPU ranks (gloo, two spawns started together): four ranks run
``data_parallel`` over ``AnalogSequence(8, depth=2)`` at a ragged 13 rows
(forward and gradients), ``make_sgd_step(mesh=)`` and ``pipeline_forward``
(``tests/test_pipeline.py``'s shapes); two ranks run
``ServingEngine(mesh=)``.  The test process computes the single-device JAX
references (its reference backend) and hands them over as an ``.npz``; the
ranks compute the single-device port beside each sharded result.
Tolerances: JAX's ``tests/test_parallel.py`` and ``tests/test_pipeline.py``
bounds, 1e-5 absolute (1e-6 on the loss); gradients within 1e-5 of the
largest parameter gradient (x's of its own largest), the bound of
``tests/test_torch_deepgrid.py``.
"""

import pickle
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.testing._internal.distributed.fake_pg import FakeStore  # noqa: E402

from repro.core import analog_linear as j_al  # noqa: E402
from repro.launch import mesh as j_launch_mesh  # noqa: E402
from repro.parallel import pipeline as j_pipeline  # noqa: E402
from repro.parallel import sharding as j_sharding  # noqa: E402
from repro.train.step import make_sgd_step as j_make_sgd_step  # noqa: E402
from repro_torch.launch import mesh as t_launch_mesh  # noqa: E402
from repro_torch.parallel import (  # noqa: E402
    ShardingRules,
    active_mesh,
    bubble_fraction,
    default_rules,
    logical_spec,
    set_rules,
    tile_grid_shard_specs,
    use_mesh_and_rules,
)

from _torch_ranks import Ranks  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ATOL = 1e-5
N, DEPTH = 8, 2                      # AnalogSequence(8, depth=2)
B_RAGGED, B_STEP, LR = 13, 16, 0.05  # JAX's data-parallel test
S, M, MB, D = 4, 8, 2, 16            # JAX's pipeline test
ENGINE_REQS = 10                     # served at 4 slots on 2 ranks


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# in this process: rules, specs, the mesh factory
# ---------------------------------------------------------------------------

def _names(multi_pod):
    return sorted(j_sharding.default_rules(multi_pod).rules)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_default_rules_spec_every_name_matches_jax(multi_pod):
    """Every logical name alone, all of them at once (the dedupe), and each
    with ``None`` and an unknown name beside it."""
    jr, tr = j_sharding.default_rules(multi_pod), default_rules(multi_pod)
    assert tr.rules == jr.rules
    for name in _names(multi_pod):
        for names in ((name,), (name, None), (None, name, "unknown")):
            assert tr.spec(*names) == tuple(jr.spec(*names)), names
    every = _names(multi_pod)
    assert tr.spec(*every) == tuple(jr.spec(*every))
    assert tr.spec(*reversed(every)) == tuple(jr.spec(*reversed(every)))


def test_rules_dedupe_cases_match_jax():
    """JAX's three dedupe cases (``tests/test_parallel.py``)."""
    cases = [(False, ("batch", "kv_seq", "kv_heads", "head_dim")),
             (True, ("batch", "experts"))]
    for multi_pod, names in cases:
        assert default_rules(multi_pod).spec(*names) == tuple(
            j_sharding.default_rules(multi_pod).spec(*names))
    spec = default_rules(False).spec("batch", "kv_seq", "kv_heads", "head_dim")
    assert spec[:3] == ("data", None, "model")
    assert default_rules(True).spec("batch", "experts")[1] is None
    only = {"batch": ("data",)}
    assert ShardingRules(rules=only).spec("batch", "nonexistent") == tuple(
        j_sharding.ShardingRules(rules=only).spec("batch", "nonexistent"))


def test_mesh_context_and_logical_spec():
    names = ("batch", "seq", "heads")
    assert logical_spec(*names) == (None, None, None) == tuple(
        j_sharding.logical_spec(*names))
    rules, marker = default_rules(), object()
    with use_mesh_and_rules(marker, rules):
        assert active_mesh() is marker
        assert logical_spec(*names) == rules.spec(*names)
        with use_mesh_and_rules(None, default_rules(True)):
            assert logical_spec("batch") == (("pod", "data"),)
        assert active_mesh() is marker
    assert active_mesh() is None and logical_spec("batch") == (None,)
    set_rules(rules)
    try:
        assert logical_spec("batch") == ("data",)
    finally:
        set_rules(None)


@pytest.mark.parametrize("axes", [("rows", "data"), ("r", "d")])
def test_tile_grid_shard_specs_match_jax(axes):
    got, want = tile_grid_shard_specs(*axes), j_sharding.tile_grid_shard_specs(
        *axes)
    for field in ("coef", "x_plane", "o_plane", "stage", "dx_plane"):
        assert getattr(got, field) == tuple(getattr(want, field)), field


def test_bubble_fraction_matches_jax():
    for stages, micro in ((1, 1), (2, 3), (4, 8), (16, 5)):
        assert bubble_fraction(stages, micro) == j_pipeline.bubble_fraction(
            stages, micro)
    assert abs(bubble_fraction(4, 8) - 3 / 11) < 1e-9


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_matches_jax(multi_pod):
    """256 or 512 ranks on a fake process group; JAX's ``describe`` and
    ``mesh_dp_shards`` read the same axis names and shape."""
    world = 512 if multi_pod else 256
    dist.init_process_group("fake", store=FakeStore(), rank=world - 1,
                            world_size=world)
    try:
        mesh = t_launch_mesh.make_production_mesh(multi_pod=multi_pod,
                                                  device_type="cpu")
        shape = (2, 16, 16) if multi_pod else (16, 16)
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
        assert tuple(mesh.shape) == shape and mesh.mesh_dim_names == axes
        like = types.SimpleNamespace(axis_names=axes,
                                     devices=np.empty(shape, object))
        assert t_launch_mesh.describe(mesh) == j_launch_mesh.describe(like)
        assert t_launch_mesh.mesh_dp_shards(mesh) == \
            j_launch_mesh.mesh_dp_shards(like) == (32 if multi_pod else 16)
        assert mesh.get_local_rank("model") == 15
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# on CPU ranks
# ---------------------------------------------------------------------------

_PARALLEL_BODY = r"""
import pickle

from repro_torch.core.analog_linear import AnalogSequence
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.parallel import data_parallel, pipeline_forward
from repro_torch.train import make_sgd_step


def leaves(tree):
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in leaves(v)]
    return [tree]


inp = np.load(WORK + "/in.npz")
with open(WORK + "/params.pkl", "rb") as f:
    tree = pickle.load(f)
seq = AnalogSequence(n=8, depth=2)
mesh = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("data",))
out = {}

# data_parallel at a ragged batch: forward and gradients
x = torch.from_numpy(inp["x_ragged"])
w = torch.from_numpy(inp["w_ragged"])
dp = data_parallel(lambda p, xx: seq.apply(p, xx), mesh)
for tag, fn in (("dp", dp), ("single", lambda p, xx: seq.apply(p, xx))):
    params = params_from_numpy(tree, "cpu")
    for t in leaves(params):
        t.requires_grad_(True)
    xx = x.clone().requires_grad_(True)
    y = fn(params, xx)
    (y * w).sum().backward()
    out[f"{tag}_y"] = y.detach().numpy()
    for j, t in enumerate(leaves(params) + [xx]):
        out[f"{tag}_g{j}"] = t.grad.numpy()
with torch.no_grad():
    out["dp_nograd_y"] = dp(params_from_numpy(tree, "cpu"), x).numpy()


# make_sgd_step over the data axis; the third argument is replicated
def loss_fn(p, xx, yy, weight):
    loss = weight * ((seq.apply(p, xx) - yy) ** 2).mean()
    return loss, loss


xb, yb = torch.from_numpy(inp["x_step"]), torch.from_numpy(inp["y_step"])
one = torch.tensor(1.0)
for tag, step in (("sgd_dp", make_sgd_step(loss_fn, lr=0.05, mesh=mesh,
                                           replicated_args=(2,))),
                  ("sgd_single", make_sgd_step(loss_fn, lr=0.05))):
    new, (loss, _) = step(params_from_numpy(tree, "cpu"), xb, yb, one)
    out[f"{tag}_loss"] = loss.numpy()
    for j, t in enumerate(leaves(params_to_numpy(new))):
        out[f"{tag}_p{j}"] = t
step = make_sgd_step(loss_fn, lr=0.05, mesh=mesh, replicated_args=(2,))
try:
    step(params_from_numpy(tree, "cpu"), xb[:13], yb[:13], one)
    out["sgd_ragged_refused"] = np.array(False)
except ValueError:
    out["sgd_ragged_refused"] = np.array(True)

# the pipeline: stage s holds w[s]
stage = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("stage",))
pw = {"w": torch.from_numpy(inp["pipe_w"])}
px = torch.from_numpy(inp["pipe_x"])
out["pipe_y"] = pipeline_forward(lambda p, h: torch.tanh(h @ p["w"]), stage,
                                 "stage", pw, px).numpy()
h = px
for s in range(WORLD):
    h = torch.tanh(h @ pw["w"][s])
out["pipe_single"] = h.numpy()
np.savez(f"{WORK}/out{RANK}.npz", **out)
"""

_ENGINE_BODY = r"""
import pickle

from repro_torch.core.analog_linear import AnalogSequence
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.serving import Request, ServingEngine

inp = np.load(WORK + "/in.npz")
with open(WORK + "/params.pkl", "rb") as f:
    tree = pickle.load(f)
seq = AnalogSequence(n=8, depth=2)
params = params_from_numpy(tree, "cpu")
mesh = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("data",))
feats = inp["features"]
engine = ServingEngine(seq, params, slots=4, device="cpu", mesh=mesh)
reqs = [Request(i, features=f) for i, f in enumerate(feats)]
for r in reqs:
    assert engine.submit(r)
assert engine.tick() == 4
packs = dict(ops.PACK_EVENTS)
engine.run()
out = {"served": np.stack([r.result for r in reqs]),
       "done": np.array([r.done and not r.failed for r in reqs]),
       "completed": np.array([r.completed_tick for r in reqs]),
       "packs_flat": np.array(ops.PACK_EVENTS == packs)}
with torch.no_grad():
    out["single"] = seq.apply(params, torch.from_numpy(feats)).numpy()
np.savez(f"{WORK}/out{RANK}.npz", **out)
"""


def _j_loss(seq):
    def loss_fn(p, xx, yy, weight):
        loss = weight * jnp.mean((seq.apply(p, xx) - yy) ** 2)
        return loss, loss
    return loss_fn


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both spawns' outputs (four ranks, two ranks) and JAX's references."""
    jseq = j_al.AnalogSequence(n=N, depth=DEPTH)
    tree = jax.tree.map(np.asarray, jseq.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    inp = {"x_ragged": rng.normal(size=(B_RAGGED, N)).astype(np.float32),
           "w_ragged": rng.normal(size=(B_RAGGED, N)).astype(np.float32),
           "x_step": rng.normal(size=(B_STEP, N)).astype(np.float32),
           "y_step": (rng.normal(size=(B_STEP, N)) ** 2).astype(np.float32),
           "pipe_w": (rng.normal(size=(S, D, D)) / np.sqrt(D)).astype(
               np.float32),
           "pipe_x": rng.normal(size=(M, MB, D)).astype(np.float32)}
    feats = rng.normal(size=(ENGINE_REQS, N)).astype(np.float32)
    works = {}
    for name, arrays in (("parallel", inp), ("engine", {"features": feats})):
        works[name] = tmp_path_factory.mktemp(f"sharding_{name}")
        np.savez(works[name] / "in.npz", **arrays)
        with open(works[name] / "params.pkl", "wb") as f:
            pickle.dump(tree, f)
    running = [Ranks(works["parallel"], _PARALLEL_BODY, S),
               Ranks(works["engine"], _ENGINE_BODY, 2)]
    try:  # JAX's references while the ranks run
        params = jax.tree.map(jnp.asarray, tree)
        ref = {"dp_y": np.asarray(jseq.apply(params, inp["x_ragged"]))}
        new, (loss, _) = j_make_sgd_step(_j_loss(jseq), lr=LR)(
            params, inp["x_step"], inp["y_step"], 1.0)
        ref["sgd_loss"] = float(loss)
        ref["sgd_params"] = [np.asarray(a) for a in jax.tree.leaves(new)]
        h = jnp.asarray(inp["pipe_x"])
        for s in range(S):
            h = jnp.tanh(h @ inp["pipe_w"][s])
        ref["pipe_y"] = np.asarray(h)
        ref["engine_y"] = np.asarray(jseq.apply(params, feats))
    finally:
        for r in running:
            r.join()
    outs = {name: [dict(np.load(works[name] / f"out{r}.npz"))
                   for r in range(world)]
            for name, world in (("parallel", S), ("engine", 2))}
    return ref, outs


def test_data_parallel_matches_single_device_and_jax(ranks):
    """13 rows on 4 ranks (zero-padded to 16): the output within 1e-5 of
    the single-device port and of JAX on every rank; the gradients whole on
    every rank: each layer's params within 1e-5 of the single-device port's
    largest parameter gradient, x's within 1e-5 of its largest."""
    ref, outs = ranks
    for out in outs["parallel"]:
        assert out["dp_y"].shape == (B_RAGGED, N)
        np.testing.assert_allclose(out["dp_y"], out["single_y"], rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(out["dp_y"], ref["dp_y"], rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(out["dp_nograd_y"], out["dp_y"], rtol=0,
                                   atol=0)
        n = len([k for k in out if k.startswith("single_g")])
        assert len([k for k in out if k.startswith("dp_g")]) == n > DEPTH
        got = [out[f"dp_g{j}"] for j in range(n)]
        want = [out[f"single_g{j}"] for j in range(n)]
        scale = max(float(np.abs(g).max()) for g in want[:-1])
        for a, b in zip(got[:-1], want[:-1]):
            assert a.shape == b.shape
            assert float(np.abs(a - b).max()) <= ATOL * scale
        assert float(np.abs(got[-1] - want[-1]).max()) <= ATOL * float(
            np.abs(want[-1]).max())


def test_sgd_step_over_the_data_axis_matches_single_device_and_jax(ranks):
    """One data-parallel step at 16 rows on 4 ranks: params within 1e-5
    and the loss within 1e-6 of the single-device port's and of JAX's on
    every rank; a batch that does not split over the axis is refused."""
    ref, outs = ranks
    for out in outs["parallel"]:
        n = len(ref["sgd_params"])
        assert len([k for k in out if k.startswith("sgd_dp_p")]) == n
        for j, want in enumerate(ref["sgd_params"]):
            got = out[f"sgd_dp_p{j}"]
            np.testing.assert_allclose(got, out[f"sgd_single_p{j}"], rtol=0,
                                       atol=ATOL)
            np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
        assert abs(float(out["sgd_dp_loss"]) - ref["sgd_loss"]) <= 1e-6
        assert abs(float(out["sgd_dp_loss"])
                   - float(out["sgd_single_loss"])) <= 1e-6
        assert bool(out["sgd_ragged_refused"])


def test_pipeline_forward_matches_sequential_torch_and_jax(ranks):
    """GPipe over 4 stages and 8 microbatches: every rank returns the
    outputs, within 1e-5 of the sequential stages in torch and in JAX."""
    ref, outs = ranks
    for out in outs["parallel"]:
        assert out["pipe_y"].shape == (M, MB, D)
        np.testing.assert_allclose(out["pipe_y"], out["pipe_single"], rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(out["pipe_y"], ref["pipe_y"], rtol=0,
                                   atol=ATOL)


def test_serving_engine_over_the_data_axis(ranks):
    """Ten requests at 4 slots on 2 ranks (ticks of 4, 4 and 2 rows): every
    request served on both ranks, each result within 1e-5 of a direct
    single-device apply and of JAX's, no packing after the first tick."""
    ref, outs = ranks
    for out in outs["engine"]:
        assert out["done"].all()
        assert out["completed"].tolist() == [1] * 4 + [2] * 4 + [3] * 2
        assert bool(out["packs_flat"])
        np.testing.assert_allclose(out["served"], out["single"], rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(out["served"], ref["engine_y"], rtol=0,
                                   atol=ATOL)
