"""The port's training substrate against the JAX package's.

Learning-rate schedules at steps 0-40; ``TokenStream`` batches bit-equal to
the JAX stream's (fresh instances, resume, host shards); the checkpoint
manager (round trip, async save and its snapshot, ``LATEST``, retention,
structure mismatch, a crash mid-save, each codec, bfloat16 leaves, a whole
``TrainState``, and shards written by the JAX package's manager);
``StragglerMonitor``, ``plan_recovery`` and ``hosts_to_chips`` on the same
inputs as the JAX package's.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro.data import TokenStream as JStream  # noqa: E402
from repro.optim import cosine_schedule as j_cosine  # noqa: E402
from repro.optim import linear_warmup as j_warmup  # noqa: E402
from repro.runtime import StragglerMonitor as JMonitor  # noqa: E402
from repro.runtime import hosts_to_chips as j_hosts_to_chips  # noqa: E402
from repro.runtime import plan_recovery as j_plan  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.checkpoint import manager as manager_lib  # noqa: E402
from repro_torch.data import TokenStream  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.optim import AdamW, cosine_schedule, linear_warmup  # noqa: E402
from repro_torch.runtime import (StragglerMonitor, hosts_to_chips,  # noqa: E402
                                 plan_recovery)
from repro_torch.train import TrainState, init_state  # noqa: E402

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


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,args", [
    ("cosine", (3e-4, 20, 100)), ("cosine", (1e-3, 2, 6)),
    ("cosine", (0.1, 0, 30, 0.0)), ("warmup", (3e-4, 20)),
    ("warmup", (0.05, 0))])
def test_schedules_match_jax(name, args):
    """float32 values at steps 0-40 (warmup, decay and past the end) within
    2 float32 ulps of JAX's, or 2^-22 of the base rate where 1 + cos nears
    0 (the two libraries' float32 cos may differ by an ulp, which that
    cancellation magnifies)."""
    port, ref = {"cosine": (cosine_schedule, j_cosine),
                 "warmup": (linear_warmup, j_warmup)}[name]
    fn, jfn = port(*args), ref(*args)
    steps = np.arange(41, dtype=np.int32)
    got = np.array([fn(torch.tensor(s)).item() for s in steps], np.float32)
    want = np.array([jfn(jnp.asarray(s)) for s in steps], np.float32)
    assert fn(torch.tensor(3, dtype=torch.int32)).dtype == torch.float32
    np.testing.assert_allclose(got, want, rtol=2.4e-7, atol=2**-22 * args[0])


# ---------------------------------------------------------------------------
# token stream
# ---------------------------------------------------------------------------

def test_token_stream_matches_jax_bitwise():
    kw = dict(vocab_size=500, seq_len=33, global_batch=6, seed=7)
    port, ref = TokenStream(**kw), JStream(**kw)
    again = TokenStream(**kw)  # a restarted job: a fresh stream
    for step in (0, 1, 5, 40):
        got, want = port.batch(step), ref.batch(step)
        assert set(got) == {"tokens", "labels"}
        for k in got:
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(again.batch(step)["tokens"],
                                      got["tokens"])
    it = iter(port)
    np.testing.assert_array_equal(next(it)["labels"], ref.batch(0)["labels"])
    np.testing.assert_array_equal(next(it)["labels"], ref.batch(1)["labels"])


def test_token_stream_host_shards_match_jax():
    kw = dict(vocab_size=100, seq_len=16, global_batch=8, seed=1)
    full = JStream(**kw).batch(5)["tokens"]
    shards = []
    for h in range(4):
        got = TokenStream(**kw, host_id=h, num_hosts=4).batch(5)["tokens"]
        want = JStream(**kw, host_id=h, num_hosts=4).batch(5)["tokens"]
        np.testing.assert_array_equal(got, want)
        shards.append(got)
    np.testing.assert_array_equal(np.concatenate(shards), full)
    with pytest.raises(ValueError, match="divide"):
        TokenStream(**dict(kw, global_batch=6), num_hosts=4)


# ---------------------------------------------------------------------------
# checkpoint manager
# ---------------------------------------------------------------------------

def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(4, 3, generator=g),
            "b": {"c": torch.arange(5, dtype=torch.int32),
                  "h": torch.randn(2, 5, generator=g).to(torch.bfloat16),
                  "m": torch.tensor([True, False])}}


def _zeros_like(tree):
    return {"a": torch.zeros(4, 3),
            "b": {"c": torch.zeros(5, dtype=torch.int32),
                  "h": torch.zeros(2, 5, dtype=torch.bfloat16),
                  "m": torch.zeros(2, dtype=torch.bool)}}


def _equal(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            _equal(got[k], want[k])
        else:
            assert got[k].dtype == want[k].dtype, k
            assert torch.equal(got[k], want[k]), k


CODECS = ["zlib", "zstd"]


@pytest.mark.parametrize("codec", CODECS)
def test_checkpoint_roundtrip_each_codec(tmp_path, codec):
    if codec == "zstd" and manager_lib.zstandard is None:
        pytest.skip("zstandard not installed in this environment")
    mgr = CheckpointManager(tmp_path, codec=codec)
    tree = _tree()
    mgr.save(10, tree, data_step=123)
    restored, meta = mgr.restore(None, like=_zeros_like(tree))
    assert meta == {"step": 10, "data_step": 123}
    _equal(restored, tree)  # bfloat16 and bool leaves included, bit for bit
    blob = (mgr._step_dir(10) / "host_000.ckpt").read_bytes()
    assert blob[:4] == b"RPCK" and blob[4:8].rstrip(b"\0") == codec.encode()
    manifest = json.loads((mgr._step_dir(10) / "manifest.json").read_text())
    assert manifest["codec"] == codec
    assert manifest["paths"] == ["['a']", "['b']['c']", "['b']['h']",
                                 "['b']['m']"]
    assert manifest["dtypes"] == ["float32", "int32", "bfloat16", "bool"]


def test_checkpoint_default_codec(tmp_path):
    mgr = CheckpointManager(tmp_path)
    assert mgr.codec == ("zstd" if manager_lib.zstandard is not None
                         else "zlib")
    with pytest.raises(ValueError, match="codec"):
        CheckpointManager(tmp_path, codec="lz4")


def test_checkpoint_async_latest_and_retention(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    trees = {s: _tree(s) for s in (1, 2, 3)}
    for s, tree in trees.items():
        mgr.save_async(s, tree)
        # the snapshot was taken on this thread: an in-place update now
        # (as a train step could make) does not reach the checkpoint
        tree["a"].add_(100.0)
    mgr.wait()
    assert mgr.latest_step() == 3
    assert mgr.all_steps() == [2, 3]  # retention dropped step 1
    assert (tmp_path / "LATEST").read_text() == "3"
    restored, meta = mgr.restore(None, like=_zeros_like(trees[3]))
    assert meta["step"] == 3
    torch.testing.assert_close(restored["a"], _tree(3)["a"], rtol=0, atol=0)


def test_checkpoint_async_failure_reraised_by_wait(tmp_path, monkeypatch):
    def disk_full(data, codec):
        raise OSError("no space left on device")

    monkeypatch.setattr(manager_lib, "_compress", disk_full)
    mgr = CheckpointManager(tmp_path)
    mgr.save_async(1, _tree())  # the worker's write raises
    with pytest.raises(RuntimeError, match="asynchronous"):
        mgr.wait()
    mgr.wait()  # reported once
    assert mgr.latest_step() is None


def test_checkpoint_detects_structure_mismatch(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _tree())
    with pytest.raises(ValueError, match="mismatch"):
        mgr.restore(1, like={"different": torch.zeros(3)})
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore(None, like=_tree())


def test_checkpoint_crash_mid_save_is_recoverable(tmp_path):
    """A stale .tmp dir (a crash mid-save) breaks neither save nor restore."""
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _tree())
    (tmp_path / "step_00000002.tmp").mkdir()
    (tmp_path / "step_00000002.tmp" / "garbage").write_text("x")
    assert mgr.latest_step() == 1
    assert mgr.all_steps() == [1]
    mgr.save(2, _tree(2))  # cleans the stale dir up and publishes
    assert mgr.latest_step() == 2
    _equal(mgr.restore(2, like=_zeros_like(_tree()))[0], _tree(2))


def test_checkpoint_train_state_with_bf16_moments(tmp_path):
    """A whole ``TrainState`` (bfloat16 moments, the int32 step) round trips
    onto ``like``'s devices, with paths through the dataclass nodes."""
    cfg = configs.get_reduced("tinyllama-1.1b")
    model = Model(cfg)
    opt = AdamW(moment_dtype=torch.bfloat16)
    state = init_state(model, opt, torch.Generator().manual_seed(0),
                       device="cpu")
    state.opt.m["final_norm"]["scale"].fill_(0.123)
    mgr = CheckpointManager(tmp_path)
    mgr.save(4, state, data_step=4)
    like = init_state(model, opt, torch.Generator().manual_seed(1),
                      device="cpu")
    restored, meta = mgr.restore(None, like=like)
    assert isinstance(restored, TrainState) and meta["data_step"] == 4
    assert restored.opt.m["final_norm"]["scale"].dtype == torch.bfloat16
    for path_got, path_want in zip(
            torch.utils._pytree.tree_leaves(restored),
            torch.utils._pytree.tree_leaves(state)):
        assert torch.equal(path_got, path_want)
    paths = json.loads((mgr._step_dir(4) / "manifest.json").read_text())[
        "paths"]
    assert paths[0].startswith(".params[") and ".opt.step" in paths


def _jax_tree(seed=0):
    k = jax.random.PRNGKey(seed)
    return {"a": jax.random.normal(k, (4, 3)),
            "b": {"c": jnp.arange(5, dtype=jnp.int32)}}


@pytest.mark.parametrize("codec", CODECS)
def test_jax_written_shard_restores_here(tmp_path, codec):
    """The codec layer is the JAX package's: a shard its manager wrote
    carries the same header, and a tree of dicts (the same paths in both
    packages) restores through the port's manager."""
    if codec == "zstd" and manager_lib.zstandard is None:
        pytest.skip("zstandard not installed in this environment")
    tree = _jax_tree(3)
    JManager(tmp_path, codec=codec).save(5, tree, data_step=9)
    blob = (tmp_path / "step_00000005" / "host_000.ckpt").read_bytes()
    assert blob[:8] == manager_lib._compress(b"", codec)[:8]
    raw = manager_lib._decompress(blob)
    assert raw[:2] == b"PK"  # the npz payload
    mgr = CheckpointManager(tmp_path)
    assert mgr.latest_step() == 5
    like = {"a": torch.zeros(4, 3), "b": {"c": torch.zeros(5)}}
    restored, meta = mgr.restore(None, like=like)
    assert meta == {"step": 5, "data_step": 9}
    np.testing.assert_array_equal(restored["a"].numpy(), np.asarray(tree["a"]))
    assert restored["b"]["c"].dtype == torch.int32
    np.testing.assert_array_equal(restored["b"]["c"].numpy(), np.arange(5))


# ---------------------------------------------------------------------------
# straggler monitor and elastic planner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_straggler_monitor_matches_jax(seed):
    """The same per-host step times (a host slowed from step 6 on, jitter on
    all) flag the same hosts at every step, with the same statistics."""
    rng = np.random.default_rng(seed)
    port, ref = StragglerMonitor(num_hosts=8), JMonitor(num_hosts=8)
    slow = int(rng.integers(8))
    ever = False
    for step in range(30):
        t = 1.0 + 0.05 * rng.random(8)
        if step >= 6:
            t[slow] *= 4.0
        assert port.observe(t) == ref.observe(t), step
        assert port.persistent() == ref.persistent(), step
        ever |= bool(port.persistent())
        np.testing.assert_array_equal(port.mean, ref.mean)
        np.testing.assert_array_equal(port.var, ref.var)
    assert ever and port.persistent() == [slow]


def test_plan_recovery_matches_jax():
    def fields(plan):
        return dataclasses.astuple(plan) + (plan.chips,)

    for chips in list(range(0, 600, 7)) + [256, 512, 192, 64, 63]:
        assert fields(plan_recovery(chips)) == fields(j_plan(chips)), chips
    for kw in (dict(original_chips=256), dict(min_data=8),
               dict(model_axis=8)):
        for chips in (40, 100, 128, 200, 256, 300):
            assert fields(plan_recovery(chips, **kw)) == \
                fields(j_plan(chips, **kw)), (chips, kw)
    assert plan_recovery(256).mesh_shape == (16, 16)
    assert not plan_recovery(48).viable and "48" in plan_recovery(48).reason
    for hosts in (0, 1, 7, 128):
        assert hosts_to_chips(hosts) == j_hosts_to_chips(hosts)
        assert hosts_to_chips(hosts, host_chips=8) == \
            j_hosts_to_chips(hosts, host_chips=8)
