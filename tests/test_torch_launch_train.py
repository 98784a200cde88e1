"""The port's training driver end to end on the CPU, small scale: the JAX
package's ``tests/test_system.py`` driver tests with ``--device cpu``.

The same code path a card run takes: the token stream, ``make_train_step``,
asynchronous checkpoints and resume, the straggler monitor and the elastic
planner's recovery plan.  A resumed run ends on the params of an
uninterrupted one.
"""

import types

import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.train import init_state  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tests run many small ops: one intra-op thread a test process
    keeps them from spinning against the other test processes' threads
    (the suite runs several workers on shared cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARGS = ["--arch", "tinyllama-1.1b", "--reduced", "--batch", "4", "--seq",
        "64", "--log-every", "5", "--device", "cpu"]


def _final_params(ckpt_dir):
    model = Model(configs.get_reduced("tinyllama-1.1b"))
    like = init_state(model, AdamW(), torch.Generator().manual_seed(1),
                      device="cpu")
    mgr = CheckpointManager(ckpt_dir)
    state, meta = mgr.restore(None, like=like)
    return state, meta


def test_train_driver_end_to_end_with_resume(tmp_path, capsys):
    rc = train_cli.main(ARGS + ["--steps", "12", "--ckpt-dir",
                                str(tmp_path / "a"), "--ckpt-every", "5"])
    assert rc == 0
    assert CheckpointManager(tmp_path / "a").all_steps() == [5, 10, 12]
    # resume continues from the checkpoint at its data step
    rc = train_cli.main(ARGS + ["--steps", "16", "--ckpt-dir",
                                str(tmp_path / "a"), "--resume"])
    assert rc == 0
    assert "resumed from step 12 (data step 12)" in capsys.readouterr().out
    rc = train_cli.main(ARGS + ["--steps", "16", "--ckpt-dir",
                                str(tmp_path / "b"), "--ckpt-every", "100"])
    assert rc == 0
    resumed, meta = _final_params(tmp_path / "a")
    straight, _ = _final_params(tmp_path / "b")
    assert meta == {"step": 16, "data_step": 16}
    assert int(resumed.opt.step) == int(straight.opt.step) == 16
    for got, want in zip(torch.utils._pytree.tree_leaves(resumed),
                         torch.utils._pytree.tree_leaves(straight)):
        assert (got - want).abs().max() <= 1e-6 * want.abs().max()


def test_train_driver_straggler_path(tmp_path, capsys, monkeypatch):
    """An injected straggler leads to the recovery plan: on a clock where
    every step takes one second (the host's own times vary too much for a
    10-step run) host 1 turns 5x slower from step 2, is flagged from step 5
    and dropped at step 9; a checkpoint is taken there."""
    clock = iter(range(1000))
    monkeypatch.setattr(train_cli, "time",
                        types.SimpleNamespace(time=lambda: next(clock)))
    rc = train_cli.main([
        "--arch", "granite-3-2b", "--reduced", "--steps", "10",
        "--batch", "2", "--seq", "32", "--inject-straggler", "2",
        "--ckpt-dir", str(tmp_path), "--log-every", "5", "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert ("[ft] persistent stragglers [1]; recovery plan: mesh=(16, 16) "
            "accum x2") in out
    assert CheckpointManager(tmp_path).all_steps() == [10]


def test_moe_train_driver():
    rc = train_cli.main([
        "--arch", "qwen2-moe-a2.7b", "--reduced", "--steps", "6",
        "--batch", "2", "--seq", "32", "--log-every", "2", "--device", "cpu"])
    assert rc == 0


def test_train_driver_vlm_and_encdec_stand_ins():
    """The vlm's patch embeddings and the encdec's frames are drawn per step
    from a generator seeded by the step: the same step, the same draw."""
    for arch, key, n in (("internvl2-2b", "vis_embed", "n_vis_tokens"),
                         ("whisper-large-v3", "frames", "enc_seq")):
        cfg = configs.get_reduced(arch)
        raw = {"tokens": torch.zeros(2, 8, dtype=torch.int32).numpy(),
               "labels": torch.zeros(2, 8, dtype=torch.int32).numpy()}
        a = train_cli.make_batch_arrays(cfg, raw, 3, "cpu")
        b = train_cli.make_batch_arrays(cfg, raw, 3, "cpu")
        c = train_cli.make_batch_arrays(cfg, raw, 4, "cpu")
        assert a[key].shape == (2, getattr(cfg, n), cfg.d_model)
        assert torch.equal(a[key], b[key]) and not torch.equal(a[key], c[key])
        assert train_cli.main(["--arch", arch, "--reduced", "--steps", "2",
                               "--batch", "2", "--seq", "16",
                               "--device", "cpu"]) == 0


def test_train_driver_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the CUDA default would run")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(["--arch", "tinyllama-1.1b", "--reduced", "--steps",
                        "1"])
