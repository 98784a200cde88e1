"""End-to-end training driver.

The JAX package's ``launch/train.py`` on torch: a training loop with the
whole substrate, a deterministic resumable token stream
(``data.TokenStream``), ``train.make_train_step`` over ``AdamW`` on a
cosine schedule, asynchronous checkpoints (``checkpoint.CheckpointManager``,
resumed at the saved data step), a straggler monitor over four simulated
hosts and the elastic planner's recovery plan when one of them is dropped
(``runtime``; the plan is printed, not applied: the port has no
multi-device mesh yet).  The model's weights are random, drawn on the
device from ``--seed``.  Runs on the card unless ``--device cpu``.

The vlm and encdec families get stand-in patch embeddings and encoder
frames drawn from a ``torch.Generator`` seeded by the step on the device
(``make_batch_arrays``); their values are not the JAX driver's, which draws
them from ``PRNGKey(step)``.

Examples:
    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --reduced --steps 200 --batch 8 --seq 128 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-moe-a2.7b \\
        --reduced --steps 50 --resume --ckpt-dir ckpt --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import TokenStream
from repro_torch.device import resolve_device
from repro_torch.models import Model
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.runtime import (FailureInjector, StragglerMonitor,
                                 hosts_to_chips, plan_recovery)
from repro_torch.runtime.failures import Failure
from repro_torch.train import step as step_lib

NUM_HOSTS = 4        # the simulated hosts the straggler monitor watches
FLEET_CHIPS = 512    # the reference fleet the recovery plan shrinks


def make_batch_arrays(cfg, raw: dict, step: int, device) -> dict:
    """A ``TokenStream`` batch as tensors on ``device``, plus the vlm's patch
    embeddings or the encdec's frames (0.02 x standard normals from a
    generator seeded by ``step`` on ``device``)."""
    dev = torch.device(device)
    batch = {"tokens": torch.from_numpy(raw["tokens"]).to(dev),
             "labels": torch.from_numpy(raw["labels"]).to(dev)}
    b = batch["tokens"].shape[0]
    if cfg.family in ("vlm", "encdec"):
        gen = torch.Generator(device=dev).manual_seed(step)
        if cfg.family == "vlm":
            shape, key = (b, cfg.n_vis_tokens, cfg.d_model), "vis_embed"
        else:
            shape, key = (b, cfg.enc_seq, cfg.d_model), "frames"
        batch[key] = 0.02 * torch.randn(shape, generator=gen, device=dev)
    return batch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--inject-straggler", type=int, default=-1,
                    help="simulate a straggler host from this step")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random initial weights")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = (configs.get_reduced(args.arch) if args.reduced
           else configs.get_config(args.arch))
    model = Model(cfg)
    opt = AdamW(lr=cosine_schedule(args.lr, 20, args.steps), weight_decay=0.01)
    train_step = step_lib.make_train_step(model, opt, accum_steps=args.accum)

    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=args.seq,
                         global_batch=args.batch, seed=0)
    state = step_lib.init_state(
        model, opt, torch.Generator(device=dev).manual_seed(args.seed),
        device=dev)
    start_step = 0

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if mgr and args.resume and mgr.latest_step() is not None:
        state, meta = mgr.restore(None, like=state)
        start_step = meta["data_step"]
        print(f"resumed from step {meta['step']} (data step {start_step})")

    monitor = StragglerMonitor(num_hosts=NUM_HOSTS)
    injector = FailureInjector(
        [Failure(step=args.inject_straggler, kind="straggler", host=1)]
        if args.inject_straggler >= 0 else [])

    print(f"training {cfg.name} on {dev}: {model.param_count() / 1e6:.1f}M "
          f"params, {args.steps} steps")
    t_last = time.time()
    for step_i in range(start_step, args.steps):
        injector.at_step(step_i)
        batch = make_batch_arrays(cfg, stream.batch(step_i), step_i, dev)
        state, metrics = train_step(state, batch)

        t_now = time.time()
        host_times = np.asarray([injector.step_time(h, t_now - t_last)
                                 for h in range(NUM_HOSTS)])
        monitor.observe(host_times)
        t_last = t_now
        bad = monitor.persistent()
        if bad:
            plan = plan_recovery(FLEET_CHIPS - hosts_to_chips(len(bad)))
            print(f"[ft] persistent stragglers {bad}; recovery plan: "
                  f"mesh={plan.mesh_shape} accum x{plan.accum_multiplier}")
            if mgr:
                mgr.save_async(step_i + 1, state, data_step=step_i + 1)
            monitor = StragglerMonitor(num_hosts=NUM_HOSTS)  # after re-mesh

        if step_i % args.log_every == 0 or step_i == args.steps - 1:
            loss = float(metrics["loss"])
            print(f"step {step_i:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f}")
            if not np.isfinite(loss):
                raise RuntimeError(f"loss diverged at step {step_i}: {loss}")
        if mgr and (step_i + 1) % args.ckpt_every == 0:
            mgr.save_async(step_i + 1, state, data_step=step_i + 1)

    if mgr:
        mgr.save(args.steps, state, data_step=args.steps)
        mgr.wait()
    print("done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
