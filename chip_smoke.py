#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one card and check them.

    python3 chip_smoke.py [--seed N]

Needs one CUDA card, ``nvcc`` (``$CUDA_HOME``, ``PATH`` or
``/usr/local/cuda``) and the repository's ``src/`` beside this file; it
imports nothing of JAX.  Phases (each raises on failure, so the script
exits non-zero):

1. card name and power limit; build the four CUDA libraries from ``csrc/``
   (``mesh_fwd.cu``, ``mesh_bwd.cu``, ``rfnn_fwd.cu``, ``rfnn_bwd.cu``, all
   including the shared ``mesh_sweep.cuh``), one ``nvcc`` each, started
   together;
2. the forward kernel (B1) against its plain PyTorch version on the card,
   for n in {2, 8, 16, 64, 128}, B in {1, 7, 130, 4096}, ideal and
   PROTOTYPE coefficients, a mixed-parity schedule and the main path's own
   shapes (atol 1e-5 * n: FMA contraction and another order of adds); then
   the backward kernel (B2) for n in {2, 8, 16, 64}, B in {1, 7, 130,
   4096}, ideal and PROTOTYPE, a mixed-parity schedule, B = 0 and the
   training step's shape, against its plain version and against autograd
   through the plain forward (each output within 1e-5 * n of its largest
   magnitude), with bit-identical ``dcoef`` over two calls; then the fused
   layer's kernels B3, B4 and B5 for n in {2, 8, 16, 64}, B in {1, 7, 130,
   4096}, Clements and Reck plans (Cv != Cu), ideal and PROTOTYPE, zero
   attenuations, zero input rows and B = 0, against their plain versions
   (B5 also against autograd through the plain B4), with bit-identical
   ``dcv``/``dcu``/``dg`` over two calls;
3. ``MnistRFNN`` (8x8 analog mesh, PROTOTYPE hardware, Table-I phases) at
   full width on 1000 procedural digits: kernel-path logits against the
   reference backend on the card and the plain path on the CPU;
4. training at full width: ``train_mnist`` with the paper's Algorithm I
   (batch 10, lr 0.005, 3 epochs on 1000 digits); one epoch of
   ``_train_loop`` on the card against the same epoch on the CPU; an SGD
   step with and without hardware noise timed side by side;
5. the 2x2 RFNN decision maps on the kernel path against the two pinned
   goldens of the JAX package (2e-5), a 41x41 map, and
   ``train_rfnn2x2(method="search")`` on the card against the CPU;
6. ``ServingEngine`` on the deployed 8x8 processor: 256 requests through
   ``run()`` and through the dispatch thread, each equal to a direct apply;
7. the paper's Eq. 31 processor at full width (n = 8): an 8x8 matrix W from
   ``--seed`` programmed into ``AnalogLinear(8, 8, output="abs")`` by
   ``init_from_matrix`` and applied to 4096 inputs (|W x| within
   1e-4 * max, B3 only); ``svd_synthesis.synthesize`` of a 3x5 matrix; the
   ``fit`` program of W on the card, and 100 steps of it against the CPU;
8. training the fused layer at full width: ``AnalogLinear(8, 8, "abs",
   "table1", PROTOTYPE)`` learns |W x| of a second seeded layer through
   ``make_sgd_step`` (batch 1000): the loss falls below half its start
   within 40 steps, 20 steps agree with the CPU within 1e-5, B4 and B5
   launch once per step and B3 never;
9. times at n = 8 with CUDA events: each kernel (per call, and on the
   device alone), its bound, its plain version and a ``torch.matmul``
   yardstick, the whole ``mesh_apply`` and the SGD step;
10. the ``kernels`` line and, last, the ``ok``/``device`` line.

Every launch count is reset just before each main-path phase (3 to 8) and
read just after; launches made in phases 2 and 9 do not count.  Timings
are also written to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12        # H100 SXM data sheet, float32 outside tensor cores
FLOPS_PER_PAIR = 28            # two outputs x (2 complex mul + 1 complex add)
# backward, per row, pair and column: the inverse 2x2 product (28), four
# conjugate products and their batch sums (32), the adjoint 2x2 product (28)
FLOPS_PER_PAIR_BWD = 88
FLOPS_PER_CELL_INV = 43        # det, |det|^2, 1/det and adj(t)/det, per cell
# fused layer, per row and channel: the two gain products and |.| (16);
# backward: the |.| backward, both gains' conjugate products and row sums
FLOPS_PER_CHANNEL_FUSED = 16
FLOPS_PER_CHANNEL_FUSED_BWD = 41
LIBRARIES = ("mesh_fwd", "mesh_bwd", "rfnn_fwd", "rfnn_bwd")
SGD_BATCH = 10                 # the paper's minibatch
PROC_BATCH = 4096              # inputs through the programmed processor
FUSED_BATCH = 1000             # the fused layer's training batch
FUSED_LR = 60.0                # set on the CPU run of the port (seed 0)
FUSED_STEPS = 40               # the loss halves by step 33 there

# decision_map(net, {w: [0.9, -1.1], b: 0.2}, 3, 5, n=5) of the JAX package,
# pinned in tests/test_golden.py: the ideal device and the PROTOTYPE device.
GOLDEN_2X2_MAP = [
    [5.4983395e-01, 1.0476434e-01, 1.1087940e-02, 1.0731090e-03, 1.0291598e-04],
    [6.0822695e-01, 9.9973959e-01, 9.9728847e-01, 9.7240555e-01, 7.7149719e-01],
    [6.6367859e-01, 9.9998808e-01, 9.9999988e-01, 9.9999917e-01, 9.9999094e-01],
    [7.1495956e-01, 9.9999058e-01, 1.0000000e+00, 1.0000000e+00, 1.0000000e+00],
    [7.6123482e-01, 9.9999261e-01, 1.0000000e+00, 1.0000000e+00, 1.0000000e+00],
]
GOLDEN_2X2_MAP_PROTO = [
    [5.4826808e-01, 1.1116987e-01, 1.2645924e-02, 1.3098384e-03, 1.3428832e-04],
    [5.7940334e-01, 9.9908483e-01, 9.9135733e-01, 9.2166746e-01, 5.4653698e-01],
    [6.0841370e-01, 9.9995613e-01, 9.9999893e-01, 9.9999046e-01, 9.9990714e-01],
    [6.3667744e-01, 9.9996173e-01, 1.0000000e+00, 1.0000000e+00, 1.0000000e+00],
    [6.6402835e-01, 9.9996626e-01, 1.0000000e+00, 1.0000000e+00, 1.0000000e+00],
]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int, warmup: int = 5) -> float:
    """Mean ms per call of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int, warmup: int = 5) -> float:
    """Mean device ms per call of ``fn``, without the host's launch cost.

    The stream is held busy (``torch.cuda._sleep``) while the host queues
    all ``iters`` calls, so the events around them time only the card's
    back-to-back execution.  Raises if the host did not finish queueing
    before the stream reached the calls.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    events[0].record()
    torch.cuda._sleep(100_000_000)        # ~50 ms at the H100's clocks
    events[1].record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    queued_s = time.perf_counter() - t0
    events[2].record()
    events[2].synchronize()
    held_ms = events[0].elapsed_time(events[1])
    check(queued_s * 1e3 < held_ms,
          f"queueing took {queued_s * 1e3:.1f} ms, the stream was held "
          f"{held_ms:.1f} ms: device time not separable")
    return events[1].elapsed_time(events[2]) / iters


def profile_steps(torch, run, steps: int, names) -> tuple:
    """``run(steps)`` under ``torch.profiler``: device events per step,
    device-busy us per step and the us per step of the kernels whose names
    contain each of ``names``."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        run(steps)
        torch.cuda.synchronize()
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    check(len(dev_events) > 0, "the profiler recorded no device events")
    busy_us = sum(e.time_range.elapsed_us() for e in dev_events) / steps
    ours_us = {k: sum(e.time_range.elapsed_us() for e in dev_events
                      if k in e.name) / steps for k in names}
    return len(dev_events) / steps, busy_us, ours_us


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the Eq. 31 phases' matrices and inputs")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: needs a CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} is missing; run from a "
              "checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch import compile as compile_mod
    from repro_torch.core import decompose, svd_synthesis
    from repro_torch.core import mesh as mesh_lib
    from repro_torch.core.analog_linear import AnalogLinear, AnalogUnitary
    from repro_torch.core.hardware import IDEAL
    from repro_torch.data.digits import load_digits
    from repro_torch.data.toys import make_toy_dataset
    from repro_torch.kernels import cuda_build, givens_mesh, ops, ref, schedule
    from repro_torch.paper.mnist_rfnn import MnistRFNN, _train_loop, train_mnist
    from repro_torch.paper.prototype import PROTOTYPE
    from repro_torch.paper.rfnn2x2 import RFNN2x2, decision_map, train_rfnn2x2
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.train import make_sgd_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    report: dict = {"device": kind}

    # -- phase 1: card and build ------------------------------------------
    card = card_line()
    print(card, flush=True)
    report["card"] = card
    def timed_load(name):
        t0 = time.perf_counter()
        cuda_build.load(name)
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        build_s = dict(zip(LIBRARIES, pool.map(timed_load, LIBRARIES)))
    print("[1] built " + ", ".join(f"{k}.cu in {v:.2f} s"
                                    for k, v in build_s.items())
          + f" (together {time.perf_counter() - t0:.2f} s)", flush=True)
    report["build_s"] = build_s

    def reset_launches():
        for k in givens_mesh.LAUNCHES:
            givens_mesh.LAUNCHES[k] = 0

    def to_cpu(tree):
        if isinstance(tree, dict):
            return {k: to_cpu(v) for k, v in tree.items()}
        return tree.cpu()

    def max_tree_diff(a, b):
        if isinstance(a, dict):
            return max(max_tree_diff(a[k], b[k]) for k in a)
        return float((a.cpu() - b.cpu()).abs().max())

    # -- phase 2: the kernel against its plain version on the card ----------
    def params_for(n, seed):
        rng = np.random.default_rng(seed)
        shape = mesh_lib.clements_plan(n).param_shape()
        return {"theta": torch.from_numpy(
                    rng.uniform(0, np.pi, shape).astype(np.float32)),
                "phi": torch.from_numpy(
                    rng.uniform(0, 2 * np.pi, shape).astype(np.float32))}

    def rand_x(rng, b, n):
        x = rng.normal(size=(b, n)) + 1j * rng.normal(size=(b, n))
        return torch.from_numpy(x.astype(np.complex64)).to(dev)

    def kernel_vs_plain(coef, par, x):
        coef, par = coef.to(dev), par.to(dev)
        y = givens_mesh.mesh_forward(coef, par, x)
        torch.cuda.synchronize()
        y_plain = givens_mesh.mesh_forward_plain(coef, par, x)
        return float((y - y_plain).abs().max()) if x.shape[0] else 0.0

    rng = np.random.default_rng(0)
    worst = 0.0
    for n in (2, 8, 16, 64, 128):
        sched = schedule.clements_schedule(n)
        par = schedule.parity_array(sched)
        for hw in (None, PROTOTYPE):
            coef = ops._mesh_coefficients(sched, params_for(n, n), hw, None)
            for b in (1, 7, 130, 4096):
                err = kernel_vs_plain(coef, par, rand_x(rng, b, n))
                check(err <= 1e-5 * n, f"mesh_fwd n={n} B={b} hw={hw}: {err}")
                worst = max(worst, err / n)
        print(f"[2] n={n}: kernel == plain (ideal, PROTOTYPE; B 1..4096)",
              flush=True)
    cells = [(int(rng.integers(0, 15)), float(rng.uniform(0, np.pi)),
              float(rng.uniform(0, 2 * np.pi))) for _ in range(48)]
    plan, theta, phi = mesh_lib.pack_cells_to_columns(16, cells)
    sched = schedule.schedule_from_plan(plan)
    check(list(sched.parity) != [c % 2 for c in range(sched.n_columns)],
          "mixed schedule alternates like Clements")
    coef = ops._mesh_coefficients(sched, {"theta": theta, "phi": phi},
                                  PROTOTYPE, None)
    err = kernel_vs_plain(coef, schedule.parity_array(sched),
                          rand_x(rng, 130, 16))
    check(err <= 1e-5 * 16, f"mesh_fwd mixed parity: {err}")
    empty = givens_mesh.mesh_forward(coef.to(dev),
                                     schedule.parity_array(sched, dev),
                                     torch.zeros(0, 16, dtype=torch.complex64,
                                                 device=dev))
    check(empty.shape == (0, 16), "B=0 must return an empty tensor")
    # the main path's own shapes: MNIST (1000 x 8), engine panel (64 x 8),
    # 2x2 maps (25 x 2, 1681 x 2)
    main_err = 0.0
    for n, b in ((8, 1000), (8, 64), (2, 25), (2, 1681)):
        sched = schedule.clements_schedule(n)
        coef = ops._mesh_coefficients(sched, params_for(n, b), PROTOTYPE, None)
        e = kernel_vs_plain(coef, schedule.parity_array(sched),
                            rand_x(rng, b, n))
        check(e <= 1e-5 * n, f"mesh_fwd main-path shape n={n} B={b}: {e}")
        main_err = max(main_err, e)
    print(f"[2] mixed parity, B=0 and main-path shapes ok; max err "
          f"{main_err:.3e} at main-path shapes", flush=True)
    report["phase2_max_err_per_n"] = worst
    report["main_path_max_abs_err"] = main_err

    def bwd_vs_plain(coef, par, x, g):
        """B2 against its plain version and against autograd through the
        plain forward; bit-identical dcoef over two calls.  Returns the
        largest absolute error against the plain version."""
        n = x.shape[1]
        coef, par = coef.to(dev), par.to(dev)
        y = givens_mesh.launch(coef, par, x)
        dc, dx = givens_mesh.launch_backward(coef, par, y, g)
        dc2, _ = givens_mesh.launch_backward(coef, par, y, g)
        torch.cuda.synchronize()
        check(torch.equal(dc, dc2), f"mesh_bwd dcoef differs between two "
              f"calls (n={n}, B={x.shape[0]})")
        pc, px = givens_mesh.mesh_backward_plain(coef, par, y, g)
        cl = coef.clone().requires_grad_(True)
        xl = x.clone().requires_grad_(True)
        ac, ax = torch.autograd.grad(givens_mesh.mesh_forward_plain(cl, par, xl),
                                     [cl, xl], grad_outputs=g)
        for what, got, refs in (("dcoef", dc, (pc, ac)), ("dx", dx, (px, ax))):
            for ref_name, ref in zip(("plain", "autograd"), refs):
                scale = float(ref.abs().max())
                err = float((got - ref).abs().max())
                check(err <= 1e-5 * n * scale, f"mesh_bwd {what} vs {ref_name} "
                      f"n={n} B={x.shape[0]}: {err} (scale {scale})")
        if n > 2:
            odd = (par == 1).nonzero().flatten()
            check(bool((dc[odd, :, -1] == 0).all()), "odd wrap slot gradient")
        return max(float((dc - pc).abs().max()), float((dx - px).abs().max()))

    for n in (2, 8, 16, 64):
        sched = schedule.clements_schedule(n)
        par = schedule.parity_array(sched)
        for hw in (None, PROTOTYPE):
            coef = ops._mesh_coefficients(sched, params_for(n, n), hw, None)
            for b in (1, 7, 130, 4096):
                bwd_vs_plain(coef, par, rand_x(rng, b, n), rand_x(rng, b, n))
        print(f"[2] n={n}: mesh_bwd == plain == autograd of the plain forward "
              f"(ideal, PROTOTYPE; B 1..4096), dcoef bit-identical", flush=True)
    cells = [(int(rng.integers(0, 15)), float(rng.uniform(0, np.pi)),
              float(rng.uniform(0, 2 * np.pi))) for _ in range(48)]
    plan, theta, phi = mesh_lib.pack_cells_to_columns(16, cells)
    sched = schedule.schedule_from_plan(plan)
    coef = ops._mesh_coefficients(sched, {"theta": theta, "phi": phi},
                                  PROTOTYPE, None)
    bwd_vs_plain(coef, schedule.parity_array(sched), rand_x(rng, 130, 16),
                 rand_x(rng, 130, 16))
    empty = torch.zeros(0, 16, dtype=torch.complex64, device=dev)
    n_bwd = givens_mesh.LAUNCHES["mesh_bwd"]
    dc0, dx0 = givens_mesh.launch_backward(
        coef.to(dev), schedule.parity_array(sched, dev), empty, empty)
    check(dx0.shape == (0, 16) and not bool(dc0.any())
          and givens_mesh.LAUNCHES["mesh_bwd"] == n_bwd,
          "B=0 backward must return zeros without a launch")
    sched = schedule.clements_schedule(8)   # the SGD step's shape
    coef = ops._mesh_coefficients(sched, params_for(8, 10), PROTOTYPE, None)
    main_err_bwd = bwd_vs_plain(coef, schedule.parity_array(sched),
                                rand_x(rng, SGD_BATCH, 8),
                                rand_x(rng, SGD_BATCH, 8))
    print(f"[2] mesh_bwd: mixed parity and B=0 ok; max err {main_err_bwd:.3e} "
          f"at the SGD step's shape (n=8, B={SGD_BATCH})", flush=True)
    report["main_path_max_abs_err_bwd"] = main_err_bwd

    def fused_inputs(n, hw, plans, zero_atten, seed):
        """Coefficients, parities and gains of a fused layer on the card.
        ``plans``: "clements" (both meshes), "reck_v" (a Reck V over a
        Clements U: Cv != Cu) or "reck" (both Reck, as ``init_from_matrix``
        programs them).  Random complex gains with, optionally, exact zeros
        in g1 (zero attenuations)."""
        def mesh(reck, s):
            if not reck:
                return schedule.clements_schedule(n), params_for(n, s)
            plan, p = decompose.reck_program(decompose.random_unitary(n, s),
                                             device="cpu")
            return schedule.schedule_from_plan(plan), p

        sv, vp = mesh(plans != "clements", seed)
        su, up = mesh(plans == "reck", seed + 1)
        gains = torch.from_numpy(np.random.default_rng(seed).normal(
            size=(8, n // 2)).astype(np.float32))
        if zero_atten:
            gains[:2, : max(1, n // 4)] = 0.0
        return [t.to(dev) for t in (
            ops._mesh_coefficients(sv, vp, hw, None), schedule.parity_array(sv),
            ops._mesh_coefficients(su, up, hw, None), schedule.parity_array(su),
            gains)]

    def max_rel_check(what, got, want, n):
        """|got - want| within 1e-5 * n of want's largest magnitude."""
        if want.numel() == 0:
            return 0.0
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        check(err <= 1e-5 * n * max(scale, 1e-30),
              f"{what}: {err} (scale {scale})")
        return err

    def fused_vs_plain(inputs, x, g, autograd=True):
        """B3, B4 and B5 against their plain versions (B5 also against
        autograd through the plain B4); bit-identical gradients over two
        calls.  Returns the largest absolute error against the plain
        versions: (forward, backward)."""
        n = x.shape[1]
        out3 = givens_mesh.launch_rfnn(*inputs, x)
        out4, v, u = givens_mesh.launch_rfnn(*inputs, x, save_stages=True)
        grads = givens_mesh.launch_rfnn_backward(*inputs, v, u, g)
        grads2 = givens_mesh.launch_rfnn_backward(*inputs, v, u, g)
        torch.cuda.synchronize()
        for a, c in zip(grads[:3], grads2[:3]):
            check(torch.equal(a, c), f"rfnn_bwd gradients differ between two "
                  f"calls (n={n}, B={x.shape[0]})")
        pout, pv, pu = givens_mesh.rfnn_forward_plain(*inputs, x)
        tag = f"n={n} B={x.shape[0]} Cv={inputs[0].shape[0]}"
        e_fwd = max(max_rel_check(f"rfnn_fwd {tag}", out3, pout, n),
                    max_rel_check(f"rfnn_fwd_res out {tag}", out4, pout, n),
                    max_rel_check(f"rfnn_fwd_res post-V {tag}", v, pv, n),
                    max_rel_check(f"rfnn_fwd_res post-U {tag}", u, pu, n))
        plain = givens_mesh.rfnn_backward_plain(*inputs, v, u, g)
        names = ("dcv", "dcu", "dg", "dx")
        e_bwd = max(max_rel_check(f"rfnn_bwd {k} vs plain {tag}", a, b, n)
                    for k, a, b in zip(names, grads, plain))
        check(all(bool(torch.isfinite(t).all()) for t in grads),
              f"rfnn_bwd non-finite gradients {tag}")
        if autograd:
            leaves = [t.clone().requires_grad_(True)
                      for t in (inputs[0], inputs[2], inputs[4], x)]
            o, _, _ = ref.rfnn_linear_planes(leaves[0], inputs[1], leaves[1],
                                             inputs[3], leaves[2], leaves[3])
            auto = torch.autograd.grad(o, leaves, grad_outputs=g)
            for k, a, b in zip(names, grads, auto):
                max_rel_check(f"rfnn_bwd {k} vs autograd {tag}", a, b, n)
        return e_fwd, e_bwd

    for n in (2, 8, 16, 64):
        for hw, plans in ((None, "clements"), (PROTOTYPE, "clements"),
                          (None, "reck_v"), (PROTOTYPE, "reck_v")):
            inputs = fused_inputs(n, hw, plans, plans == "reck_v", seed=n)
            for b in (1, 7, 130, 4096):
                x = rand_x(rng, b, n)
                g = torch.from_numpy(rng.normal(size=(b, n)).astype(
                    np.float32)).to(dev)
                zero_rows = b == 130
                if zero_rows:  # |.| at the origin: exactly zero, finite grads
                    x[::9] = 0
                fused_vs_plain(inputs, x, g, autograd=not zero_rows)
        print(f"[2] n={n}: rfnn_fwd (B3), rfnn_fwd_res (B4) and rfnn_bwd (B5) "
              f"== plain, B5 == autograd of the plain B4 (Clements and Reck "
              f"V, ideal and PROTOTYPE, zero attenuations and input rows; "
              f"B 1..4096), gradients bit-identical", flush=True)
    inputs = fused_inputs(8, None, "reck_v", False, seed=3)
    empty = torch.zeros(0, 8, dtype=torch.complex64, device=dev)
    n_before = dict(givens_mesh.LAUNCHES)
    out0, v0, u0 = givens_mesh.launch_rfnn(*inputs, empty, save_stages=True)
    grads0 = givens_mesh.launch_rfnn_backward(
        *inputs, v0, u0, torch.zeros(0, 8, device=dev))
    check(givens_mesh.LAUNCHES == n_before and out0.shape == (0, 8)
          and grads0[3].shape == (0, 8)
          and not any(bool(t.any()) for t in grads0[:3]),
          "B=0 must return empty outputs and zero gradients without a launch")
    # the main path's shapes: the programmed processor (Reck V and U) at
    # B = 4096, the fused layer's training step (Clements, PROTOTYPE) at 1000
    proc_inputs = fused_inputs(8, None, "reck", False, seed=5)
    check(proc_inputs[0].shape[0] == proc_inputs[2].shape[0] == 13,
          f"a Reck program at n = 8 has {proc_inputs[0].shape[0]} parity "
          "columns, not 13")
    main_err_fused = fused_vs_plain(proc_inputs, rand_x(rng, PROC_BATCH, 8),
                                    torch.rand(PROC_BATCH, 8, device=dev))
    main_err_fused_train = fused_vs_plain(
        fused_inputs(8, PROTOTYPE, "clements", False, seed=6),
        rand_x(rng, FUSED_BATCH, 8), torch.rand(FUSED_BATCH, 8, device=dev))
    print(f"[2] fused kernels: B=0 ok; max err vs plain {main_err_fused[0]:.3e} "
          f"(B3, programmed processor, B={PROC_BATCH}), "
          f"{main_err_fused_train[0]:.3e} (B4) and {main_err_fused_train[1]:.3e} "
          f"(B5) at the training step (B={FUSED_BATCH})", flush=True)
    report["main_path_max_abs_err_fused"] = {
        "rfnn_fwd": main_err_fused[0], "rfnn_fwd_res": main_err_fused_train[0],
        "rfnn_bwd": main_err_fused_train[1]}

    launches: dict[str, dict] = {}

    # -- phase 3: MNIST RFNN at full width ------------------------------------
    _, _, x_te, y_te = load_digits(n_train=0, n_test=1000, seed=0)
    model = MnistRFNN(analog=True, hardware=PROTOTYPE, quantize="table1")
    params = model.init(torch.Generator().manual_seed(0))
    check(params["w1"].device.type == "cuda", "MnistRFNN.init not on cuda")
    reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits = model.apply(params, x_te)
    torch.cuda.synchronize()
    mnist_s = time.perf_counter() - t0
    launches["mnist"] = dict(givens_mesh.LAUNCHES)
    check(launches["mnist"]["mesh_fwd"] >= 1, "MNIST apply never launched "
          "mesh_fwd")
    check(tuple(logits.shape) == (1000, 10), f"logits {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    with torch.no_grad():
        ref = MnistRFNN(hardware=PROTOTYPE, quantize="table1",
                        backend="reference").apply(params, x_te)
        cpu = model.apply(to_cpu(params), x_te)
    d_ref = float((logits - ref).abs().max())
    d_cpu = float((logits.cpu() - cpu).abs().max())
    torch.testing.assert_close(logits, ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(logits.cpu(), cpu, rtol=1e-5, atol=1e-5)
    acc = float((logits.argmax(-1).cpu().numpy() == y_te).mean())
    x_dev = torch.from_numpy(x_te).to(dev)
    with torch.no_grad():
        steady_ms = cuda_ms(torch, lambda: model.apply(params, x_dev), 20)
    print(f"[3] MnistRFNN(PROTOTYPE, table1) 1000x784 logits ok: "
          f"|kernel-reference| {d_ref:.2e}, |card-cpu| {d_cpu:.2e}, "
          f"accuracy with random weights {acc:.3f}, first apply "
          f"{mnist_s * 1e3:.1f} ms, steady apply {steady_ms:.3f} ms, "
          f"launches {launches['mnist']}", flush=True)
    report["mnist"] = {"max_abs_vs_reference": d_ref, "max_abs_vs_cpu": d_cpu,
                       "first_apply_ms": mnist_s * 1e3,
                       "steady_apply_ms": steady_ms,
                       "launches": launches["mnist"]}

    # -- phase 4: training at full width ---------------------------------------
    x_tr, y_tr, x_te3, y_te3 = load_digits(n_train=1000, n_test=300, seed=0)
    epochs = 3
    # Algorithm I: 2 stage-1 epochs, then 3 rounds of 1 epoch with the mesh
    # frozen (train_mnist's own split of 3 epochs)
    sgd_steps = (max(1, epochs * 2 // 3) + 3 * max(1, max(1, epochs // 3) // 3)) \
        * (len(x_tr) // SGD_BATCH)
    reset_launches()
    t0 = time.perf_counter()
    res = train_mnist(x_tr, y_tr, x_te3, y_te3, schedule="algorithm1",
                      epochs=epochs, batch=SGD_BATCH, lr=0.005, seed=0,
                      log_every=1)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches["train_mnist"] = dict(givens_mesh.LAUNCHES)
    hist = res["history"]
    check(len(hist) == 5, f"history {hist}")
    check(all(np.isfinite(h["loss"]) for h in hist), f"non-finite loss {hist}")
    check(hist[1]["loss"] < hist[0]["loss"], f"stage-1 loss did not fall: "
          f"{hist[0]['loss']} -> {hist[1]['loss']}")
    check(launches["train_mnist"]["mesh_bwd"] >= sgd_steps,
          f"mesh_bwd launched {launches['train_mnist']['mesh_bwd']} times for "
          f"{sgd_steps} SGD steps")
    check(res["params"]["w1"].device.type == "cuda", "trained params left cuda")
    print(f"[4] train_mnist(algorithm1, PROTOTYPE, table1, batch 10, lr 0.005, "
          f"3 epochs, 1000 digits) on the card: {train_s:.1f} s, {sgd_steps} "
          f"SGD steps, losses {[round(h['loss'], 5) for h in hist]}, train acc "
          f"{res['train_acc']:.3f}, test acc {res['test_acc']:.3f}, launches "
          f"{launches['train_mnist']}", flush=True)

    tm = MnistRFNN(hardware=PROTOTYPE, quantize=None)
    p0 = tm.init(torch.Generator().manual_seed(5))
    kw = dict(epochs=1, batch=SGD_BATCH, lr=0.005, seed=11, log_every=1,
              noisy_train=False)
    reset_launches()
    r_card = _train_loop(tm, p0, x_tr, y_tr, x_te3, y_te3, **kw)
    launches["epoch"] = dict(givens_mesh.LAUNCHES)
    r_cpu = _train_loop(tm, to_cpu(p0), x_tr, y_tr, x_te3, y_te3, **kw)
    d_epoch = max_tree_diff(r_card["params"], r_cpu["params"])
    check(d_epoch <= 1e-4, f"card vs CPU epoch params differ by {d_epoch}")
    print(f"[4] one epoch of _train_loop (PROTOTYPE, continuous phases, 100 "
          f"steps): card vs CPU params max |diff| {d_epoch:.2e} (bound 1e-4), "
          f"loss {r_card['history'][0]['loss']:.6f} / "
          f"{r_cpu['history'][0]['loss']:.6f}", flush=True)

    def sgd_loop(model, noisy):
        """A warmed-up SGD loop at batch 10 on the card's params: ``run(k)``
        takes k steps (hardware noise from one generator when ``noisy``)."""
        step = make_sgd_step(model.loss, lr=0.005)
        state = {"p": model.init(torch.Generator().manual_seed(7))}
        xb = torch.from_numpy(x_tr[:SGD_BATCH]).to(dev)
        yb = torch.from_numpy(y_tr[:SGD_BATCH]).long().to(dev)
        gen = torch.Generator().manual_seed(3) if noisy else None

        def run(k):
            for _ in range(k):
                state["p"], (loss, _) = step(state["p"], xb, yb, gen)
            return loss

        run(5)
        torch.cuda.synchronize()
        return run

    def sgd_step_ms(model, noisy, steps=50):
        """Host ms per SGD step, ending in a synchronize."""
        run = sgd_loop(model, noisy)
        t0 = time.perf_counter()
        loss = run(steps)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(loss)), "non-finite SGD loss")
        return (time.perf_counter() - t0) * 1e3 / steps

    step_model = MnistRFNN(hardware=PROTOTYPE, quantize="table1")
    reset_launches()
    step_ms = {"noiseless": [], "noisy": []}
    for noisy in (False, True, True, False):
        step_ms["noisy" if noisy else "noiseless"].append(
            sgd_step_ms(step_model, noisy))
    launches["sgd_steps"] = dict(givens_mesh.LAUNCHES)
    print(f"[4] SGD step, MnistRFNN(PROTOTYPE, table1) at batch 10: noiseless "
          f"{step_ms['noiseless']} ms, with hardware noise (host draws) "
          f"{step_ms['noisy']} ms per step (runs in the order noiseless, "
          f"noisy, noisy, noiseless)", flush=True)

    # device time inside a noiseless step, from the profiler's device events
    per_step, busy_us, ours_us = profile_steps(
        torch, sgd_loop(step_model, False), 20,
        ("mesh_fwd_kernel", "mesh_bwd_kernel", "reduce_partials"))
    check(ours_us["mesh_fwd_kernel"] > 0 and ours_us["mesh_bwd_kernel"] > 0,
          f"the profiled SGD steps show no mesh kernel: {ours_us}")
    step_mean = sum(step_ms["noiseless"]) / len(step_ms["noiseless"])
    profile_row = {"device_events_per_step": per_step,
                   "device_busy_us_per_step": busy_us,
                   "busy_share_of_step": busy_us / (step_mean * 1e3),
                   "mesh_kernels_us_per_step": ours_us}
    print(f"[4] profiler, noiseless SGD step: {per_step:.0f} device events "
          f"and {busy_us:.1f} us of device time per "
          f"step, {100 * profile_row['busy_share_of_step']:.1f}% of the "
          f"{step_mean:.3f} ms step; mesh kernels per step (us) {ours_us}",
          flush=True)
    report["train"] = {"train_mnist_s": train_s, "sgd_steps": sgd_steps,
                       "history": hist, "train_acc": res["train_acc"],
                       "test_acc": res["test_acc"],
                       "epoch_card_vs_cpu_max_abs": d_epoch,
                       "sgd_step_ms": step_ms, "sgd_step_profile": profile_row,
                       "launches": launches}

    # -- phase 5: the 2x2 RFNN on the kernel path ------------------------------
    p2 = {"w": np.asarray([0.9, -1.1], np.float32), "b": np.float32(0.2)}
    reset_launches()
    for hw, golden in ((IDEAL, GOLDEN_2X2_MAP), (PROTOTYPE,
                                                 GOLDEN_2X2_MAP_PROTO)):
        grid, zmap = decision_map(RFNN2x2(hardware=hw), p2, 3, 5, lim=30.0,
                                  n=5)
        np.testing.assert_allclose(grid, np.linspace(0.0, 30.0, 5), atol=0)
        np.testing.assert_allclose(zmap, np.asarray(golden, np.float32),
                                   atol=2e-5)
    _, zk = decision_map(RFNN2x2(), p2, 1, 4, n=41)
    launches["rfnn2x2"] = dict(givens_mesh.LAUNCHES)
    check(launches["rfnn2x2"]["mesh_fwd"] >= 3, "2x2 maps did not launch "
          "mesh_fwd")
    _, zr = decision_map(RFNN2x2(backend="reference"), p2, 1, 4, n=41)
    check(zk.shape == (41, 41), f"41x41 map shape {zk.shape}")
    np.testing.assert_allclose(zk, zr, atol=2e-5)
    print(f"[5] 2x2 goldens (IDEAL, PROTOTYPE) ok on the kernel path; 41x41 "
          f"map == reference ({float(np.abs(zk - zr).max()):.1e}); launches "
          f"{launches['rfnn2x2']}", flush=True)
    x2, y2 = make_toy_dataset("corner", n=160, seed=2)
    reset_launches()
    t0 = time.perf_counter()
    _, post_card, codes_card, info_card = train_rfnn2x2(x2, y2, method="search",
                                                       seed=0)
    torch.cuda.synchronize()
    train2_s = time.perf_counter() - t0
    launches["train_rfnn2x2"] = dict(givens_mesh.LAUNCHES)
    check(launches["train_rfnn2x2"]["mesh_fwd"] >= 6, "2x2 search did not "
          "measure through mesh_fwd")
    _, post_cpu, codes_cpu, info_cpu = train_rfnn2x2(x2, y2, method="search",
                                                     seed=0, device="cpu")
    d_post = max_tree_diff(post_card, post_cpu)
    check(codes_card == codes_cpu, f"2x2 codes {codes_card} vs {codes_cpu}")
    check(d_post <= 1e-5, f"2x2 post params differ by {d_post}")
    print(f"[5] train_rfnn2x2(search) on the card in {train2_s:.2f} s: codes "
          f"{codes_card} == CPU, post params max |diff| {d_post:.1e}, train acc "
          f"{info_card['train_acc']:.4f} (CPU {info_cpu['train_acc']:.4f}); "
          f"launches {launches['train_rfnn2x2']}", flush=True)
    report["rfnn2x2_train"] = {"codes": codes_card, "post_max_abs": d_post,
                               "train_acc": info_card["train_acc"],
                               "seconds": train2_s}

    # -- phase 6: serving the deployed 8x8 processor ---------------------------
    proc = AnalogUnitary(n=8, hardware=PROTOTYPE, quantize="table1",
                         output="abs")
    pparams = proc.init(torch.Generator().manual_seed(1))
    feats = np.random.default_rng(2).normal(size=(256, 8)).astype(np.float32)
    with torch.no_grad():
        direct = [proc.apply(pparams, torch.from_numpy(feats[i:i + 1]))
                  .cpu().numpy()[0] for i in range(256)]
    reset_launches()
    engine = ServingEngine(proc, pparams, slots=64)
    reqs = [Request(i, features=f) for i, f in enumerate(feats)]
    for r in reqs:
        check(engine.submit(r), "submit refused")
    engine.run()
    sync_stats = engine.stats
    threaded = ServingEngine(proc, pparams, slots=64)
    treqs = [Request(i, features=f) for i, f in enumerate(feats)]
    with threaded:
        for r in treqs:
            check(threaded.submit(r), "submit refused")
        check(all(r.wait(timeout=120) for r in treqs), "requests not served")
    launches["serving"] = dict(givens_mesh.LAUNCHES)
    check(launches["serving"]["mesh_fwd"] >= 8, "serving did not launch "
          "mesh_fwd per tick")
    worst_req = 0.0
    for r, t, d in zip(reqs, treqs, direct):
        check(r.done and not r.failed and t.done and not t.failed,
              f"request {r.rid} failed")
        # the same per-row arithmetic, so equal up to elementwise kernels
        # that may take vector or scalar code paths by tensor size
        np.testing.assert_allclose(r.result, d, rtol=0, atol=1e-6)
        np.testing.assert_allclose(t.result, d, rtol=0, atol=1e-6)
        worst_req = max(worst_req, float(np.abs(r.result - d).max()),
                        float(np.abs(t.result - d).max()))
    check(sync_stats["served"] == 256 and threaded.stats["served"] == 256,
          "not every request served")
    print(f"[6] engine: 256 requests via run() and via the dispatch thread "
          f"== direct apply (max diff {worst_req:.1e}); launches "
          f"{launches['serving']}", flush=True)
    print(f"[6] run() stats {json.dumps(sync_stats)}", flush=True)
    print(f"[6] thread stats {json.dumps(threaded.stats)}", flush=True)
    report["serving"] = {"run": sync_stats, "thread": threaded.stats,
                         "max_diff_vs_direct": worst_req,
                         "launches": launches["serving"]}

    # -- phase 7: the Eq. 31 processor at full width ---------------------------
    rng_w = np.random.default_rng(args.seed)
    w = rng_w.normal(size=(8, 8))
    proc = AnalogLinear(8, 8, output="abs")
    x_proc = torch.from_numpy(rng_w.normal(size=(PROC_BATCH, 8)).astype(
        np.float32)).to(dev)
    m35 = rng_w.normal(size=(3, 5))
    reset_launches()
    t0 = time.perf_counter()
    proc_params = proc.init_from_matrix(w)
    check(proc_params["atten_logit"].device.type == "cuda",
          "init_from_matrix did not program the card")
    with torch.no_grad():
        y_proc = proc.apply(proc_params, x_proc)
    torch.cuda.synchronize()
    proc_ms = (time.perf_counter() - t0) * 1e3
    launches["processor_apply"] = dict(givens_mesh.LAUNCHES)
    want = np.abs(x_proc.cpu().numpy().astype(np.float64) @ w.T)
    d_proc = float(np.abs(y_proc.cpu().numpy() - want).max())
    check(tuple(y_proc.shape) == (PROC_BATCH, 8), f"processor output "
          f"{tuple(y_proc.shape)}")
    check(d_proc <= 1e-4 * want.max(), f"programmed processor vs |W x|: "
          f"{d_proc} (max {want.max()})")
    check(launches["processor_apply"] == {**{k: 0 for k in givens_mesh.LAUNCHES},
                                          "rfnn_fwd": 1},
          f"the programmed processor's inference must launch B3 once and "
          f"nothing else: {launches['processor_apply']}")
    proc_cpu = AnalogLinear(8, 8, output="abs")
    with torch.no_grad():
        y_proc_cpu = proc_cpu.apply(proc_cpu.init_from_matrix(w, device="cpu"),
                                    x_proc.cpu())
    d_proc_cpu = float((y_proc.cpu() - y_proc_cpu).abs().max())
    check(d_proc_cpu <= 1e-5 * 8 * want.max(), f"processor card vs CPU "
          f"{d_proc_cpu}")
    print(f"[7] AnalogLinear(8, 8, abs).init_from_matrix(W) on the card (Reck "
          f"plans, {proc.n_cells()} cells, {proc_params['v']['theta'].shape[0]} "
          f"plan columns per mesh): {PROC_BATCH} inputs, max |y - |W x|| "
          f"{d_proc:.2e} (bound {1e-4 * want.max():.2e}), card vs CPU "
          f"{d_proc_cpu:.2e}, program + first apply {proc_ms:.1f} ms, "
          f"launches {launches['processor_apply']}", flush=True)

    reset_launches()
    syn = svd_synthesis.synthesize(m35)
    syn_err = svd_synthesis.synthesis_error(m35, syn)
    check(syn_err < 1e-4, f"svd_synthesis of a 3x5 matrix: {syn_err}")
    check(float(syn.attenuation.max()) <= 1 + 1e-6, "attenuation above 1")
    t0 = time.perf_counter()
    prog = compile_mod.program(compile_mod.synthesize(w), method="fit")
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_err = compile_mod.program_error(prog)
    launches["processor_program"] = dict(givens_mesh.LAUNCHES)
    check(launches["processor_program"]["mesh_fwd"] >= 2 * 1500
          and launches["processor_program"]["mesh_bwd"] >= 2 * 1500,
          f"the fit did not run on B1/B2: {launches['processor_program']}")
    check(fit_err < 0.1, f"fit program error {fit_err}")
    short_card = compile_mod.program(compile_mod.synthesize(w), method="fit",
                                     steps=100)
    short_cpu = compile_mod.program(compile_mod.synthesize(w, device="cpu"),
                                    method="fit", steps=100)
    d_fit = max(max_tree_diff(a.v_params, b.v_params) for a, b in
                zip(short_card.layers, short_cpu.layers))
    d_fit = max(d_fit, max(max_tree_diff(a.u_params, b.u_params) for a, b in
                           zip(short_card.layers, short_cpu.layers)))
    check(d_fit <= 1e-5, f"fit card vs CPU after 100 steps: {d_fit}")
    print(f"[7] svd_synthesis(3x5) error {syn_err:.2e}; program(synthesize(W), "
          f"fit, 1500 AdamW steps per mesh) on the card in {fit_s:.1f} s: "
          f"program_error {fit_err:.3e}; 100 steps card vs CPU params max "
          f"|diff| {d_fit:.2e} (bound 1e-5); launches "
          f"{launches['processor_program']}", flush=True)
    report["processor"] = {"max_abs_vs_abs_wx": d_proc,
                           "card_vs_cpu": d_proc_cpu,
                           "svd_synthesis_3x5_error": syn_err,
                           "fit_program_error": fit_err, "fit_s": fit_s,
                           "fit_100_card_vs_cpu": d_fit,
                           "launches": {k: launches[k] for k in (
                               "processor_apply", "processor_program")}}

    # -- phase 8: training the fused layer at full width ------------------------
    layer_t = AnalogLinear(8, 8, output="abs", quantize="table1",
                           hardware=PROTOTYPE)

    def fused_training(device, steps):
        """``steps`` SGD steps of a seeded student toward a second seeded
        layer's |W x| on ``FUSED_BATCH`` inputs; returns the params and the
        losses (tensors)."""
        teacher = layer_t.init(torch.Generator().manual_seed(args.seed + 1),
                               device=device)
        xb = torch.from_numpy(np.random.default_rng(args.seed).normal(
            size=(FUSED_BATCH, 8)).astype(np.float32)).to(device)
        with torch.no_grad():
            yb = layer_t.apply(teacher, xb)

        def loss_fn(p, xx, yy):
            loss = ((layer_t.apply(p, xx) - yy) ** 2).mean()
            return loss, loss

        step = make_sgd_step(loss_fn, lr=FUSED_LR)
        p = layer_t.init(torch.Generator().manual_seed(args.seed),
                         device=device)
        if torch.device(device).type == "cuda":
            reset_launches()
        losses = []
        for _ in range(steps):
            p, (loss, _) = step(p, xb, yb)
            losses.append(loss)
        return p, losses

    t0 = time.perf_counter()
    p_card, losses = fused_training(dev, FUSED_STEPS)
    torch.cuda.synchronize()
    fused_train_s = time.perf_counter() - t0
    launches["train_fused"] = dict(givens_mesh.LAUNCHES)
    losses = [float(v) for v in losses]
    check(all(np.isfinite(losses)), f"non-finite fused losses {losses}")
    check(min(losses) < 0.5 * losses[0], f"the fused layer's loss did not "
          f"halve in {FUSED_STEPS} steps: {losses}")
    expect = {**{k: 0 for k in givens_mesh.LAUNCHES},
              "rfnn_fwd_res": FUSED_STEPS, "rfnn_bwd": FUSED_STEPS}
    check(launches["train_fused"] == expect, f"training must launch B4 and B5 "
          f"once per step and nothing else: {launches['train_fused']}")
    p20_card, _ = fused_training(dev, 20)
    p20_cpu, _ = fused_training("cpu", 20)
    d_fused = max_tree_diff(p20_card, p20_cpu)
    check(d_fused <= 1e-5, f"fused training card vs CPU after 20 steps: "
          f"{d_fused}")
    first_half = next(i for i, v in enumerate(losses) if v < 0.5 * losses[0])
    print(f"[8] AnalogLinear(8, 8, abs, table1, PROTOTYPE) learns a seeded "
          f"teacher (SGD, lr {FUSED_LR}, batch {FUSED_BATCH}) on the card: "
          f"{FUSED_STEPS} steps in {fused_train_s:.2f} s, loss "
          f"{losses[0]:.6f} -> {losses[-1]:.6f} (below half first at step "
          f"{first_half}); 20 steps card vs CPU params max |diff| "
          f"{d_fused:.2e} (bound 1e-5); launches {launches['train_fused']}",
          flush=True)
    report["train_fused"] = {"losses": losses, "seconds": fused_train_s,
                             "card_vs_cpu_20_steps": d_fused,
                             "launches": launches["train_fused"]}

    # -- phase 9: times at n = 8 -----------------------------------------------
    n = 8
    plan = mesh_lib.clements_plan(n)
    sched = schedule.clements_schedule(n)
    mp = {k: v.to(dev) for k, v in params_for(n, 3).items()}
    coef = ops._mesh_coefficients(sched, mp, None, None)
    par = schedule.parity_array(sched, dev)
    mat = mesh_lib.mesh_matrix(plan, mp)          # the yardstick's matrix
    pairs = sum(n // 2 - p for p in sched.parity)  # rotated pairs per row
    x = rand_x(rng, 1000, n)
    torch.testing.assert_close(torch.matmul(x, mat.T),
                               givens_mesh.mesh_forward(coef, par, x),
                               rtol=0, atol=1e-5 * n)  # the same function
    g = rand_x(rng, 1000, n)
    torch.testing.assert_close(   # dx = M^H g per row: the same function
        torch.matmul(g, mat.conj()),
        givens_mesh.launch_backward(coef, par, givens_mesh.launch(coef, par, x),
                                    g)[1], rtol=0, atol=1e-5 * n)

    def bound(nbytes, flops):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOP_PER_S * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                     else "operations")

    rows = []
    for b in (64, 1000, 65536):
        x = rand_x(rng, b, n)
        iters = 200 if b < 65536 else 100
        k_ms = cuda_ms(torch, lambda: givens_mesh.mesh_forward(coef, par, x),
                       iters)
        kd_ms = device_ms(torch, lambda: givens_mesh.mesh_forward(
            coef, par, x), 100)
        p_ms = cuda_ms(torch, lambda: givens_mesh.mesh_forward_plain(
            coef, par, x), 20)
        a_ms = cuda_ms(torch, lambda: ops.mesh_apply(
            mp, x, n=n, hardware=PROTOTYPE), 50)
        l_ms = cuda_ms(torch, lambda: torch.matmul(x, mat.T), iters)
        ld_ms = device_ms(torch, lambda: torch.matmul(x, mat.T), 100)
        nbytes = 2 * b * n * 8 + coef.numel() * 4 + par.numel() * 4
        flops = FLOPS_PER_PAIR * b * pairs
        bound_ms, bound_by = bound(nbytes, flops)
        row = {"B": b, "kernel_ms": k_ms, "kernel_device_ms": kd_ms,
               "plain_ms": p_ms, "mesh_apply_ms": a_ms, "matmul_ms": l_ms,
               "matmul_device_ms": ld_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "bytes": nbytes, "flops": flops}
        rows.append(row)
        print(f"[9] {card} | mesh_fwd n=8 B={b}: kernel {k_ms:.5f} ms per "
              f"call, {kd_ms:.5f} ms on the device; bound {bound_ms:.6f} ms "
              f"({bound_by}); plain {p_ms:.4f} ms per call; mesh_apply "
              f"{a_ms:.4f} ms; matmul {l_ms:.5f} ms per call, {ld_ms:.5f} ms "
              f"on the device", flush=True)
    report["timings_n8"] = rows

    rows_bwd = []
    for b in (SGD_BATCH, 1000, 65536):
        x, g = rand_x(rng, b, n), rand_x(rng, b, n)
        y = givens_mesh.launch(coef, par, x)
        iters = 200 if b < 65536 else 100
        k_ms = cuda_ms(torch, lambda: givens_mesh.launch_backward(
            coef, par, y, g), iters)
        kd_ms = device_ms(torch, lambda: givens_mesh.launch_backward(
            coef, par, y, g), 100)
        p_ms = cuda_ms(torch, lambda: givens_mesh.mesh_backward_plain(
            coef, par, y, g), 10)
        l_ms = cuda_ms(torch, lambda: torch.matmul(g, mat.conj()), iters)
        ld_ms = device_ms(torch, lambda: torch.matmul(g, mat.conj()), 100)
        # read y and g, write dx; read coef and parity, write dcoef
        nbytes = 3 * b * n * 8 + 2 * coef.numel() * 4 + par.numel() * 4
        flops = FLOPS_PER_PAIR_BWD * b * pairs \
            + FLOPS_PER_CELL_INV * coef.shape[0] * coef.shape[2]
        bound_ms, bound_by = bound(nbytes, flops)
        row = {"B": b, "kernel_ms": k_ms, "kernel_device_ms": kd_ms,
               "plain_ms": p_ms, "matmul_dx_only_ms": l_ms,
               "matmul_dx_only_device_ms": ld_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "bytes": nbytes, "flops": flops}
        rows_bwd.append(row)
        print(f"[9] {card} | mesh_bwd n=8 B={b}: kernel {k_ms:.5f} ms per "
              f"call, {kd_ms:.5f} ms on the device; bound {bound_ms:.6f} ms "
              f"({bound_by}); plain {p_ms:.4f} ms per call; matmul for the dx "
              f"half alone {l_ms:.5f} ms per call, {ld_ms:.5f} ms on the "
              f"device", flush=True)
    report["timings_bwd_n8"] = rows_bwd
    step_ms_mean = sum(step_ms["noiseless"]) / len(step_ms["noiseless"])
    print(f"[9] {card} | SGD step, MnistRFNN(PROTOTYPE, table1), batch 10: "
          f"{step_ms_mean:.3f} ms, {1e3 / step_ms_mean:.1f} steps/s "
          f"(noiseless, mean of two runs of 50 steps)", flush=True)

    # the fused layer at n = 8: B3 on the programmed processor's
    # coefficients (Reck V and U, 13 columns each), B4 and B5 on the trained
    # layer's (Clements, PROTOTYPE, Table-I phases)
    def layer_inputs(layer, params):
        with torch.no_grad():
            v_p, u_p = layer._quant(params["v"]), layer._quant(params["u"])
            sv = schedule.schedule_from_plan(layer.v_plan)
            su = schedule.schedule_from_plan(layer.u_plan)
            return [ops._mesh_coefficients(sv, v_p, layer.hardware, None),
                    schedule.parity_array(sv, dev),
                    ops._mesh_coefficients(su, u_p, layer.hardware, None),
                    schedule.parity_array(su, dev),
                    ops._gains(torch.sigmoid(params["atten_logit"]),
                               torch.nn.functional.softplus(params["log_scale"]),
                               v_p, u_p, 8, dev)]

    def realized(layer, params):
        """The complex 8x8 matrix of the layer's linear half (no |.|)."""
        with torch.no_grad():
            eye = torch.eye(8, dtype=torch.complex64, device=dev)
            return dataclasses.replace(layer, output="complex").apply(
                params, eye).T.contiguous()

    def cells(coef, par):
        """The cells this mesh's data needs: every pair slot except the
        parity-1 wrap slot and the identity slots that pad a Reck program's
        columns."""
        eye = torch.tensor([1, 0, 0, 0, 0, 0, 1, 0], dtype=coef.dtype,
                           device=coef.device)[:, None]
        real = ~(coef == eye).all(1)
        real[par == 1, -1] = False
        return int(real.sum())

    def fused_bound(name, inputs, b):
        coef_bytes = 4 * sum(inputs[k].numel() for k in range(4))
        gain_bytes = 4 * inputs[4].numel()
        pairs = cells(inputs[0], inputs[1]) + cells(inputs[2], inputs[3])
        if name == "rfnn_bwd":  # read v, u, gout and the coefficients; write
            # dx, dcv, dcu and dg
            nbytes = b * n * (8 + 8 + 4 + 8) + 2 * coef_bytes + 2 * gain_bytes
            flops = FLOPS_PER_PAIR_BWD * b * pairs \
                + FLOPS_PER_CHANNEL_FUSED_BWD * b * n + FLOPS_PER_CELL_INV * pairs
        else:  # read x and the coefficients; write out (and v, u for B4)
            nbytes = b * n * (8 + 4) + coef_bytes + gain_bytes
            if name == "rfnn_fwd_res":
                nbytes += 2 * b * n * 8
            flops = FLOPS_PER_PAIR * b * pairs + FLOPS_PER_CHANNEL_FUSED * b * n
        return (*bound(nbytes, flops), nbytes, flops)

    proc_in = layer_inputs(proc, proc_params)
    train_in = layer_inputs(layer_t, p_card)
    mats = {"processor": realized(proc, proc_params),
            "training": realized(layer_t, p_card)}
    rows_fused = []
    for name, layer_name, inputs, batches in (
            ("rfnn_fwd", "processor", proc_in, (1000, PROC_BATCH, 65536)),
            ("rfnn_fwd", "training", train_in, (FUSED_BATCH,)),
            ("rfnn_fwd_res", "training", train_in, (FUSED_BATCH,)),
            ("rfnn_bwd", "training", train_in, (FUSED_BATCH,))):
        for b in batches:
            x = rand_x(rng, b, n)
            iters = 200 if b < 65536 else 100
            if name == "rfnn_bwd":
                _, v, u = givens_mesh.launch_rfnn(*inputs, x, save_stages=True)
                g = torch.rand(b, n, device=dev)
                gc = rand_x(rng, b, n)
                mat = mats["training"]
                call = lambda: givens_mesh.launch_rfnn_backward(  # noqa: E731
                    *inputs, v, u, g)
                plain = lambda: givens_mesh.rfnn_backward_plain(  # noqa: E731
                    *inputs, v, u, g)
                lib = lambda: torch.matmul(gc, mat.conj())  # noqa: E731
            else:
                save = name == "rfnn_fwd_res"
                mat = mats[layer_name]
                call = lambda: givens_mesh.launch_rfnn(  # noqa: E731
                    *inputs, x, save_stages=save)
                plain = lambda: givens_mesh.rfnn_forward_plain(  # noqa: E731
                    *inputs, x)
                lib = lambda: torch.matmul(x, mat.T)  # noqa: E731
            k_ms = cuda_ms(torch, call, iters)
            kd_ms = device_ms(torch, call, 100)
            p_ms = cuda_ms(torch, plain, 10)
            l_ms = cuda_ms(torch, lib, iters)
            ld_ms = device_ms(torch, lib, 100)
            bound_ms, bound_by, nbytes, flops = fused_bound(name, inputs, b)
            rows_fused.append({"kernel": name, "layer": layer_name, "B": b,
                               "kernel_ms": k_ms,
                               "kernel_device_ms": kd_ms, "plain_ms": p_ms,
                               "matmul_ms": l_ms, "matmul_device_ms": ld_ms,
                               "bound_ms": bound_ms, "bound_by": bound_by,
                               "bytes": nbytes, "flops": flops,
                               "columns": [inputs[0].shape[0],
                                           inputs[2].shape[0]]})
            half = "the dx half" if name == "rfnn_bwd" else "the linear half"
            print(f"[9] {card} | {name} n=8 B={b} ({layer_name}; Cv, Cu = "
                  f"{inputs[0].shape[0]}, {inputs[2].shape[0]}): kernel "
                  f"{k_ms:.5f} ms per call, {kd_ms:.5f} ms on the device; bound "
                  f"{bound_ms:.6f} ms ({bound_by}); plain {p_ms:.4f} ms per "
                  f"call; matmul for {half} alone {l_ms:.5f} ms per call, "
                  f"{ld_ms:.5f} ms on the device", flush=True)
    report["timings_fused_n8"] = rows_fused

    fused_step = make_sgd_step(lambda p, xx, yy: (
        ((layer_t.apply(p, xx) - yy) ** 2).mean(),) * 2, lr=FUSED_LR)
    xb = torch.from_numpy(np.random.default_rng(args.seed).normal(
        size=(FUSED_BATCH, 8)).astype(np.float32)).to(dev)
    with torch.no_grad():
        yb = layer_t.apply(p_card, xb)
    state = {"p": layer_t.init(torch.Generator().manual_seed(args.seed + 2))}

    def fused_steps(k=50):
        for _ in range(k):
            state["p"], (loss, _) = fused_step(state["p"], xb, yb)
        return loss

    fused_steps(5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = fused_steps()
    torch.cuda.synchronize()
    fused_step_ms = (time.perf_counter() - t0) * 1e3 / 50
    check(bool(torch.isfinite(loss)), "non-finite fused SGD loss")
    per_step, busy_us, ours_us = profile_steps(
        torch, fused_steps, 20, ("rfnn_fwd_kernel", "rfnn_bwd_kernel",
                                 "reduce_partials"))
    check(ours_us["rfnn_fwd_kernel"] > 0 and ours_us["rfnn_bwd_kernel"] > 0,
          f"the profiled fused SGD steps show no fused kernel: {ours_us}")
    print(f"[9] {card} | SGD step, AnalogLinear(8, 8, abs, table1, PROTOTYPE), "
          f"batch {FUSED_BATCH}: {fused_step_ms:.3f} ms, "
          f"{1e3 / fused_step_ms:.1f} steps/s (50 steps); profiler: "
          f"{per_step:.0f} device events and {busy_us:.1f} us of device time "
          f"per step ({100 * busy_us / (fused_step_ms * 1e3):.1f}%), fused "
          f"kernels per step (us) {ours_us}", flush=True)
    report["fused_sgd_step"] = {"ms": fused_step_ms,
                                "device_events_per_step": per_step,
                                "device_busy_us_per_step": busy_us,
                                "fused_kernels_us_per_step": ours_us}

    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    # -- phase 10: the kernels line and the device line ------------------------
    main_path = ("mnist", "train_mnist", "rfnn2x2", "train_rfnn2x2", "serving",
                 "processor_apply", "processor_program", "train_fused")
    fwd = next(r for r in rows if r["B"] == 1000)        # the MNIST test batch
    bwd = next(r for r in rows_bwd if r["B"] == SGD_BATCH)  # the SGD step
    kernels = [{
        "name": "mesh_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mesh_fwd.cu",
        "replaces": "src/repro/kernels/givens_mesh.py:109",
        "launches": sum(launches[k]["mesh_fwd"] for k in main_path),
        "max_abs_err": main_err,
        "ms": fwd["kernel_device_ms"],
        "plain_ms": fwd["plain_ms"],
        "bound_ms": fwd["bound_ms"],
        "bound_by": fwd["bound_by"],
        "library_ms": fwd["matmul_device_ms"],
    }, {
        "name": "mesh_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mesh_bwd.cu",
        "replaces": "src/repro/kernels/givens_mesh.py:321",
        "launches": sum(launches[k]["mesh_bwd"] for k in main_path),
        "max_abs_err": main_err_bwd,
        "ms": bwd["kernel_device_ms"],
        "plain_ms": bwd["plain_ms"],
        "bound_ms": bwd["bound_ms"],
        "bound_by": bwd["bound_by"],
        # no single PyTorch call computes (dcoef, dx): torch.matmul(g, M^*)
        # is the dx half alone
        "library_ms": bwd["matmul_dx_only_device_ms"],
    }]
    # B3 at the programmed processor's batch, B4 and B5 at the training step's
    fused_rows = {"rfnn_fwd": ("processor", PROC_BATCH,
                               "src/repro_torch/kernels/csrc/rfnn_fwd.cu",
                               "src/repro/kernels/givens_mesh.py:174"),
                  "rfnn_fwd_res": ("training", FUSED_BATCH,
                                   "src/repro_torch/kernels/csrc/rfnn_fwd.cu",
                                   "src/repro/kernels/givens_mesh.py:370"),
                  "rfnn_bwd": ("training", FUSED_BATCH,
                               "src/repro_torch/kernels/csrc/rfnn_bwd.cu",
                               "src/repro/kernels/givens_mesh.py:416")}
    for name, (layer_name, b, source, replaces) in fused_rows.items():
        row = next(r for r in rows_fused if r["kernel"] == name
                   and r["layer"] == layer_name and r["B"] == b)
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": sum(launches[k][name] for k in main_path),
            "max_abs_err": report["main_path_max_abs_err_fused"][name],
            "ms": row["kernel_device_ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            # torch.matmul of the realized matrix: the linear half alone for
            # B3/B4 (no |.|), the dx half alone for B5 (no coefficient or
            # gain gradients)
            "library_ms": row["matmul_device_ms"],
        })
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} never launched on the main path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
