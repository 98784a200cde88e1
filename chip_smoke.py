#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one card and check it.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (``$CUDA_HOME``, ``PATH`` or
``/usr/local/cuda``) and the repository's ``src/`` beside this file; it
imports nothing of JAX.  Phases (each raises on failure, so the script
exits non-zero):

1. card name and power limit; build the CUDA kernel from ``csrc/``;
2. the mesh kernel against its plain PyTorch version on the card, for
   n in {2, 8, 16, 64, 128}, B in {1, 7, 130, 4096}, ideal and PROTOTYPE
   coefficients, a mixed-parity schedule and the main path's own shapes
   (atol 1e-5 * n: FMA contraction and another order of adds);
3. ``MnistRFNN`` (8x8 analog mesh, PROTOTYPE hardware, Table-I phases) at
   full width on 1000 procedural digits: kernel-path logits against the
   reference backend on the card and the plain path on the CPU;
4. the 2x2 RFNN decision maps on the kernel path against the two pinned
   goldens of the JAX package (2e-5), and a 41x41 map;
5. ``ServingEngine`` on the deployed 8x8 processor: 256 requests through
   ``run()`` and through the dispatch thread, each equal to a direct apply;
6. times at n = 8 with CUDA events: the kernel (per call, and on the
   device alone), its bound, the plain version, the whole ``mesh_apply``
   and a ``torch.matmul`` yardstick;
7. the ``kernels`` line and, last, the ``ok``/``device`` line.

Launch counts are reset just before phases 3, 4 and 5 and read just after;
launches made in phases 2 and 6 do not count.  Timings are also written to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12        # H100 SXM data sheet, float32 outside tensor cores
FLOPS_PER_PAIR = 28            # two outputs x (2 complex mul + 1 complex add)

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


def main() -> int:
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

    from repro_torch.core import mesh as mesh_lib
    from repro_torch.core.analog_linear import AnalogUnitary
    from repro_torch.core.hardware import IDEAL
    from repro_torch.data.digits import load_digits
    from repro_torch.kernels import cuda_build, givens_mesh, ops, schedule
    from repro_torch.paper.mnist_rfnn import MnistRFNN
    from repro_torch.paper.prototype import PROTOTYPE
    from repro_torch.paper.rfnn2x2 import RFNN2x2, decision_map
    from repro_torch.serving import Request, ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    report: dict = {"device": kind}

    # -- phase 1: card and build ------------------------------------------
    card = card_line()
    print(card, flush=True)
    report["card"] = card
    t0 = time.perf_counter()
    cuda_build.load("mesh_fwd")
    build_s = time.perf_counter() - t0
    print(f"[1] built mesh_fwd.cu in {build_s:.2f} s", flush=True)
    report["build_s"] = build_s

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

    launches: dict[str, int] = {}

    # -- phase 3: MNIST RFNN at full width ------------------------------------
    _, _, x_te, y_te = load_digits(n_train=0, n_test=1000, seed=0)
    model = MnistRFNN(analog=True, hardware=PROTOTYPE, quantize="table1")
    params = model.init(torch.Generator().manual_seed(0))
    check(params["w1"].device.type == "cuda", "MnistRFNN.init not on cuda")
    givens_mesh.LAUNCHES["mesh_fwd"] = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        logits = model.apply(params, x_te)
    torch.cuda.synchronize()
    mnist_s = time.perf_counter() - t0
    launches["mnist"] = givens_mesh.LAUNCHES["mesh_fwd"]
    check(launches["mnist"] >= 1, "MNIST apply never launched mesh_fwd")
    check(tuple(logits.shape) == (1000, 10), f"logits {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    with torch.no_grad():
        ref = MnistRFNN(hardware=PROTOTYPE, quantize="table1",
                        backend="reference").apply(params, x_te)
        cpu = model.apply({k: (v.cpu() if torch.is_tensor(v) else
                               {kk: vv.cpu() for kk, vv in v.items()})
                           for k, v in params.items()}, x_te)
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
          f"mesh_fwd launches {launches['mnist']}", flush=True)
    report["mnist"] = {"max_abs_vs_reference": d_ref, "max_abs_vs_cpu": d_cpu,
                       "first_apply_ms": mnist_s * 1e3,
                       "steady_apply_ms": steady_ms,
                       "launches": launches["mnist"]}

    # -- phase 4: the 2x2 RFNN on the kernel path ------------------------------
    p2 = {"w": np.asarray([0.9, -1.1], np.float32), "b": np.float32(0.2)}
    givens_mesh.LAUNCHES["mesh_fwd"] = 0
    for hw, golden in ((IDEAL, GOLDEN_2X2_MAP), (PROTOTYPE,
                                                 GOLDEN_2X2_MAP_PROTO)):
        grid, zmap = decision_map(RFNN2x2(hardware=hw), p2, 3, 5, lim=30.0,
                                  n=5)
        np.testing.assert_allclose(grid, np.linspace(0.0, 30.0, 5), atol=0)
        np.testing.assert_allclose(zmap, np.asarray(golden, np.float32),
                                   atol=2e-5)
    _, zk = decision_map(RFNN2x2(), p2, 1, 4, n=41)
    launches["rfnn2x2"] = givens_mesh.LAUNCHES["mesh_fwd"]
    check(launches["rfnn2x2"] >= 3, "2x2 maps did not launch mesh_fwd")
    _, zr = decision_map(RFNN2x2(backend="reference"), p2, 1, 4, n=41)
    check(zk.shape == (41, 41), f"41x41 map shape {zk.shape}")
    np.testing.assert_allclose(zk, zr, atol=2e-5)
    print(f"[4] 2x2 goldens (IDEAL, PROTOTYPE) ok on the kernel path; 41x41 "
          f"map == reference ({float(np.abs(zk - zr).max()):.1e}); mesh_fwd "
          f"launches {launches['rfnn2x2']}", flush=True)

    # -- phase 5: serving the deployed 8x8 processor ---------------------------
    proc = AnalogUnitary(n=8, hardware=PROTOTYPE, quantize="table1",
                         output="abs")
    pparams = proc.init(torch.Generator().manual_seed(1))
    feats = np.random.default_rng(2).normal(size=(256, 8)).astype(np.float32)
    with torch.no_grad():
        direct = [proc.apply(pparams, torch.from_numpy(feats[i:i + 1]))
                  .cpu().numpy()[0] for i in range(256)]
    givens_mesh.LAUNCHES["mesh_fwd"] = 0
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
    launches["serving"] = givens_mesh.LAUNCHES["mesh_fwd"]
    check(launches["serving"] >= 8, "serving did not launch mesh_fwd per tick")
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
    print(f"[5] engine: 256 requests via run() and via the dispatch thread "
          f"== direct apply (max diff {worst_req:.1e}); mesh_fwd launches "
          f"{launches['serving']}", flush=True)
    print(f"[5] run() stats {json.dumps(sync_stats)}", flush=True)
    print(f"[5] thread stats {json.dumps(threaded.stats)}", flush=True)
    report["serving"] = {"run": sync_stats, "thread": threaded.stats,
                         "max_diff_vs_direct": worst_req,
                         "launches": launches["serving"]}

    # -- phase 6: times at n = 8 -----------------------------------------------
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
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOP_PER_S * 1e3
        row = {"B": b, "kernel_ms": k_ms, "kernel_device_ms": kd_ms,
               "plain_ms": p_ms, "mesh_apply_ms": a_ms, "matmul_ms": l_ms,
               "matmul_device_ms": ld_ms,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": nbytes, "flops": flops}
        rows.append(row)
        print(f"[6] {card} | n=8 B={b}: kernel {k_ms:.5f} ms per call, "
              f"{kd_ms:.5f} ms on the device; bound {row['bound_ms']:.6f} ms "
              f"({row['bound_by']}); plain {p_ms:.4f} ms per call (it reads "
              f"the parities back to the host); mesh_apply "
              f"{a_ms:.4f} ms; matmul {l_ms:.5f} ms per call, {ld_ms:.5f} ms "
              f"on the device", flush=True)
    report["timings_n8"] = rows

    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    # -- phase 7: the kernels line and the device line -------------------------
    main = next(r for r in rows if r["B"] == 1000)   # the MNIST test batch
    kernels = [{
        "name": "mesh_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mesh_fwd.cu",
        "replaces": "src/repro/kernels/givens_mesh.py:109",
        "launches": sum(launches.values()),
        "max_abs_err": main_err,
        "ms": main["kernel_device_ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["matmul_device_ms"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
