#!/usr/bin/env python3
"""Time the mesh kernels B1 and B2 at chip_smoke.py phase 9's shapes
(``MESH_TIMED``), the fused layer's kernels B3, B4 and B5 at phase 9's
(``FUSED_TIMED``) and the deep-grid kernels B6, B7 and B8 at phase 15's
(``DEEP_TIMED_BATCHES``) on one card, for this checkout's ``src/`` or
another tree's.

    python3 tools/deepgrid_times.py [--src DIR] [--label NAME]

``--src`` names the ``src/`` directory whose ``repro_torch`` is built and
timed (default: the one beside this script), so one call can time an older
tree unpacked beside this one and this one in turns (older, newer, newer,
older: one process each, on the same card).  The meshes are Clements
meshes of chip_smoke's phases (``mesh_params(n, 3)``, ideal cells), x and
the cotangent complex normal.  The fused layers are phase 9's: the
programmed Eq. 31 processor (``AnalogLinear(8, 8, "abs")
.init_from_matrix(W)``, W of phase 7 at seed 0; Reck V and U, 13 columns
each) for B3, and ``AnalogLinear(8, 8, "abs", "table1", PROTOTYPE)`` (seed
0; Clements V and U, 8 columns each) for B3, B4 and B5, B5's cotangent
uniform.  Where the tree has B3/B4's register path
(``givens_mesh.rfnn_fwd_register_plan``), B3 on the processor is also
timed in both layouts (one thread a row and n / 2 lanes a row, whatever
the plan picks) at ``LAYOUT_BATCHES``, and with its identity slots made
live (a -0 written over each identity cell's imaginary t00: the same
values, every slot swept) in both layouts, which is what the identity
skip saves.  The grids are chip_smoke.py's (``build_deep_grid``,
``DEEP_TIMED_BATCHES``): the 4-layer 64x64 cascade (seed 40), the depth-4
MNIST grid (n = 8, one tile, PROTOTYPE, seed 41) and
``TiledAnalogLinear(64, 64, 16)`` (seed 3).
Device ms come from chip_smoke's ``device_ms`` (the stream held while the
host queues).  Where the tree reports a kernel's launch plan
(``givens_mesh.mesh_fwd_plan``, ``mesh_bwd_plan``, ``rfnn_fwd_plan``,
``rfnn_bwd_plan``, ``deepgrid_fwd_plan``, ``deepgrid_bwd_plan``), the line
carries it.  Prints one line per reading and writes them all to
``chiprun_out/deepgrid_times_<label>.json``.  Needs a CUDA card and
``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

# B3's batches on the processor for the layout comparison: phase 9's and
# the batches between them
LAYOUT_BATCHES = (1000, 4096, 8192, 16384, 32768, 65536)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="tree")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("deepgrid_times: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    import repro_torch.core  # noqa: F401  (first: the kernels import it)
    from repro_torch.core.analog_linear import AnalogLinear, TiledAnalogLinear
    from repro_torch.kernels import givens_mesh, ops, schedule
    from repro_torch.paper.prototype import PROTOTYPE

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = chip_smoke.card_line()
    tiled = TiledAnalogLinear(64, 64, tile_size=16, quantize="table1",
                              output="abs")
    tparams = tiled.init(torch.Generator().manual_seed(3), device=dev)
    packs = {
        "cascade_64x64_l4": (chip_smoke.build_deep_grid(
            dev, 16, 4, 4, 4, 40, reck="all")[2], True),
        "mnist_depth4": (chip_smoke.build_deep_grid(
            dev, 8, 4, 1, 1, 41, hw=PROTOTYPE)[2], True),
        "tiled_64x64": (ops.pack_tile_grid(tiled._tile_args(tparams), n=16),
                        False)}
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []

    def report(row, line, plan_fn, *plan_args):
        if hasattr(givens_mesh, plan_fn):
            row["plan"] = getattr(givens_mesh, plan_fn)(*plan_args)
            line += f"; plan {row['plan']}"
        rows.append(row)
        print(line, flush=True)

    for name, shapes in chip_smoke.MESH_TIMED.items():
        for n, b in shapes:
            sched = schedule.clements_schedule(n)
            coef = ops._mesh_coefficients(
                sched, {k: v.to(dev) for k, v in
                        chip_smoke.mesh_params(n, 3).items()}, None, None)
            par = schedule.parity_array(sched, dev)
            x = torch.randn(b, n, dtype=torch.complex64, device=dev,
                            generator=gen)
            if name == "mesh_bwd":
                y = givens_mesh.launch(coef, par, x)
                g = torch.randn(b, n, dtype=torch.complex64, device=dev,
                                generator=gen)
                fn = lambda: givens_mesh.launch_backward(  # noqa: E731
                    coef, par, y, g)
            else:
                fn = lambda: givens_mesh.launch(coef, par, x)  # noqa: E731
            row = {"label": args.label, "card": card, "kernel": name,
                   "shape": f"mesh_n{n}", "n": n, "B": b,
                   "columns": coef.shape[0],
                   "device_ms": chip_smoke.device_ms(torch, fn, 200),
                   "call_ms": chip_smoke.cuda_ms(torch, fn, 200)}
            report(row, f"[{args.label}] {card} | {name} n={n} B={b}: "
                   f"{row['device_ms']:.5f} ms on the device, "
                   f"{row['call_ms']:.5f} ms per call", f"{name}_plan", b, n,
                   coef.shape[0])

    layer = AnalogLinear(8, 8, output="abs", quantize="table1",
                         hardware=PROTOTYPE)
    proc = AnalogLinear(8, 8, output="abs")
    fused_in = {
        "training": chip_smoke.fused_layer_inputs(
            layer, layer.init(torch.Generator().manual_seed(0), device=dev)),
        "processor": chip_smoke.fused_layer_inputs(
            proc, proc.init_from_matrix(
                np.random.default_rng(0).normal(size=(8, 8))))}
    has_layouts = hasattr(givens_mesh, "rfnn_fwd_register_plan")

    def time_fused(name, layer_name, b, inputs, x, tag="", plan=None):
        cv, cu = inputs[0].shape[0], inputs[2].shape[0]
        if name == "rfnn_bwd":
            _, v, u = givens_mesh.launch_rfnn(*inputs, x, save_stages=True)
            g = torch.rand(b, 8, device=dev, generator=gen)
            fn = lambda: givens_mesh.launch_rfnn_backward(  # noqa: E731
                *inputs, v, u, g)
        else:
            kw = {"save_stages": name == "rfnn_fwd_res"}
            if plan is not None:
                kw["plan"] = plan
            fn = lambda: givens_mesh.launch_rfnn(*inputs, x, **kw)  # noqa: E731
        row = {"label": args.label, "card": card, "kernel": name,
               "shape": layer_name + tag, "n": 8, "B": b,
               "columns": [cv, cu],
               "device_ms": chip_smoke.device_ms(torch, fn, 200),
               "call_ms": chip_smoke.cuda_ms(torch, fn, 200)}
        line = (f"[{args.label}] {card} | {name} {layer_name}{tag} n=8 B={b} "
                f"(Cv, Cu = {cv}, {cu}): {row['device_ms']:.5f} ms on the "
                f"device, {row['call_ms']:.5f} ms per call")
        if plan is not None:
            row["plan"] = plan
            rows.append(row)
            print(f"{line}; plan {plan}", flush=True)
        else:
            report(row, line, f"{name}_plan", b, 8, cv, cu)

    for name, layer_name, b in chip_smoke.FUSED_TIMED:
        time_fused(name, layer_name, b, fused_in[layer_name],
                   torch.randn(b, 8, dtype=torch.complex64, device=dev,
                               generator=gen))
    if has_layouts:
        proc_in = fused_in["processor"]
        cv, cu = proc_in[0].shape[0], proc_in[2].shape[0]
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        # the identity slots made live: -0 over each identity cell's
        # imaginary t00 (the identity test is on the bits)
        eye = torch.tensor([1, 0, 0, 0, 0, 0, 1, 0], dtype=torch.float32,
                           device=dev)[:, None]
        swept = list(proc_in)
        for k in (0, 2):
            coef = proc_in[k].clone()
            ident = (coef == eye).all(1)
            coef[:, 1][ident] = -0.0
            swept[k] = coef
        for b in LAYOUT_BATCHES:
            x = torch.randn(b, 8, dtype=torch.complex64, device=dev,
                            generator=gen)
            for lanes in (1, 4):
                plan = givens_mesh.rfnn_fwd_register_plan(b, 8, cv, cu, sms,
                                                          lanes)
                for tag, inputs in (("", proc_in), ("/no_skip", swept)):
                    time_fused("rfnn_fwd", "processor", b, inputs, x,
                               f"/lanes{lanes}{tag}", plan)

    for shape_name, batches in chip_smoke.DEEP_TIMED_BATCHES.items():
        (deep, (cv, cu, gains)), detect = packs[shape_name]
        pv, pu = schedule.deep_grid_parity_arrays(deep, dev)
        inputs = [cv, pv, cu, pu, gains]
        depth, to, ti, c, _, p = cv.shape
        n = 2 * p
        kw = {"detect_last": detect}
        for name, bs in batches.items():
            for b in bs:
                x = torch.randn(b, ti * n, dtype=torch.complex64, device=dev,
                                generator=gen)
                if name == "deepgrid_bwd":
                    _, sv, su = givens_mesh.launch_deepgrid(
                        *inputs, x, save_stages=True, **kw)
                    g = (torch.rand(b, to * n, device=dev, generator=gen)
                         if detect else
                         torch.randn(b, to * n, dtype=torch.complex64,
                                     device=dev, generator=gen))
                    fn = lambda: givens_mesh.launch_deepgrid_backward(  # noqa: E731
                        *inputs, x, sv, su, g, **kw)
                else:
                    save = name == "deepgrid_fwd_res"
                    fn = lambda: givens_mesh.launch_deepgrid(  # noqa: E731
                        *inputs, x, save_stages=save, **kw)
                row = {"label": args.label, "card": card, "kernel": name,
                       "shape": shape_name, "B": b, "columns": c,
                       "device_ms": chip_smoke.device_ms(torch, fn, 200),
                       "call_ms": chip_smoke.cuda_ms(torch, fn, 200)}
                line = (f"[{args.label}] {card} | {name} {shape_name} B={b} "
                        f"(C={c}): {row['device_ms']:.5f} ms on the device, "
                        f"{row['call_ms']:.5f} ms per call")
                if name == "deepgrid_bwd":
                    report(row, line, "deepgrid_bwd_plan", b, n, depth, to,
                           ti, c, detect)
                else:
                    report(row, line, "deepgrid_fwd_plan", b, n, depth, to,
                           ti, c, save)
    out = ROOT / "chiprun_out" / f"deepgrid_times_{args.label}.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
