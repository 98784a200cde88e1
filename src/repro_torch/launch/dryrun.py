"""Multi-pod dry run: build and trace every (arch x shape) cell, the
counterpart of the JAX package's ``repro.launch.dryrun``.

The proof that the distribution config is coherent without the hardware:
a ``"fake"`` process group of 256 (single pod) or 512 (multi-pod) ranks,
over torch's ``FakeStore``, holds the production meshes
(``launch/mesh.make_production_mesh(device_type="cpu")``); every cell's
step runs once on fake tensors laid out as DTensors (``Cell.trace``), and
its per-rank readings are dumped as JSON.  This process is one rank of the
group (the last); every rank holds the same shard shapes up to uneven
splits, which the rules avoid (``resolve_shardings``).

Readings of :func:`run_cell`, all one rank's:

  * ``argument_bytes``, ``output_bytes``: the bytes of the rank's shards of
    the inputs and outputs, exact;
  * ``flops``: the FLOPs of the ops run on the rank's local shards;
  * ``peak_bytes``: ``None``, with the reason in ``peak_error``:
    ``MemTracker`` misses frees on this path (``specs.PEAK_UNREAD``);
  * ``collectives``: the output bytes of the functional collectives
    DTensor issued, by the JAX package's six keys;
  * ``lower_s``, ``compile_s``: the seconds to build the cell and to trace
    it.

The JAX package's ``bytes_accessed`` (XLA's ``cost_analysis``) has no
reading here: nothing compiles, so nothing counts the memory traffic of a
fused program, and it is left out rather than guessed.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

from repro_torch import configs
from repro_torch.launch import specs as specs_lib
from repro_torch.launch.mesh import describe, make_production_mesh


def collective_bytes(readings: dict) -> dict:
    """The JAX package's six keys from a trace's ``collectives`` reading
    (missing kinds 0)."""
    out = {"all-gather": 0, "all-reduce": 0, "reduce-scatter": 0,
           "all-to-all": 0, "collective-permute": 0, "ops": 0}
    out.update(readings)
    return out


def run_cell(arch: str, shape_name: str, mesh, multi_pod: bool,
             verbose: bool = True) -> dict:
    t0 = time.time()
    cell = specs_lib.build_cell(arch, shape_name, mesh, multi_pod=multi_pod)
    arg_bytes = cell.argument_bytes()
    t_build = time.time() - t0
    trace = cell.trace()
    t_trace = time.time() - t0 - t_build
    coll = collective_bytes(trace["collectives"])
    result = {
        "arch": arch, "shape": shape_name, "mesh": describe(mesh),
        "multi_pod": multi_pod,
        "lower_s": round(t_build, 1), "compile_s": round(t_trace, 1),
        "flops": trace["flops"],
        "argument_bytes": arg_bytes,
        "output_bytes": trace["output_bytes"],
        "peak_bytes": trace["peak_bytes"],
        "peak_error": trace["peak_error"],
        "collectives": coll,
    }
    if verbose:
        gb = 1 << 30
        peak = (f"{result['peak_bytes'] / gb:.2f}GiB"
                if result["peak_bytes"] is not None else "n/a")
        print(f"  [OK] {arch} x {shape_name} on {describe(mesh)}: "
              f"build {t_build:.0f}s trace {t_trace:.0f}s | "
              f"args {arg_bytes / gb:.2f}GiB peak {peak} | "
              f"flops/rank {result['flops']:.3g} | "
              f"coll ops {coll['ops']}")
    return result


def fake_group(world: int) -> None:
    """A ``"fake"`` process group of ``world`` ranks (this process the
    last): collectives return at once, shapes are exact."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=world - 1,
                            world_size=world)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)

    if args.all:
        cells = configs.grid()
    else:
        if not args.arch:
            ap.error("--arch or --all required")
        shapes = [args.shape] if args.shape else configs.shapes_for(args.arch)
        cells = [(args.arch, s) for s in shapes]

    import torch.distributed as dist

    mesh_kinds = {"single": [False], "multi": [True],
                  "both": [False, True]}[args.mesh]
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    failures = []
    for multi_pod in mesh_kinds:
        fake_group(512 if multi_pod else 256)
        try:
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        device_type="cpu")
            print(f"== mesh {describe(mesh)} ({mesh.size()} ranks) ==")
            for arch, shape in cells:
                tag = f"{arch}__{shape}__{'multi' if multi_pod else 'single'}"
                try:
                    result = run_cell(arch, shape, mesh, multi_pod)
                    (outdir / f"{tag}.json").write_text(
                        json.dumps(result, indent=1))
                except Exception as e:  # a failure here is a sharding bug
                    failures.append((tag, repr(e)))
                    print(f"  [FAIL] {tag}: {e}")
                    traceback.print_exc(limit=4)
        finally:
            dist.destroy_process_group()

    print(f"\n{len(cells) * len(mesh_kinds) - len(failures)} passed, "
          f"{len(failures)} failed")
    for tag, err in failures:
        print(f"  FAIL {tag}: {err[:200]}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
