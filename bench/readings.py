"""The readings that a cell's limits are set from, in one process on the
card: the program's compared numbers over many seeds (short windows, each
run whole: set-up, window, reference) and the control's, the reference put
in the program's place one precision lower (and, for a training cell, the
planted faults), at the cell's own size.  The benchmark's runs do not run
this.

    python3 bench/readings.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 4,5,6 --seconds 3

Prints one JSON line a seed; ``--out <file>`` also writes them there.
"""

import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))

from bench import harness  # noqa: E402


def seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def main(argv) -> int:
    import argparse

    import torch

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=seeds, default=[])
    p.add_argument("--control-seeds", type=seeds, default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", type=Path, default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = harness.cell_spec(args.workload)
    driver = importlib.import_module(
        f"bench.drivers.{spec['traffic']['driver']}")
    lines = []

    def emit(obj):
        lines.append(json.dumps(obj))
        print(lines[-1], flush=True)

    for seed in args.seeds:
        ctx = harness.RunContext("cuda:0", seed, args.seconds, False,
                                 time.perf_counter())
        out = harness.run_cell(spec, ctx)
        emit({"seed": seed, "kind": "program", "correct": out.correct,
              "checks": {c.name: c.value for c in out.checks}})
        del out
        torch.cuda.empty_cache()
    for seed in args.control_seeds:
        ctx = harness.RunContext("cuda:0", seed, args.seconds, False,
                                 time.perf_counter())
        emit({"seed": seed, "kind": "control",
              "readings": driver.control(spec["config"], spec["traffic"],
                                         spec["cell"], ctx)})
        torch.cuda.empty_cache()
    if args.out is not None:
        args.out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
