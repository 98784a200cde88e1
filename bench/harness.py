"""One run of one cell: find it by name, check the card, run its driver,
read its metrics and print the result.

Everything that belongs to one configuration, traffic mix, cell or metric
is a file found by its name in ``BENCHMARK.json``:

* ``bench/configs/<config>.json``: the configuration as it is run;
* ``bench/traffic/<traffic>.json``: the mix's parameters, naming the
  driver (``bench/drivers/<driver>.py``) that runs that kind of traffic;
* ``bench/workloads/<cell>.json``: the cell's limits on the numbers
  compared for ``correct``;
* ``bench/metrics/<metric>.py``: a reader with ``read(records)`` returning
  the metric's value, or None where the run has nothing to read.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: top-level module names that may not be loaded in a run, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class BenchError(Exception):
    """A cell, a file or an argument the harness cannot run."""


def eprint(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    try:
        return json.loads(path.read_text())
    except FileNotFoundError:
        raise BenchError(f"missing {path.relative_to(ROOT)}") from None


def cell_spec(workload: str, root: Path = ROOT) -> dict:
    """The cell ``workload`` of ``BENCHMARK.json`` with its configuration,
    traffic, limits and the metrics it reports (``end_to_end`` and
    ``per_layer`` entries)."""
    bench = root / "bench"
    spec = load_json(root / "BENCHMARK.json")
    by_name = {w["name"]: w for w in spec["workloads"]}
    if workload not in by_name:
        raise BenchError(f"no workload {workload!r} in BENCHMARK.json")
    w = by_name[workload]
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in names)]
    return {"workload": w,
            "config": load_json(bench / "configs" / f"{w['config']}.json"),
            "traffic": load_json(bench / "traffic" / f"{w['traffic']}.json"),
            "cell": load_json(bench / "workloads" / f"{workload}.json"),
            "end_to_end": e2e, "per_layer": per_layer}


@dataclasses.dataclass
class Check:
    """One number compared for ``correct`` and its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    """What a driver hands back: the records the metric readers read, the
    checks, the work attempted and failed, and the device's memory peak."""

    records: dict
    checks: list
    attempted: int
    failed: int
    memory_peak_bytes: int

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks)


def process_start(t_main: float) -> float:
    """The process's start on the ``time.perf_counter`` clock, from
    ``/proc/self/stat``; ``t_main`` where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return t_main
    return time.perf_counter() - max(age, 0.0)


class RunContext:
    """The run's device, seed, window and clock, for the drivers."""

    def __init__(self, device, seed: int, seconds: float, trace: bool,
                 t_start: float):
        import torch

        self.torch = torch
        self.device = torch.device(device)
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.t_start = t_start
        self.setup_s = None
        self.setup_peak = 0

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    @staticmethod
    def now() -> float:
        return time.perf_counter()

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize(self.device)

    def mark(self):
        """An event recorded on the stream now (None off the card)."""
        if not self.cuda:
            return None
        ev = self.torch.cuda.Event()
        ev.record()
        return ev

    @staticmethod
    def wait(mark) -> None:
        if mark is not None:
            mark.synchronize()

    def log(self, what: str) -> None:
        """A set-up stage's end, on standard error with the seconds since
        the process started."""
        eprint(f"bench: {what} at {self.now() - self.t_start:.3f} s")

    def window_starts(self) -> float:
        """Ends the set-up: ``setup_s`` runs from the process's start to
        here.  Resets the device's memory peak for the window."""
        self.sync()
        if self.cuda:
            self.setup_peak = self.window_peak_bytes()
            self.torch.cuda.reset_peak_memory_stats(self.device)
        t = self.now()
        self.setup_s = t - self.t_start
        return t

    def window_peak_bytes(self) -> int:
        """The device's allocated peak since the window started."""
        if not self.cuda:
            return 0
        return int(self.torch.cuda.max_memory_allocated(self.device))

    def peak_bytes(self) -> int:
        """The device's allocated peak over the run so far."""
        return max(self.setup_peak, self.window_peak_bytes())

    def profile(self, fn):
        """``fn()`` under the profiler: a ``devtrace.Trace``, or None off
        the card (nothing ran on a device)."""
        from bench import devtrace

        return devtrace.profile(self.torch, fn, self.sync, self.cuda)

    def sub_seed(self, *path: int) -> int:
        """A seed for one purpose (``path``), drawn from the run's seed."""
        import numpy as np

        ss = np.random.SeedSequence(self.seed, spawn_key=tuple(path))
        return int(ss.generate_state(1, np.uint64)[0] >> 1)


def run_cell(spec: dict, ctx: RunContext) -> Outcome:
    """Run the cell's driver once."""
    name = spec["traffic"]["driver"]
    driver = importlib.import_module(f"bench.drivers.{name}")
    return driver.run(spec["config"], spec["traffic"], spec["cell"], ctx)


def read_metric(name: str, records: dict, bench: Path = BENCH):
    """``bench/metrics/<name>.py``'s ``read(records)``: a number or None."""
    path = bench / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    if mod_spec is None or not path.exists():
        raise BenchError(f"no reader {path.relative_to(ROOT)}")
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    value = mod.read(records)
    return None if value is None else float(value)


def foreign_modules() -> list[str]:
    """Loaded modules of the JAX package or its libraries (whole top-level
    names) or from ``benchmarks/``."""
    found = set()
    other = str(ROOT / "benchmarks") + os.sep
    for name, mod in list(sys.modules.items()):
        if name.split(".", 1)[0] in FORBIDDEN:
            found.add(name)
        path = getattr(mod, "__file__", None)
        if path and os.path.abspath(path).startswith(other):
            found.add(name)
    return sorted(found)


def result_line(spec: dict, out: Outcome, ctx: RunContext,
                kind: str) -> dict:
    """The result object; ``checks`` comes last."""
    metrics = {}
    wanted = spec["per_layer"] if ctx.trace else spec["end_to_end"]
    for m in wanted:
        value = read_metric(m["name"], out.records)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if ctx.cuda else ctx.device.type,
              "kind": kind, "count": spec["workload"]["chips"],
              "memory_peak_bytes": out.memory_peak_bytes}
    result = {"correct": out.correct, "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics, "device": device}
    trace = out.records.get("trace")
    if ctx.trace and trace is not None:
        device["busy_s"] = trace.busy_s
        device["window_s"] = trace.window_s
        result["breakdown"] = trace.breakdown()
    # a number that is not finite is printed as null (JSON has no NaN)
    result["checks"] = {c.name: {"value": c.value if math.isfinite(c.value)
                                 else None, "limit": c.limit}
                        for c in out.checks}
    return result


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_main: float) -> int:
    t_start = process_start(t_main)
    args = parse(argv)
    try:
        spec = cell_spec(args.workload)
    except BenchError as e:
        eprint(f"bench: {e}")
        return 2
    if importlib.util.find_spec("repro_torch") is None:
        eprint("bench: the program (src/repro_torch) is not in this checkout")
        return 2
    try:
        import torch
    except ImportError as e:
        eprint(f"bench: no PyTorch: {e}")
        return 2
    chips = spec["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        eprint(f"bench: the cell needs {chips} CUDA card(s); "
               f"{torch.cuda.device_count()} found")
        return 3
    # float32 as the configurations state it: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = RunContext("cuda:0", args.seed, args.seconds, bool(args.trace),
                     t_start)
    torch.zeros(1, device=ctx.device)
    ctx.log("CUDA context")
    out = run_cell(spec, ctx)
    found = foreign_modules()
    if found:
        eprint(f"bench: modules of the JAX package or benchmarks/ loaded: "
               f"{found}")
        return 4
    result = result_line(spec, out, ctx, torch.cuda.get_device_name(0))
    for c in out.checks:
        eprint(f"check {c.name} = {c.value!r} (limit {c.limit!r}) "
               f"{'ok' if c.ok else 'FAILED'}")
    print(json.dumps(result), flush=True)
    return 0
