"""Start a ``torch.distributed`` program's ranks as CPU subprocesses.

Each rank runs ``PRELUDE`` then the test's body with ``python -c``: it
imports only ``torch``, numpy and ``repro_torch``, uses one intra-op thread,
and joins a gloo group initialised from a ``FileStore`` in the test's work
directory (no port, so parallel test workers cannot collide), with a 60 s
timeout on every collective.  The body reads its inputs from, and writes
its results to, that directory (``WORK``).
"""

import os
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"

PRELUDE = r"""
import datetime
import sys

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

torch.set_num_threads(1)
RANK, WORLD, WORK = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", store=dist.FileStore(WORK + "/store", WORLD),
                        rank=RANK, world_size=WORLD,
                        timeout=datetime.timedelta(seconds=60))
"""

EPILOGUE = r"""
dist.destroy_process_group()
print("RANK_OK")
"""


class Ranks:
    """``body`` running on ``world`` ranks; :meth:`join` waits for them and
    fails with every failed rank's log.

    A rank that exits with an error stops the others at once (they would
    wait for it until the collective timeout); all ranks are killed at
    ``timeout`` seconds from the start."""

    def __init__(self, work: Path, body: str, world: int,
                 timeout: float = 150.0):
        env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
                   OMP_NUM_THREADS="1")
        program = PRELUDE + body + EPILOGUE
        self.logs = [work / f"rank{r}.log" for r in range(world)]
        self.deadline = time.monotonic() + timeout
        self.procs = []
        for r in range(world):
            with open(self.logs[r], "w") as out:
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-c", program, str(r), str(world),
                     str(work)],
                    stdout=out, stderr=subprocess.STDOUT, env=env))

    def join(self) -> None:
        procs = self.procs
        try:
            while time.monotonic() < self.deadline:
                codes = [p.poll() for p in procs]
                if all(c is not None for c in codes) or any(
                        c not in (None, 0) for c in codes):
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait(timeout=30)
        text = [log.read_text() for log in self.logs]
        failed = [r for r, p in enumerate(procs)
                  if p.returncode != 0 or "RANK_OK" not in text[r]]
        assert not failed, "\n".join(
            f"--- rank {r} (exit {procs[r].returncode})\n{text[r][-4000:]}"
            for r in failed)
