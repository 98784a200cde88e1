"""The analog serving engine on torch.

The JAX package's ``serving/engine.py`` for the analog slot family:

  * an (optional) background **dispatch thread** pulls from a bounded
    request queue and drives the device, so callers just ``submit()`` and
    wait on the request's result future;
  * a bounded **admission queue** with a choice of backpressure policy —
    ``"block"`` (submit waits for space) or ``"reject"`` (submit fails
    fast and the request completes as failed);
  * a fixed-slot **tick loop**: every tick admits queued requests into
    free slots and runs ONE fixed-shape device call (the mesh kernel for
    an ``AnalogUnitary`` with ``params=``), then frees the slots;
  * per-request **SLO accounting** (:class:`repro_torch.runtime.slo.SLOTracker`):
    deadlines, served/expired/rejected/recovered counters, p50/p99 tick
    latency, sustained QPS;
  * the **failure-injector hook**: a fired ``tile_down`` swaps in a
    recovered program between ticks and in-flight requests keep draining.

Not ported yet: LM models served through ``decode_step`` (ROADMAP A10) and
the ``mesh=`` data-parallel tick panel (ROADMAP A11); both raise.

Tick ordering is load-bearing for deadline/recovery semantics and is kept
identical to the JAX engine: failures are polled and deadlines expired
against the *pre-increment* tick counter, then the counter advances, then
admission and the device call happen.  A request submitted at tick t with
``deadline_ticks=k`` therefore expires at the top of tick t+k+1 if still
queued — the head of a slots=1 queue gets exactly k service opportunities.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.runtime.slo import SLOTracker
from repro_torch.serving.servable import ServableProgram, as_servable

__all__ = ["Request", "ServingEngine"]


class Request:
    """One unit of serving work: an analog feature vector.

    ``payload`` is the request body, a ``[d]`` float feature vector for
    an analog program; ``features=`` is a readable alias for the same
    slot (exactly one of the two may be given).  The JAX engine's LM
    knobs (``prompt=``, ``max_new``, ``eos_id``, ``output``) come with the
    LM path (ROADMAP A10).

    ``deadline_ticks``: optional per-request tick budget — a request
    still *queued* that many engine ticks after submission completes as
    failed instead of waiting forever behind an outage.

    The result is a future: ``wait()`` blocks until the engine completes
    the request (from the dispatch thread or a synchronous ``run()``),
    ``done`` is non-blocking.  On success ``result`` holds the output
    panel row; on expiry or rejection ``failed`` is True and ``result``
    stays None.
    """

    def __init__(self, rid: int, payload: Any = None, *,
                 features: Any = None, deadline_ticks: int | None = None):
        given = [v for v in (payload, features) if v is not None]
        if len(given) != 1:
            raise ValueError("Request takes exactly one of payload=/features= "
                             f"(got {len(given)})")
        self.rid = rid
        self.payload = given[0]
        self.deadline_ticks = deadline_ticks
        # filled by the engine:
        self.result: Any = None
        self.failed = False
        self.submitted_tick = 0
        self.submitted_at: float | None = None
        self.completed_tick: int | None = None
        self._event = threading.Event()

    @property
    def features(self) -> Any:
        return self.payload

    @property
    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: float | None = None) -> bool:
        """Block until the engine completes this request (True) or the
        timeout elapses (False)."""
        return self._event.wait(timeout)

    def _finish(self, failed: bool = False) -> None:
        if failed:
            self.failed = True
        self._event.set()

    def __repr__(self):
        state = ("failed" if self.failed else
                 "done" if self.done else "pending")
        return f"Request(rid={self.rid}, {state})"


# ---------------------------------------------------------------------------
# the analog slot family: the per-tick device step
# ---------------------------------------------------------------------------

class _AnalogSlots:
    """Fixed-slot panel ticks through a :class:`ServableProgram`.

    The analog network is stateless, so a tick is: pack up to
    ``n_slots`` admitted requests into a zero-padded ``[n_slots, n_in]``
    panel on ``device``, ONE ``apply``, copy rows back to the host, free
    every slot.  Unfilled slots ride as zero rows.
    """

    def __init__(self, servable: ServableProgram, n_slots: int,
                 device: torch.device):
        self.n_slots = n_slots
        self.device = device
        self.active: list[Request] = []
        self.rebind(servable)

    def rebind(self, servable: ServableProgram) -> None:
        """(Re)bind the device call — also the mid-stream recovery swap."""
        self.servable = servable

    def free_slots(self) -> int:
        return self.n_slots - len(self.active)

    def n_active(self) -> int:
        return len(self.active)

    def admit(self, req: Request) -> None:
        self.active.append(req)

    def step(self) -> list[Request]:
        active, self.active = self.active, []
        try:
            d = int(self.servable.n_in)
        except (AttributeError, TypeError):
            d = len(np.asarray(active[0].payload))
        panel = np.zeros((self.n_slots, d), np.float32)
        for i, req in enumerate(active):
            panel[i] = req.payload
        with torch.no_grad():
            out = self.servable.apply(torch.from_numpy(panel).to(self.device))
        out = out.cpu().numpy()
        for i, req in enumerate(active):
            req.result = out[i]
        return active


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

class ServingEngine:
    """Continuous batching + async dispatch over one compiled program.

    ``program`` is anything servable: an analog model with ``params=``
    (e.g. ``AnalogUnitary``) or anything with ``apply``/``n_in``/``n_out``.
    Panels are built on ``device`` (CUDA when None; raises when CUDA is
    absent), which must be where the params live.

    Admission: ``max_queue=None`` leaves the queue unbounded; with a
    bound, ``admission="block"`` makes ``submit`` wait for space (up to
    its ``timeout=``) while ``admission="reject"`` fails the request
    fast.  Either way a refused request completes as failed and counts
    as ``rejected``.

    Synchronous use: ``submit(...)`` then ``run()`` drains the queue on
    the caller's thread.  Async use: ``start()`` (or the context
    manager) spins up the dispatch thread; ``submit`` from any thread
    and ``req.wait()`` for the result future; ``stop()`` drains and
    joins.

    Fault tolerance (analog path): with ``failure_injector=`` the engine
    polls the injector every tick; a fired ``tile_down`` swaps the
    program mid-stream — via the ``recovery(dead_tiles)`` callable when
    given, else the servable's own ``recover(dead_tiles)`` — and serving
    continues on the recovered grid.  ``events`` logs each swap.
    """

    def __init__(self, program, params=None, *, slots: int,
                 device=None,
                 max_queue: int | None = None,
                 admission: str = "block",
                 mesh=None,
                 failure_injector=None, recovery=None):
        if hasattr(program, "decode_step"):
            raise NotImplementedError(
                "LM serving (decode_step) is not ported yet: see ROADMAP A10")
        if mesh is not None:
            raise NotImplementedError(
                "the mesh= data-parallel tick panel is not ported yet: see "
                "ROADMAP A11")
        if admission not in ("block", "reject"):
            raise ValueError(f"admission must be 'block' or 'reject', "
                             f"got {admission!r}")
        self.n_slots = slots
        self.max_queue = max_queue
        self.admission = admission
        self.injector = failure_injector
        self.recovery = recovery
        self.ticks = 0
        self.slo = SLOTracker()
        self.events: list[dict] = []
        self.device = resolve_device(device)
        self._impl = _AnalogSlots(as_servable(program, params), slots,
                                  self.device)
        self._pending: deque[Request] = deque()
        self._cond = threading.Condition()
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    # -- admission ------------------------------------------------------
    def submit(self, req: Request, timeout: float | None = None) -> bool:
        """Enqueue a request; returns False if it was rejected.

        Thread-safe.  With a bounded queue, ``admission="block"`` waits
        up to ``timeout`` seconds for space (None = forever);
        ``admission="reject"`` returns immediately.  A refused request
        completes as failed so ``req.wait()`` never hangs on it.
        """
        with self._cond:
            if self.max_queue is not None:
                if self.admission == "reject":
                    if len(self._pending) >= self.max_queue:
                        return self._refuse(req)
                else:
                    ok = self._cond.wait_for(
                        lambda: len(self._pending) < self.max_queue,
                        timeout=timeout)
                    if not ok:
                        return self._refuse(req)
            req.submitted_tick = self.ticks
            req.submitted_at = time.perf_counter()
            self._pending.append(req)
            self.slo.count("submitted")
            self._cond.notify_all()
        return True

    def _refuse(self, req: Request) -> bool:
        self.slo.count("rejected")
        req._finish(failed=True)
        return False

    @property
    def queue_depth(self) -> int:
        with self._cond:
            return len(self._pending)

    # -- the tick loop --------------------------------------------------
    def _check_failures(self) -> None:
        """Poll the injector against the pre-increment tick counter; a
        fired ``tile_down`` swaps in the recovered program mid-stream."""
        if self.injector is None:
            return
        fired = self.injector.at_step(self.ticks)
        if not any(f.kind == "tile_down" for f in fired):
            return
        dead = tuple(sorted(self.injector.dead_tiles))
        if self.recovery is not None:
            prog = self.recovery(dead)
        else:
            prog = self._impl.servable.recover(dead)
        self._impl.rebind(as_servable(prog))
        self.slo.count("recovered")
        self.events.append({"tick": self.ticks, "kind": "tile_recovery",
                            "dead_tiles": dead})

    def _expire(self) -> None:
        """Complete overdue *queued* requests as failed, against the
        pre-increment tick counter (never silently stuck behind an
        outage)."""
        with self._cond:
            live: deque[Request] = deque()
            for req in self._pending:
                if (req.deadline_ticks is not None
                        and self.ticks - req.submitted_tick
                        >= req.deadline_ticks):
                    self.slo.count("expired")
                    req._finish(failed=True)
                else:
                    live.append(req)
            if len(live) != len(self._pending):
                self._pending = live
                self._cond.notify_all()   # queue shrank: wake blocked submits

    def tick(self) -> int:
        """One engine iteration; returns the number of requests completed.

        Ordering (load-bearing, see module docstring): poll failures and
        expire deadlines at the old tick number, advance the counter,
        admit into free slots, then one fixed-shape device call.
        """
        self._check_failures()
        self._expire()
        self.ticks += 1
        with self._cond:
            batch: list[Request] = []
            free = self._impl.free_slots()
            while free > 0 and self._pending:
                batch.append(self._pending.popleft())
                free -= 1
            if batch:
                self._cond.notify_all()   # queue shrank: wake blocked submits
        for req in batch:
            self._impl.admit(req)         # device work outside the lock
        if self._impl.n_active() == 0:
            return 0
        t0 = time.perf_counter()
        completed = self._impl.step()
        self.slo.record_tick(time.perf_counter() - t0)
        for req in completed:
            req.completed_tick = self.ticks
            self.slo.count("served")
            req._finish()
        return len(completed)

    def run(self, max_ticks: int = 10_000) -> None:
        """Drain synchronously: tick until every submitted request is
        done (served, or completed-as-failed past its deadline)."""
        for _ in range(max_ticks):
            served = self.tick()
            if served == 0 and not self._has_work():
                return
        raise RuntimeError("serving engine did not drain")

    # -- background dispatch -------------------------------------------
    def _has_work(self) -> bool:
        with self._cond:
            return bool(self._pending) or self._impl.n_active() > 0

    def _dispatch_loop(self) -> None:
        while True:
            if self._has_work():
                self.tick()
            elif self._stop.is_set():
                return
            else:
                with self._cond:
                    if not self._pending:
                        self._cond.wait(timeout=0.02)

    def start(self) -> "ServingEngine":
        """Spin up the background dispatch thread."""
        if self._thread is not None:
            raise RuntimeError("engine already started")
        self._stop.clear()
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        name="serving-dispatch", daemon=True)
        self._thread.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Stop the dispatch thread; by default after draining the queue."""
        if self._thread is None:
            return
        if not drain:
            with self._cond:
                for req in self._pending:
                    self.slo.count("rejected")
                    req._finish(failed=True)
                self._pending.clear()
                self._cond.notify_all()
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        self._thread.join()
        self._thread = None

    def __enter__(self) -> "ServingEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop(drain=exc == (None, None, None))

    # -- accounting -----------------------------------------------------
    @property
    def stats(self) -> dict:
        """SLO summary: counters, tick count, p50/p99 tick latency, qps,
        plus the current queue depth."""
        out = self.slo.summary()
        out["queue_depth"] = self.queue_depth
        return out
