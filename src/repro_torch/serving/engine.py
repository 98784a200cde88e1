"""The serving engine on torch: the analog and the LM slot families.

The JAX package's ``serving/engine.py``:

  * an (optional) background **dispatch thread** pulls from a bounded
    request queue and drives the device, so callers just ``submit()`` and
    wait on the request's result future;
  * a bounded **admission queue** with a choice of backpressure policy —
    ``"block"`` (submit waits for space) or ``"reject"`` (submit fails
    fast and the request completes as failed);
  * a fixed-slot **tick loop**: every tick admits queued requests into
    free slots and runs ONE fixed-shape device call — the kernel path's
    apply for an analog program (e.g. an ``AnalogUnitary`` with
    ``params=``), one decode step for an LM — then frees finished slots;
  * per-request **SLO accounting** (:class:`repro_torch.runtime.slo.SLOTracker`):
    deadlines, served/expired/rejected/recovered counters, p50/p99 tick
    latency, sustained QPS;
  * the **failure-injector hook** (analog path): a fired ``tile_down``
    swaps in a recovered program between ticks and in-flight requests keep
    draining.

A model exposing ``decode_step`` (:class:`repro_torch.models.Model`) is
served through the LM slot family; both families share the admission
queue, tick loop and SLO tracker.  With ``mesh=`` the analog family's tick
panel splits by batch over the mesh's data axis (every rank runs the same
engine: see :class:`ServingEngine`).

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
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharding import data_parallel
from repro_torch.runtime.slo import SLOTracker
from repro_torch.serving.servable import ServableProgram, as_servable

__all__ = ["Request", "ServingEngine"]


class Request:
    """One unit of serving work — analog feature vector OR LM prompt.

    ``payload`` is the request body: a ``[d]`` float feature vector for
    an analog program, a ``[prompt_len]`` int token array for the LM.
    The ``features=`` / ``prompt=`` keywords are readable aliases for the
    same slot (exactly one of the three may be given).  ``max_new`` and
    ``eos_id`` bound an LM request's generation.

    ``deadline_ticks``: optional per-request tick budget — a request
    still *queued* that many engine ticks after submission completes as
    failed instead of waiting forever behind an outage.

    The result is a future: ``wait()`` blocks until the engine completes
    the request (from the dispatch thread or a synchronous ``run()``),
    ``done`` is non-blocking.  On success ``result`` holds the output
    panel row (analog) or the generated token array (LM); on expiry or
    rejection ``failed`` is True and ``result`` stays None.
    """

    def __init__(self, rid: int, payload: Any = None, *,
                 features: Any = None, prompt: Any = None,
                 deadline_ticks: int | None = None,
                 max_new: int = 32, eos_id: int | None = None):
        given = [v for v in (payload, features, prompt) if v is not None]
        if len(given) != 1:
            raise ValueError(
                "Request takes exactly one of payload=/features=/prompt= "
                f"(got {len(given)})")
        self.rid = rid
        self.payload = given[0]
        self.deadline_ticks = deadline_ticks
        self.max_new = max_new
        self.eos_id = eos_id
        # filled by the engine:
        self.result: Any = None
        self.output: list[int] = []          # LM path: tokens as they decode
        self.failed = False
        self.submitted_tick = 0
        self.submitted_at: float | None = None
        self.completed_tick: int | None = None
        self._event = threading.Event()

    @property
    def features(self) -> Any:
        return self.payload

    @property
    def prompt(self) -> Any:
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
# slot families: the per-tick device step for each request kind
# ---------------------------------------------------------------------------

class _AnalogSlots:
    """Fixed-slot panel ticks through a :class:`ServableProgram`.

    The analog network is stateless, so a tick is: pack up to
    ``n_slots`` admitted requests into a zero-padded ``[n_slots, n_in]``
    panel on ``device``, ONE ``apply``, copy rows back to the host, free
    every slot.  Unfilled slots ride as zero rows.  With ``mesh`` the apply
    splits the panel by batch over ``data_axis``
    (:func:`repro_torch.parallel.data_parallel`); the data group's first
    rank broadcasts its panel before the apply, so every rank computes the
    same rows.
    """

    def __init__(self, servable: ServableProgram, n_slots: int,
                 device: torch.device, *, mesh=None, data_axis: str = "data"):
        self.n_slots = n_slots
        self.device = device
        self.mesh = mesh
        self.data_axis = data_axis
        self.active: list[Request] = []
        if mesh is not None:
            coll.require_axes(mesh, data_axis)
        self.rebind(servable)

    def rebind(self, servable: ServableProgram) -> None:
        """(Re)bind the device call — also the mid-stream recovery swap."""
        self.servable = servable

        def apply(p, x):
            return servable.apply(x)

        if self.mesh is not None:
            apply = data_parallel(apply, self.mesh, axis_name=self.data_axis)
        self._apply = apply

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
        x = torch.from_numpy(panel).to(self.device)
        if self.mesh is not None:
            x = coll.broadcast(x, coll.axis_group(self.mesh, self.data_axis))
        with torch.no_grad():
            out = self._apply(None, x)
        out = out.cpu().numpy()
        for i, req in enumerate(active):
            req.result = out[i]
        return active


class _LMSlot:
    __slots__ = ("req", "pos", "pending")

    def __init__(self):
        self.req: Request | None = None
        self.pos = 0                # next cache position for this slot
        self.pending = 0            # last token, fed on the next tick


def _write_row(cache, row, i: int) -> None:
    """Copy a batch-1 cache ``row`` into slot ``i`` of ``cache``, leaf by
    leaf (each leaf stacked over layers, then slots)."""
    if isinstance(cache, dict):
        for k, v in cache.items():
            _write_row(v, row[k], i)
    else:
        cache[:, i] = row[:, 0]


class _DecodeSlots:
    """Fixed-slot continuous batching over the LM decode step.

    Slot state (request, next position, pending token) lives host-side; the
    device state is the shared decode cache on ``device`` (KV caches, SSM
    states, an encdec's cross cache), one row per slot.  Admission feeds a
    prompt's first ``len - 1`` tokens into a batch-1 cache, by one
    ``Model.prefill`` of as many as ``Model.prefill_len`` allows (at most
    ``max_len``) and batch-1 decode steps for the rest, and copies that
    cache into the slot's row only; the last prompt token is fed on the next
    tick.  A tick decodes one token for every slot, each at its own
    position (free slots feed token 0 into their own row), and finished
    requests (eos, max tokens, cache full) free their slot immediately.  A
    request's tokens are therefore those of a batch-1 prefill and greedy
    decode of its prompt, whatever shares the slots (an MoE's decode tick
    excepted, whose capacity drops depend on the other slots' routes, as in
    the JAX package).
    """

    def __init__(self, model, params, n_slots: int, max_len: int,
                 device: torch.device, sample: Callable | None = None):
        if max_len is None:
            raise ValueError("LM serving needs max_len= (KV cache length)")
        self.model = model
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        self.device = device
        self.sample = sample
        self.slots = [_LMSlot() for _ in range(n_slots)]
        self.cache = model.init_cache(n_slots, max_len, device=device)
        self._decode = model.bind_decode(params)

    def rebind(self, servable) -> None:
        raise ValueError("mid-stream program recovery is an analog-path "
                         "feature; the LM decode path has no tile grid")

    def free_slots(self) -> int:
        return sum(1 for s in self.slots if s.req is None)

    def n_active(self) -> int:
        return sum(1 for s in self.slots if s.req is not None)

    def admit(self, req: Request) -> None:
        """Fill a free slot's cache row with ``prompt[:-1]``; raises
        ``ValueError`` (the slot stays free) for an empty prompt."""
        prompt = np.asarray(req.payload, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError(f"request {req.rid}: an LM prompt needs at "
                             "least one token")
        i = next(j for j, s in enumerate(self.slots) if s.req is None)
        head = prompt[:-1]
        # a batch-1 prefill of as much of the head as it can take (see
        # Model.prefill_len); the rest is fed one decode step at a time into
        # this row alone, a write past the end landing in the last slot, as
        # the JAX engine feeds a whole prompt.  The row is then written whole:
        # an SSM state starts from this prompt, and decode masks the KV
        # positions past a slot's own
        n_pre = self.model.prefill_len(min(len(head), self.max_len))
        with torch.no_grad():
            if n_pre:
                toks = {"tokens": self._tokens(head[None, :n_pre])}
                _, row = self.model.prefill(self.params, toks,
                                            max_len=self.max_len)
            else:
                row = self.model.init_cache(1, self.max_len,
                                            device=self.device)
            for p in range(n_pre, len(head)):
                _, row = self._decode(self._tokens(head[p:p + 1]), row, p)
        _write_row(self.cache, row, i)  # every leaf [n_super, slots, ...]
        slot = self.slots[i]
        slot.req, slot.pos = req, len(head)
        # the last prompt token is fed on the next engine tick
        slot.pending = int(prompt[-1])

    def _tokens(self, toks: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(toks).to(self.device)

    def step(self) -> list[Request]:
        active = [i for i, s in enumerate(self.slots) if s.req is not None]
        toks = np.zeros((self.n_slots,), np.int32)
        pos = np.zeros((self.n_slots,), np.int32)
        for i in active:
            slot = self.slots[i]
            toks[i] = slot.pending if slot.pos < self.max_len else 0
            pos[i] = slot.pos
        logits, self.cache = self._decode(self._tokens(toks), self.cache,
                                          self._tokens(pos))
        chosen = (torch.argmax(logits, -1) if self.sample is None
                  else torch.as_tensor(self.sample(logits)))
        arr = chosen.cpu().numpy()
        completed = []
        for i in active:
            slot = self.slots[i]
            slot.pos += 1
            tok = int(arr[i])
            req = slot.req
            req.output.append(tok)
            slot.pending = tok
            if ((req.eos_id is not None and tok == req.eos_id)
                    or len(req.output) >= req.max_new
                    or slot.pos >= self.max_len - 1):
                req.result = np.asarray(req.output, np.int32)
                completed.append(req)
                slot.req = None   # slot freed immediately
        return completed


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

class ServingEngine:
    """Continuous batching + async dispatch over one compiled program.

    ``program`` is anything servable: an analog model with ``params=``
    (e.g. ``AnalogUnitary``), anything with ``apply``/``n_in``/``n_out``,
    or an LM :class:`repro_torch.models.Model` (detected by its
    ``decode_step``; needs ``params=`` and ``max_len=``, and ``sample=``
    maps a tick's logits to tokens, greedy when None).  Panels and the KV
    cache live on ``device`` (CUDA when None; raises when CUDA is absent),
    which must be where the params live.

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

    Data parallelism (analog path): with ``mesh=`` (a ``DeviceMesh``) each
    tick's panel splits by batch over ``mesh``'s ``data_axis``, each rank
    applying the program to its block.  Every rank of the mesh runs its own
    engine, and the ranks stay in step only if each submits the same
    requests in the same order and calls the same ticks (``run`` or
    ``tick``; not the dispatch thread, whose ticks follow each rank's
    clock).  The data group's first rank broadcasts its panel every tick,
    so the rows computed are the same on every rank even where admission
    differed; each rank hands its own requests the rows of their slots.
    """

    def __init__(self, program, params=None, *, slots: int,
                 device=None,
                 max_len: int | None = None,
                 sample: Callable | None = None,
                 max_queue: int | None = None,
                 admission: str = "block",
                 mesh=None, data_axis: str = "data",
                 failure_injector=None, recovery=None):
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
        if hasattr(program, "decode_step"):
            self._impl = _DecodeSlots(program, params, slots, max_len,
                                      self.device, sample=sample)
        else:
            self._impl = _AnalogSlots(as_servable(program, params), slots,
                                      self.device, mesh=mesh,
                                      data_axis=data_axis)
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
        admit into free slots, then one fixed-shape device call.  A request
        that admission refuses (``ValueError``) completes as failed, counts
        as ``rejected`` and is logged in ``events``; the others go on.
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
        for req in batch:                 # device work outside the lock
            try:
                self._impl.admit(req)
            except ValueError as exc:     # this request alone cannot be served
                self.slo.count("rejected")
                self.events.append({"tick": self.ticks,
                                    "kind": "admission_failed",
                                    "rid": req.rid, "error": str(exc)})
                req._finish(failed=True)
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
