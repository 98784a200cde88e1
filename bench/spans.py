"""The spans pass: where the device's time goes inside the program, read
from the program's own spans (``repro_torch.runtime.trace``) on the device
trace's clock.

The pass belongs to a ``--trace 1`` run.  The first reader of a
``program_span`` metric asks :func:`table` for it; the pass runs once, its
:class:`Table` is kept in ``records["spans"]`` for the other readers, and
its rows are printed on standard error (``bench: spans ...``).  Where it
cannot run it leaves None there and the readers return None: a run with
no traced window on a card, or a program without the span module.

How it runs.  It runs the cell's driver again, with the run's own
workload and seed, through a context whose ``profile`` takes the traced
closure the driver hands it and then stops the driver: the closure is the
one ``devtrace.profile`` traced, and the driver's reference check is not
repeated.  The closure runs ``2 * PAIRS`` times under ``torch.profiler``
with the CUDA activity alone, as ``devtrace``'s first pass: spans off, on,
off, on...  The on-cost is the fastest window with spans on over the
fastest with spans off, less 1 (the host's noise only ever slows a pass).
The last pass with spans on is reduced by :func:`reduce`:

* each device op goes to the innermost span whose interval holds its
  launch, the runtime call that carries the op's correlation id.
  "Innermost" is taken across threads, so a kernel that autograd's backward
  thread launches while the main thread waits in ``train.backward`` falls
  there;
* each interval in which the device is idle is divided over the innermost
  span open on the main thread; time with no span open is put down as
  ``outside the program``, as are ops launched outside every span.

The spans' ``perf_counter_ns`` times are put on the Unix clock by the
span module's anchors; the profiler's events carry Unix nanoseconds.
"""

from __future__ import annotations

import bisect
import dataclasses
import importlib.util
import sys
import threading
import time

from bench import harness

OUTSIDE = "outside the program"


@dataclasses.dataclass
class Table:
    """One spans pass reduced.  ``paths`` maps each span path, innermost
    name first (``("attn.rope", "lm.attention", "lm.prefill")``, or
    ``(OUTSIDE,)``), to ``[device ns, launches, idle ns]`` of the ops
    launched and the idle time spent with that path innermost."""

    calls: dict                 # span name -> spans of that name
    host_self_ns: dict          # span name -> host ns outside its children
    paths: dict
    busy_ns: float              # union of the device's ops in the window
    window_ns: float
    unmatched: int = 0          # device ops with no launch record
    on_cost: float | None = None
    # the measured windows, s: {False: spans off, True: spans on}
    windows: dict = dataclasses.field(default_factory=dict)
    ops: dict = dataclasses.field(default_factory=dict)
    # (innermost span name, op name) -> device ns

    def top_ops(self, name: str, k: int = 3) -> list:
        """The ``k`` ops with the most device ns launched with ``name``
        innermost: ``(op name, ms)``."""
        mine = [(op, ns) for (n, op), ns in self.ops.items() if n == name]
        mine.sort(key=lambda t: -t[1])
        return [(op, ns * 1e-6) for op, ns in mine[:k]]

    def _sum(self, k: int, names, inclusive: bool) -> float:
        names = set(names)
        return sum(v[k] for p, v in self.paths.items()
                   if (names.intersection(p) if inclusive
                       else p[0] in names))

    def device_ms(self, *names: str, inclusive: bool = True) -> float:
        """Device ms of the ops launched inside any span named in
        ``names`` (or, not ``inclusive``, with one of them innermost)."""
        return 1e-6 * self._sum(0, names, inclusive)

    def idle_ms(self, *names: str, inclusive: bool = True) -> float:
        """Idle device ms while the main thread was inside one of
        ``names``."""
        return 1e-6 * self._sum(2, names, inclusive)

    def launches(self, *names: str, inclusive: bool = True) -> int:
        return int(self._sum(1, names, inclusive))

    def busy_pct(self, *names: str) -> float:
        """Share of the busy time in ops launched inside ``names``, %."""
        return 100.0 * 1e6 * self.device_ms(*names) / self.busy_ns

    def lines(self) -> list[str]:
        """The table as printed: a head line, then a row a span name,
        the most device time first."""
        names = sorted(set(self.calls) | {OUTSIDE},
                       key=lambda n: -self.device_ms(n))
        cost = ("not measured" if self.on_cost is None
                else f"{100 * self.on_cost:+.2f}%")
        for on, w in sorted(self.windows.items()):
            cost += (f"; spans {'on' if on else 'off'} "
                     f"{1e3 * min(w):.3f}–{1e3 * max(w):.3f} ms")
        out = [f"bench: spans window {self.window_ns * 1e-6:.3f} ms, busy "
               f"{self.busy_ns * 1e-6:.3f} ms, {sum(self.calls.values())} "
               f"spans, {self.launches(*names)} ops ({self.unmatched} with "
               f"no launch record), on-cost {cost}",
               f"bench: spans {'span':<20} {'calls':>6} {'host self ms':>12}"
               f" {'device ms':>10} {'launches':>8} {'idle ms':>9}"
               f" {'incl. % busy':>12}"]
        for n in names:
            out.append(
                f"bench: spans {n:<20} {self.calls.get(n, 0):>6} "
                f"{self.host_self_ns.get(n, 0) * 1e-6:>12.3f} "
                f"{self.device_ms(n, inclusive=False):>10.3f} "
                f"{self.launches(n, inclusive=False):>8} "
                f"{self.idle_ms(n, inclusive=False):>9.3f} "
                f"{self.busy_pct(n):>12.2f}")
        for n in names:
            top = "; ".join(f"{op[:48]} {ms:.3f}" for op, ms in
                            self.top_ops(n))
            if top:
                out.append(f"bench: spans top ops of {n}: {top}")
        return out


def _segments(intervals) -> list:
    """``(a, b, i)`` without overlap, in order: over ``[a, b)`` the
    innermost of the properly nested ``intervals`` (``(start, end, i)``)
    that hold it."""
    out, stack, pos = [], [], None
    for s, e, i in sorted(intervals, key=lambda t: (t[0], -t[1])):
        while stack and stack[-1][0] <= s:
            end, j = stack.pop()
            if pos < end:
                out.append((pos, end, j))
                pos = end
        if stack and pos < s:
            out.append((pos, s, stack[-1][1]))
        stack.append((e, i))
        pos = s
    while stack:
        end, j = stack.pop()
        if pos < end:
            out.append((pos, end, j))
            pos = end
    return out


def _union(intervals) -> list:
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def reduce(spans, ops, window, main_thread) -> Table:
    """The table of one pass.

    ``spans``: ``(name, parent, root, start_ns, end_ns, thread)`` on the
    profiler's clock (a span still open, ``end_ns`` None, ends with the
    window);
    ``ops``: ``(name, start_ns, end_ns, launch_ns or None)`` of every op
    that ran on the device; ``window``: ``(lo, hi)`` ns of the pass;
    ``main_thread``: the thread whose spans divide the idle time."""
    lo, hi = window
    spans = [s if s[4] is not None else s[:4] + (hi,) + s[5:] for s in spans]
    paths = _paths(spans)
    calls, host_self = {}, {}
    child_ns = [0] * len(spans)
    for k, s in enumerate(spans):
        calls[s[0]] = calls.get(s[0], 0) + 1
        if s[1] >= 0:
            child_ns[s[1]] += s[4] - s[3]
    for k, s in enumerate(spans):
        host_self[s[0]] = (host_self.get(s[0], 0)
                           + (s[4] - s[3]) - child_ns[k])

    by_thread: dict = {}
    for k, s in enumerate(spans):
        by_thread.setdefault(s[5], []).append((s[3], s[4], k))
    segs = {t: _segments(iv) for t, iv in by_thread.items()}
    starts = {t: [a for a, _, _ in sg] for t, sg in segs.items()}

    def innermost(t):
        best = None
        for th, sg in segs.items():
            j = bisect.bisect_right(starts[th], t) - 1
            if j >= 0 and sg[j][0] <= t < sg[j][1]:
                k = sg[j][2]
                if best is None or spans[k][3] > spans[best][3]:
                    best = k
        return best

    table: dict = {}

    def add(path, device=0.0, launches=0, idle=0.0):
        v = table.setdefault(path, [0.0, 0, 0.0])
        v[0] += device
        v[1] += launches
        v[2] += idle

    unmatched, by_op = 0, {}
    for name, a, b, launch in ops:
        k = None if launch is None else innermost(launch)
        unmatched += launch is None
        path = paths[k] if k is not None else (OUTSIDE,)
        add(path, b - a, 1)
        by_op[path[0], name] = by_op.get((path[0], name), 0) + b - a

    busy = _union((max(a, lo), min(b, hi)) for _, a, b, _ in ops
                  if min(b, hi) > max(a, lo))
    edges = [lo] + [x for seg in busy for x in seg] + [hi]
    main = segs.get(main_thread, [])
    main_starts = [a for a, _, _ in main]
    for g in range(0, len(edges), 2):
        a, b = edges[g], edges[g + 1]
        if b <= a:
            continue
        covered = 0.0
        j = max(bisect.bisect_right(main_starts, a) - 1, 0)
        while j < len(main) and main[j][0] < b:
            s0, s1, k = main[j]
            part = min(b, s1) - max(a, s0)
            if part > 0:
                add(paths[k], idle=part)
                covered += part
            j += 1
        if b - a - covered > 0:
            add((OUTSIDE,), idle=b - a - covered)
    return Table(calls=calls, host_self_ns=host_self, paths=table,
                 busy_ns=sum(b - a for a, b in busy), window_ns=hi - lo,
                 unmatched=unmatched, ops=by_op)


def _paths(spans) -> list:
    """Each span's path: its name, then its ancestors' names."""
    out = []
    for s in spans:
        out.append((s[0],) + (out[s[1]] if s[1] >= 0 else ()))
    return out


def device_events(torch, prof) -> list:
    """``(name, start_ns, end_ns, launch_ns or None)`` of every op that
    ran on the device, from the profiler's events; the launch is the start
    of the runtime or driver call (``cuda...``/``cu...``) that carries the
    op's correlation id."""
    cuda = torch.autograd.DeviceType.CUDA
    ops, launch = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                a = e.start_ns()
                ops.append((e.name(), a, a + e.duration_ns(),
                            e.correlation_id()))
        elif e.name().startswith("cu"):
            launch.setdefault(e.correlation_id(), e.start_ns())
    return [(n, a, b, launch.get(c)) for n, a, b, c in ops]


#: passes with spans off and on, alternated, that the on-cost compares
PAIRS = 4


def measure(torch, fn, sync, trace) -> Table | None:
    """``fn()`` under the profiler, the device alone, ``PAIRS`` times with
    spans off and as often with them on, alternated (``trace`` is the
    program's span module).  The last pass with spans on, reduced, with
    the on-cost; None when no op ran on the device."""
    act = torch.profiler.ProfilerActivity
    windows = {False: [], True: []}
    for on in (False, True) * PAIRS:
        sync()
        with torch.profiler.profile(activities=[act.CUDA]) as prof:
            if on:
                trace.enable()
            t0 = time.perf_counter()
            fn()
            sync()
            windows[on].append(time.perf_counter() - t0)
            if on:
                trace.disable()
                rec = trace.drain()
    ops = device_events(torch, prof)
    if not ops:
        return None
    spans = [(n, p, r, rec.unix_ns(a), None if b is None else rec.unix_ns(b),
              th) for n, p, r, a, b, th in rec.spans]
    window = (rec.anchors[0][1], rec.anchors[-1][1])
    out = reduce(spans, ops, window, threading.get_ident())
    out.on_cost = min(windows[True]) / min(windows[False]) - 1.0
    out.windows = windows
    return out


class _Measured(Exception):
    """Raised through the driver once its traced closure is measured."""


class _SpansPass(harness.RunContext):
    """A run's context for the spans pass: ``profile`` measures the
    closure it is handed with the program's span module ``span_module``
    and stops the driver."""

    def __init__(self, span_module, *args):
        super().__init__(*args)
        self.span_module = span_module
        self.table = None

    def log(self, what: str) -> None:
        harness.eprint(f"bench: spans pass: {what} at "
                       f"{self.now() - self.t_start:.3f} s")

    def profile(self, fn):
        self.table = measure(self.torch, fn, self.sync, self.span_module)
        raise _Measured


#: the window of the driver's second run; the pass measures the closure
#: after it, so it only has to hold one apply, step or batch
PASS_SECONDS = 1.0


def run_pass(spec: dict, ctx: _SpansPass) -> Table | None:
    """The cell's driver run in ``ctx`` up to its traced closure; the
    closure's table."""
    try:
        harness.run_cell(spec, ctx)
    except _Measured:
        pass
    return ctx.table


def table(records: dict) -> Table | None:
    """The run's spans table, kept in ``records["spans"]``: the first call
    in a traced run on a card runs the pass; None where it cannot run."""
    if "spans" not in records:
        records["spans"] = _collect(records)
    return records["spans"]


def _collect(records: dict) -> Table | None:
    if records.get("trace") is None:
        return None                    # no traced window ran on a card
    if importlib.util.find_spec("repro_torch.runtime.trace") is None:
        harness.eprint("bench: spans: the program has no span module")
        return None
    from repro_torch.runtime import trace

    args = harness.parse(sys.argv[1:])
    ctx = _SpansPass(trace, "cuda:0", args.seed, PASS_SECONDS, True,
                     time.perf_counter())
    out = run_pass(harness.cell_spec(args.workload), ctx)
    harness.eprint(f"bench: spans devtrace's device-only window "
                   f"{records['trace'].window_s * 1e3:.3f} ms")
    for line in out.lines() if out is not None else ["bench: spans: none"]:
        harness.eprint(line)
    return out
