"""Spans at the port's layer boundaries, kept in memory.

``span(name)`` is a context manager placed around the call into a layer
(``train.step``, ``lm.attention``, ``analog.grid``...).  Tracing is off by
default: ``span`` then checks one module-level flag and returns one shared
context that does nothing (no allocation, no clock read, no torch call).

After :func:`enable` every span appends one record

    (name, parent index, root id, start_ns, end_ns, thread id)

to an in-memory list, read on ``time.perf_counter_ns``.  The parent is the
span open on the same thread (one stack a thread, so spans opened on
autograd's backward thread start their own trees); a top-level span's
parent is -1 and every span opened under it shares its root id, which is
the top-level span's own index.  :func:`drain` hands the records back and
starts a new list.

``enable()`` and ``drain()`` each take an anchor, a pair
``(perf_counter_ns, time_ns)``: :meth:`Recording.unix_ns` maps a span's
times onto the Unix clock through them, which is the clock of the
profiler's (Kineto's) event timestamps.

Counters: while tracing is on, :func:`count` adds a device tensor into a
named running sum on its device (no copy to the host, no synchronise);
:func:`drain` hands the sums back in ``Recording.counters`` and starts
new ones.  A caller computes what it counts only when :func:`counting`
says so.  ``enable(spans=False)`` keeps the counters without the spans.

A span wraps a call and nothing else: numerics and control flow are the
same with tracing on and off.
"""

from __future__ import annotations

import threading
import time

_on = False
_counting = False
_lock = threading.Lock()
_counters: dict = {}    # name -> running sum, a tensor on its device
_spans: list = []       # [name, parent, root, start_ns, end_ns, thread]
_anchors: list = []     # (perf_counter_ns, time_ns) pairs
_local = threading.local()


class _Off:
    """The shared context ``span`` returns while tracing is off.

    Both methods are C calls, so the off path runs no Python frame besides
    ``span``'s: ``NoneType()`` returns None, and ``"".format`` takes the
    three exception arguments and returns ``""``, which is false, so an
    exception raised in the block goes on."""

    __slots__ = ()
    __enter__ = type(None)
    __exit__ = "".format


_OFF = _Off()


class _Span:
    __slots__ = ("name", "record")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        with _lock:
            index = len(_spans)
            parent, root = stack[-1] if stack else (-1, index)
            self.record = [self.name, parent, root, 0, None,
                           threading.get_ident()]
            _spans.append(self.record)
        stack.append((index, root))
        self.record[3] = time.perf_counter_ns()
        return None

    def __exit__(self, exc_type, exc, tb):
        self.record[4] = time.perf_counter_ns()
        _local.stack.pop()
        return None


def span(name: str):
    """A context manager around one call into a layer; records a span
    while tracing is on, else the shared no-op context."""
    if not _on:
        return _OFF
    return _Span(name)


def _anchor() -> tuple:
    return time.perf_counter_ns(), time.time_ns()


def enable(spans: bool = True) -> None:
    """Start counting and, with ``spans``, recording spans (takes an
    anchor)."""
    global _on, _counting
    with _lock:
        if spans:
            _anchors.append(_anchor())
            _on = True
        _counting = True


def disable() -> None:
    """Stop recording and counting; what was recorded waits for
    :func:`drain`."""
    global _on, _counting
    _on = _counting = False


def counting() -> bool:
    """Whether :func:`count` keeps what it is given."""
    return _counting


def count(name: str, value) -> None:
    """Add ``value`` (a tensor) into the counter ``name`` on its device,
    while counting is on."""
    if not _counting:
        return
    with _lock:
        old = _counters.get(name)
        _counters[name] = value.detach().clone() if old is None \
            else old + value


class Recording:
    """What :func:`drain` hands back: ``spans``, a list of
    ``(name, parent, root, start_ns, end_ns, thread)`` tuples on the
    ``perf_counter_ns`` clock (``end_ns`` None for a span still open),
    ``anchors``, the ``(perf_counter_ns, time_ns)`` pairs taken by
    ``enable`` and ``drain``, and ``counters``, each counter's sum (a
    tensor on the device it was counted on)."""

    __slots__ = ("spans", "anchors", "counters")

    def __init__(self, spans: list, anchors: list,
                 counters: dict | None = None):
        self.spans = spans
        self.anchors = anchors
        self.counters = counters or {}

    def __len__(self) -> int:
        return len(self.spans)

    def unix_ns(self, t: int) -> float:
        """``perf_counter_ns`` time ``t`` on the Unix clock, by the line
        through the first and last anchors (the offset alone with one)."""
        (p0, u0), (p1, u1) = self.anchors[0], self.anchors[-1]
        if p1 == p0:
            return u0 + (t - p0)
        return u0 + (t - p0) * ((u1 - u0) / (p1 - p0))


def drain() -> Recording:
    """The spans recorded since the last drain, and the anchors that map
    them; starts a new list.  Empty when nothing was recorded and tracing
    is off.  Call it with no span open: a parent index points into the
    list its span was recorded in, and with no count under way."""
    global _spans, _anchors, _counters
    with _lock:
        counters, _counters = _counters, {}
        if not _spans and not _on:
            _anchors = []
            return Recording([], [], counters)
        a = _anchor()
        out = Recording([tuple(r) for r in _spans], _anchors + [a],
                        counters)
        _spans = []
        _anchors = [a] if _on else []
    return out
