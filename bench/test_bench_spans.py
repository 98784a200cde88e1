"""The spans pass (bench/spans.py): the reduction on hand-made ops, launches
and spans; the readers of the ``program_span`` metrics; each cell's driver
run up to its traced closure on the CPU; and, on the card (``gpu``), the
spans' clock against the profiler's."""

import threading
import time

import pytest

from bench import harness, spans
from bench.test_bench_cells import SMALL

MS = 1_000_000          # ns
MAIN, OTHER = 1, 2      # thread ids


def hand_made():
    """A train step on the main thread, a span of its own on another
    thread, a batch after the step; ops launched in each, one outside every
    span and one with no launch record.  Times in ms."""
    sp = [("train.step", -1, 0, 0, 100, MAIN),
          ("train.forward", 0, 0, 10, 40, MAIN),
          ("lm.norm", 1, 0, 12, 20, MAIN),
          ("train.backward", 0, 0, 40, 80, MAIN),
          ("train.optimizer", 0, 0, 80, 95, MAIN),
          ("data.batch", -1, 5, 100, 130, MAIN),
          ("worker", -1, 6, 50, 60, OTHER)]
    ops = [("k1", 16, 30, 15),      # in lm.norm
           ("k2", 46, 70, 45),      # launched on OTHER with no span there
           ("k3", 70, 75, 55),      # in worker, which began after backward
           ("k4", 85, 95, 85),      # in train.optimizer
           ("k5", 140, 150, None),  # no launch record
           ("k6", 135, 138, 135)]   # outside every span
    scale = lambda t: None if t is None else t * MS  # noqa: E731
    sp = [(n, p, r, a * MS, b * MS, th) for n, p, r, a, b, th in sp]
    ops = [(n, a * MS, b * MS, scale(c)) for n, a, b, c in ops]
    return spans.reduce(sp, ops, (0, 160 * MS), MAIN)


def test_ops_go_to_the_innermost_span_across_threads():
    t = hand_made()
    assert t.device_ms("lm.norm", inclusive=False) == 14
    assert t.device_ms("train.forward", inclusive=False) == 0
    assert t.device_ms("train.forward") == 14
    assert t.device_ms("train.backward") == 24
    assert t.device_ms("worker") == 5
    assert t.device_ms("train.optimizer") == 10
    assert t.device_ms("train.step") == 48
    assert t.device_ms(spans.OUTSIDE) == 13 and t.unmatched == 1
    assert t.launches() == 0 and t.launches(spans.OUTSIDE) == 2
    assert t.launches("train.step") == 3
    assert t.busy_ns == 66 * MS and t.window_ns == 160 * MS


def test_idle_is_divided_over_the_main_threads_innermost_span():
    t = hand_made()
    self_idle = {n: t.idle_ms(n, inclusive=False) for n in (
        "train.step", "train.forward", "lm.norm", "train.backward",
        "train.optimizer", "data.batch", "worker", spans.OUTSIDE)}
    assert self_idle == {"train.step": 15, "train.forward": 12,
                         "lm.norm": 4, "train.backward": 11,
                         "train.optimizer": 5, "data.batch": 30,
                         "worker": 0, spans.OUTSIDE: 17}
    assert t.idle_ms("train.step") == 47
    assert sum(self_idle.values()) * MS == t.window_ns - t.busy_ns


def test_calls_and_host_self_time():
    t = hand_made()
    assert t.calls == {"train.step": 1, "train.forward": 1, "lm.norm": 1,
                       "train.backward": 1, "train.optimizer": 1,
                       "data.batch": 1, "worker": 1}
    assert {n: v / MS for n, v in t.host_self_ns.items()} == {
        "train.step": 15, "train.forward": 22, "lm.norm": 8,
        "train.backward": 40, "train.optimizer": 15, "data.batch": 30,
        "worker": 10}
    lines = t.lines()
    assert lines[0].startswith("bench: spans window 160.000 ms, busy "
                               "66.000 ms, 7 spans, 6 ops (1 with no "
                               "launch record)")
    assert len(lines) == 2 + 8 + 5
    t.on_cost, t.windows = 0.01, {False: [0.2, 0.1], True: [0.101]}
    assert t.lines()[0].endswith("on-cost +1.00%; spans off 100.000–200.000 "
                                 "ms; spans on 101.000–101.000 ms")
    assert t.top_ops("train.backward") == [("k2", 24)]
    assert t.top_ops(spans.OUTSIDE) == [("k5", 10), ("k6", 3)]
    assert lines[-1] == "bench: spans top ops of worker: k3 5.000"


def test_a_span_left_open_ends_with_the_window():
    t = spans.reduce([("a", -1, 0, 10, None, MAIN)], [("k", 20, 30, 50)],
                     (0, 100), MAIN)
    assert t.device_ms("a") * MS == 10 and t.idle_ms("a") * MS == 80


def test_segments_are_the_innermost_of_nested_intervals():
    got = spans._segments([(0, 10, "p"), (2, 4, "a"), (4, 6, "b"),
                           (7, 8, "c"), (12, 13, "q")])
    assert got == [(0, 2, "p"), (2, 4, "a"), (4, 6, "b"), (6, 7, "p"),
                   (7, 8, "c"), (8, 10, "p"), (12, 13, "q")]


def table_for(calls, paths, busy_ms):
    return spans.Table(calls=calls, host_self_ns={},
                       paths={p: [d * MS, 1, i * MS]
                              for p, (d, i) in paths.items()},
                       busy_ns=busy_ms * MS, window_ns=2 * busy_ms * MS)


READERS = {
    "optimizer_ms.train": (
        table_for({"train.step": 2},
                  {("train.optimizer", "train.step"): (30, 1),
                   ("lm.norm", "train.forward", "train.step"): (50, 0)},
                  200), 15.0),
    "feed_idle_ms.train": (
        table_for({"train.step": 2},
                  {("data.batch",): (0, 7), ("train.step",): (9, 3)}, 100),
        3.5),
    "norm_rope_pct.prefill": (
        table_for({"lm.prefill": 1},
                  {("lm.norm", "lm.prefill"): (20, 0),
                   ("attn.rope", "lm.attention", "lm.prefill"): (5, 0),
                   ("lm.cache", "lm.prefill"): (10, 0)}, 100), 25.0),
    "cache_pct.prefill": (
        table_for({"lm.prefill": 1},
                  {("lm.cache", "lm.prefill"): (10, 0),
                   ("lm.norm", "lm.prefill"): (20, 0)}, 100), 10.0),
    "apply_aux_us.analog": (
        table_for({"analog.apply": 4},
                  {("analog.prep", "analog.apply"): (2, 0),
                   ("analog.readout", "analog.apply"): (0.4, 0),
                   ("analog.grid", "analog.apply"): (40, 0)}, 50), 600.0),
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_each_reader_reads_its_spans(name):
    table, want = READERS[name]
    assert harness.read_metric(name, {"spans": table}) == pytest.approx(want)
    # no spans table, and no traced window on a card to make one from
    assert harness.read_metric(name, {}) is None
    assert harness.read_metric(name, {"trace": None}) is None
    assert harness.read_metric(name, {"spans": None}) is None
    # a table from another cell's path
    other = table_for({"other": 1}, {("other",): (1, 1)}, 10)
    assert harness.read_metric(name, {"spans": other}) is None


PASS = {"rfnn64-infer-64k": ("analog.apply", 32),
        "granite-train-8x512": ("train.step", 2),
        "granite-prefill-mix": ("lm.prefill", 4)}


@pytest.mark.parametrize("cell", sorted(PASS))
def test_the_pass_runs_the_drivers_traced_closure_and_stops(cell,
                                                            monkeypatch):
    """On the CPU at the cells' reduced sizes, with the profiler's passes
    replaced by one run of the closure with spans on: the closure the
    driver traces runs under the span module and the driver stops there,
    before its reference check builds a single check."""
    import importlib

    from repro_torch.runtime import trace

    def once(torch, fn, sync, module):
        module.enable()
        fn()
        module.disable()
        rec = module.drain()
        return spans.reduce(rec.spans, [], (rec.anchors[0][0],
                                            rec.anchors[-1][0]),
                            threading.get_ident())

    spec = harness.cell_spec(cell)
    cfg, traffic = SMALL[cell]
    spec["config"].update(cfg)
    spec["traffic"].update(traffic)
    driver = importlib.import_module(
        f"bench.drivers.{spec['traffic']['driver']}")

    def no_check(*args):
        raise AssertionError("the driver went on past its traced closure")

    monkeypatch.setattr(driver, "Check", no_check)
    monkeypatch.setattr(spans, "measure", once)
    ctx = spans._SpansPass(trace, "cpu", 2**31 + 5, 0.05, True,
                           time.perf_counter())
    table = spans.run_pass(spec, ctx)
    name, calls = PASS[cell]
    assert table.calls[name] == calls
    if cell == "granite-train-8x512":
        assert table.calls["data.batch"] == calls
        assert table.calls["train.optimizer"] == calls
    if cell == "granite-prefill-mix":
        layers = spec["config"]["num_hidden_layers"]
        assert table.calls["lm.cache"] == calls * (layers + 1)
        assert table.calls["lm.norm"] == calls * (2 * layers + 1)
    if cell == "rfnn64-infer-64k":
        assert table.calls["analog.prep"] == table.calls["analog.readout"]


@pytest.mark.gpu
def test_a_host_sleep_inside_a_span_is_idle_in_that_span(card):
    """The spans' clock against the profiler's: a 5 ms host sleep inside a
    span, between two kernels, puts at least 4.9 ms of idle there, and each
    kernel's launch lies on its side of the span."""
    import torch

    from repro_torch.runtime import trace

    x = torch.ones(1024, device=card)
    x.add_(1)
    torch.cuda.synchronize(card)

    def fn():
        x.add_(1)
        with trace.span("host.sleep"):
            time.sleep(0.005)
        x.mul_(2)

    t = spans.measure(torch, fn, lambda: torch.cuda.synchronize(card), trace)
    assert t.unmatched == 0 and t.launches("host.sleep") == 0
    assert t.launches(spans.OUTSIDE) == 2
    assert t.calls == {"host.sleep": 1}
    assert t.idle_ms("host.sleep") >= 4.9
    assert t.idle_ms("host.sleep") <= t.window_ns * 1e-6
