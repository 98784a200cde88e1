"""The cell ``granite4h-prefill-32k`` (Granite 4.0's hybrid in long-document
prefill): its run on the CPU at a reduced size comes out correct, each
planted fault of the timed path comes out not correct (also at the
cell's own size on the card, marked ``gpu``), the fp8 control fails the
cell's limits (also at the cell's own size), the counts of ``bench/granite_counts.py`` against hand-worked
numbers, the four readers on hand-made records, and the spans pass up to
the driver's traced closure."""

import dataclasses
import importlib
import threading
import time

import pytest
import torch

from bench import granite_counts, harness, roofline, spans
from bench.drivers import granite_hybrid_prefill as driver

CELL = "granite4h-prefill-32k"
# one period of 10 layers at width 128 in float32; the cell's limits are set
# for bf16 at the published widths, whose errors average over wider sums.
# Scores x 0.5 (sharper than 1/sqrt(32)), so that the one attention layer of
# ten moves the logits enough for its planted RoPE to show.
SMALL = ({"hidden_size": 128, "num_attention_heads": 4,
          "num_key_value_heads": 2, "mamba_n_heads": 16, "mamba_d_head": 16,
          "mamba_d_state": 16, "mamba_chunk_size": 8, "router_experts": 16,
          "num_local_experts": 8, "num_experts_per_tok": 4,
          "intermediate_size": 16, "shared_intermediate_size": 32,
          "vocab_size": 512, "attention_multiplier": 0.5,
          "torch_dtype": "float32"},
         {"batches": [[4, 16], [2, 32], [1, 64]], "sample_batches": 2,
          "sample_rows": 2})
MS = 1_000_000


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tests run many small ops: one intra-op thread a test process
    keeps them from spinning against the other test processes' threads
    (the suite runs several workers on shared cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_spec():
    spec = harness.cell_spec(CELL)
    spec["config"].update(SMALL[0])
    spec["traffic"].update(SMALL[1])
    return spec


def run_small(seconds: float = 0.2) -> harness.Outcome:
    ctx = harness.RunContext("cpu", 2**31 + 11, seconds, False,
                             time.perf_counter())
    return harness.run_cell(small_spec(), ctx)


def test_a_sound_run_is_correct():
    out = run_small()
    assert out.correct, out.checks
    assert out.attempted > 0 and out.failed == 0
    checks = {c.name: c.value for c in out.checks}
    assert checks["dropped_choices"] == 0.0
    assert sum(out.records["moe_kept"]) > 0


def _config_fault(monkeypatch, **over):
    orig = driver.model_config
    monkeypatch.setattr(driver, "model_config", lambda c, t: dataclasses.
                        replace(orig(c, t), **over))


def _capacity(monkeypatch):
    """The expert buffer cut to one row a token: choices past it dropped."""
    from repro_torch.models import moe

    monkeypatch.setattr(moe, "dropless_rows", lambda cfg, tokens: tokens + 1)


def _no_conv_bias(monkeypatch):
    from repro_torch.models import ssm

    orig = ssm._causal_conv
    monkeypatch.setattr(ssm, "_causal_conv", lambda seq, w, state=None,
                        bias=0: orig(seq, w, state))


def _chunks_alone(monkeypatch):
    """The SSD scan with no state carried from one chunk to the next."""
    from repro_torch.models import ssm

    orig = ssm._scan

    def scan(params, cfg, x, bb, cc, dt):
        b, s = x.shape[:2]
        nc = s // min(cfg.ssm_chunk, s)

        def cut(t):
            return t.reshape(b * nc, s // nc, t.shape[-1])

        y, state = orig(params, cfg, cut(x), cut(bb), cut(cc), cut(dt))
        return y.reshape(b, s, -1), state.unflatten(0, (b, nc))[:, -1]

    monkeypatch.setattr(ssm, "_scan", scan)


FAULTS = {
    "capacity-drops-choices": _capacity,
    "rope-on": lambda mp: _config_fault(mp, nope=False),
    "residual-multiplier-1": lambda mp: _config_fault(
        mp, residual_multiplier=1.0),
    "conv-bias-dropped": _no_conv_bias,
    # the held experts' weights read one expert off: experts 1-9 computed
    "experts-shifted": lambda mp: _config_fault(mp, experts_first=1),
    "ssd-chunks-alone": _chunks_alone,
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = run_small()
    assert not out.correct, out.checks


@pytest.mark.gpu
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct_at_the_cells_size(
        fault, monkeypatch, card):
    """Each planted fault at the cell's own widths, depth and traffic on
    the card, in a window of one second."""
    torch.backends.cuda.matmul.allow_tf32 = False
    FAULTS[fault](monkeypatch)
    ctx = harness.RunContext(str(card), 2**31 + 11, 1.0, False,
                             time.perf_counter())
    out = harness.run_cell(harness.cell_spec(CELL), ctx)
    assert not out.correct, out.checks


def test_a_dropped_choice_fails_its_own_check(monkeypatch):
    _capacity(monkeypatch)
    checks = {c.name: c for c in run_small().checks}
    assert checks["dropped_choices"].value > 0
    assert not checks["dropped_choices"].ok


def control(device: str, small: bool, seed: int = 2**31 + 21):
    spec = small_spec() if small else harness.cell_spec(CELL)
    ctx = harness.RunContext(device, seed, 1.0, False, time.perf_counter())
    return driver.control(spec["config"], spec["traffic"], spec["cell"],
                          ctx), spec["cell"]["limits"]


def test_the_control_fails_at_a_reduced_size():
    readings, limits = control("cpu", small=True)
    assert any(readings[k] > limits[k] for k in limits), readings


@pytest.mark.gpu
def test_the_control_fails_at_the_cells_size(card):
    readings, limits = control(str(card), small=False)
    assert any(readings[k] > limits[k] for k in limits), readings


def test_model_flops_at_the_cells_shapes():
    cfg = harness.cell_spec(CELL)["config"]
    # a mamba layer: z, x (4096 x 8192 each), B, C (x 128), dt (x 128),
    # out (8192 x 4096); attention: q, o 4096 x 4096, k, v 4096 x 1024
    mamba = 4096 * (2 * 8192 + 2 * 128 + 128) + 8192 * 4096
    attn = 2 * 4096 * 4096 + 2 * 4096 * 1024
    # every layer: router 4096 x 72, shared 3 x 4096 x 1536, and 10 x 9 / 72
    # = 1.25 experts of 3 x 4096 x 768
    ffn = 4096 * 72 + 3 * 4096 * 1536 + 1.25 * 3 * 4096 * 768
    assert mamba == 102_236_160 and attn == 41_943_040
    assert granite_counts.matmul_params(cfg) == 9 * mamba + attn + 10 * ffn \
        == 1_271_726_080
    # 2 per weight and token, B9's causal half, 4 N P H a token a mamba
    # layer, the head once a prompt
    tokens = 32768
    att = 2 * 32 * 128 * 32768 ** 2
    ssd = 9 * 4 * 128 * 64 * 128 * tokens
    head = 2 * 100352 * 4096
    got = granite_counts.prefill_flops(cfg, 1, 32768)
    assert got == 2 * 1_271_726_080 * tokens + att + ssd + head
    assert att == pytest.approx(8.796e12, rel=1e-3)
    assert got == pytest.approx(9.338e13, rel=1e-3)
    # 8 x 4096: the attention term an eighth of one 32k prompt's
    assert granite_counts.prefill_flops(cfg, 8, 4096) == \
        2 * 1_271_726_080 * tokens + att / 8 + ssd + 8 * head


def test_ssd_bound_at_the_cells_shapes():
    cfg = harness.cell_spec(CELL)["config"]
    flops, nbytes = granite_counts.ssd_scan(cfg, 8, 4096)
    tokens = 32768
    # Q N + Q P H + 4 N P H a token; 2 N P H a chunk to pass the state on
    per_token = 256 * 128 + 256 * 64 * 128 + 4 * 128 * 64 * 128
    assert flops == tokens * per_token + 8 * 16 * 2 * 128 * 64 * 128
    # x and y bf16 (8192 each), B and C bf16 (128 each), dt float32 (128)
    assert nbytes == tokens * (2 * 8192 + 4 * 128 + 4 * 128 + 2 * 8192) \
        == 1_107_296_256
    bound = granite_counts.ssd_bound_s(cfg, 8, 4096)
    assert bound == pytest.approx(9 * max(nbytes / 3.35e12,
                                          flops / 989e12))
    assert bound == pytest.approx(9 * nbytes / roofline.HBM_BYTES_PER_S)


def test_b9_bound_at_the_cells_shapes():
    cfg = harness.cell_spec(CELL)["config"]
    # one attention layer: QK^T and PV over the causal half at 32 heads of
    # 128; q, o over 32 heads and k, v over 8 moved once in bf16
    flops = 4 * 32 * 32768 ** 2 * 128 * 0.5
    nbytes = 2 * 128 * (2 * 32 * 32768 + 2 * 8 * 32768)
    assert roofline.flash_fwd(1, 32, 8, 32768, 32768, 128, True) == \
        (flops, nbytes)
    assert granite_counts.b9_bound_s(cfg, 1, 32768) == pytest.approx(
        flops / 989e12)
    # 8 x 4096: an eighth of the flops, the same bytes
    assert granite_counts.b9_bound_s(cfg, 8, 4096) == pytest.approx(
        flops / 8 / 989e12)


class _Trace:
    busy_s, window_s = 3.0, 4.0


def _table(paths, calls, busy_ms=100):
    return spans.Table(calls=calls, host_self_ns={},
                       paths={p: [d * MS, 1, 0] for p, d in paths.items()},
                       busy_ns=busy_ms * MS, window_ns=2 * busy_ms * MS)


def test_the_readers_read_their_records():
    table = _table({("ssm.scan", "lm.ssm", "lm.prefill"): 40,
                    ("moe.experts", "lm.moe", "lm.ffn", "lm.prefill"): 12,
                    ("moe.shared", "lm.moe", "lm.ffn", "lm.prefill"): 5,
                    ("moe.combine", "lm.moe", "lm.ffn", "lm.prefill"): 3,
                    ("lm.norm", "lm.prefill"): 40},
                   {"ssm.scan": 9, "lm.moe": 10, "lm.prefill": 1})
    records = {"spans": table, "ssd_bound_s": 0.004, "trace": _Trace(),
               "flops": 989e12, "window_s": 2.0, "prompt_tokens": 64}
    read = harness.read_metric
    assert read("ssd_roofline.granite4h", records) == pytest.approx(10.0)
    assert read("moe_pct.granite4h", records) == pytest.approx(15.0)
    assert read("idle_pct.granite4h", records) == pytest.approx(25.0)
    assert read("mfu.granite4h", records) == pytest.approx(50.0)
    # another cell's records: nothing to read
    for name in ("ssd_roofline.granite4h", "moe_pct.granite4h",
                 "idle_pct.granite4h", "mfu.granite4h"):
        assert read(name, {"trace": None, "spans": None, "flops": 1.0,
                           "window_s": 1.0}) is None
    other = _table({("lm.norm", "lm.prefill"): 4}, {"lm.prefill": 1})
    assert read("moe_pct.granite4h", {"spans": other}) is None
    assert read("ssd_roofline.granite4h", {"spans": other,
                                           "ssd_bound_s": 1.0}) is None


def test_the_spans_pass_runs_the_drivers_traced_closure_and_stops(
        monkeypatch):
    """As ``test_bench_spans`` does for the other cells: the driver run to
    its traced closure (one cycle of the mix) under the span module, then
    stopped before its reference check."""
    from repro_torch.runtime import trace

    def once(torch_, fn, sync, module):
        module.enable()
        fn()
        module.disable()
        rec = module.drain()
        return spans.reduce(rec.spans, [], (rec.anchors[0][0],
                                            rec.anchors[-1][0]),
                            threading.get_ident())

    def no_check(*args):
        raise AssertionError("the driver went on past its traced closure")

    mod = importlib.import_module("bench.drivers.granite_hybrid_prefill")
    monkeypatch.setattr(mod, "Check", no_check)
    monkeypatch.setattr(spans, "measure", once)
    ctx = spans._SpansPass(trace, "cpu", 2**31 + 5, 0.05, True,
                           time.perf_counter())
    table = spans.run_pass(small_spec(), ctx)
    batches = len(SMALL[1]["batches"])
    assert table.calls["lm.prefill"] == batches
    assert table.calls["lm.moe"] == table.calls["lm.ffn"] == 10 * batches
    assert table.calls["ssm.scan"] == table.calls["lm.ssm"] == 9 * batches
    assert table.calls["attn.core"] == batches
    assert "attn.rope" not in table.calls
