"""The port's spans (``repro_torch.runtime.trace``): off by default and free
of state there; when on, one tree a top-level span on each thread, children
inside their parents; the trees of the three benchmarked paths (the LM
train step, ``Model.prefill``, a compiled deep program's apply); and the
same outputs, bit for bit, with tracing on and off."""

import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import compile as T  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.data import TokenStream  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.runtime import trace  # noqa: E402
from repro_torch.train import TrainState, make_train_step  # noqa: E402


@pytest.fixture(autouse=True)
def _tracing_off():
    trace.disable()
    trace.drain()
    yield
    trace.disable()
    trace.drain()


def traced(fn):
    """``fn()``'s result and the spans it recorded."""
    trace.enable()
    try:
        out = fn()
    finally:
        trace.disable()
    return out, trace.drain()


def names(rec, parent):
    """The names of ``parent``'s children, in order (-1: the roots)."""
    return [s[0] for s in rec.spans if s[1] == parent]


def children_inside_parents(rec):
    for k, (name, parent, root, a, b, th) in enumerate(rec.spans):
        assert a <= b
        if parent < 0:
            assert root == k
        else:
            p = rec.spans[parent]
            assert parent < k and root == p[2] and th == p[5]
            assert p[3] <= a and b <= p[4]


def test_off_records_nothing_and_hands_back_one_object():
    assert trace.span("a") is trace.span("b")
    with trace.span("a"):
        with trace.span("b"):
            pass
    rec = trace.drain()
    assert len(rec) == 0 and rec.spans == [] and rec.anchors == []


def test_off_context_lets_exceptions_through():
    with pytest.raises(KeyError):
        with trace.span("a"):
            raise KeyError("x")


def test_nesting_parents_roots_and_threads():
    def work():
        with trace.span("outer"):
            with trace.span("a"):
                with trace.span("a.1"):
                    pass
            with trace.span("b"):
                pass
        with trace.span("second"):
            pass

    def both():
        t = threading.Thread(target=work)
        t.start()
        work()
        t.join(timeout=30)
        assert not t.is_alive()

    _, rec = traced(both)
    assert len(rec) == 10 and len(rec.anchors) == 2
    children_inside_parents(rec)
    threads = {s[5] for s in rec.spans}
    assert len(threads) == 2
    for th in threads:
        mine = [(k, s) for k, s in enumerate(rec.spans) if s[5] == th]
        roots = [k for k, s in mine if s[1] < 0]
        assert [rec.spans[k][0] for k in roots] == ["outer", "second"]
        outer = roots[0]
        kids = [k for k, s in mine if s[1] == outer]
        assert [rec.spans[k][0] for k in kids] == ["a", "b"]
        assert [s[0] for _, s in mine if s[1] == kids[0]] == ["a.1"]
        assert all(s[2] == outer for k, s in mine if k != roots[1])
    # the anchors put the spans on the Unix clock, in order
    (p0, u0), (p1, u1) = rec.anchors
    assert p0 <= min(s[3] for s in rec.spans)
    assert max(s[4] for s in rec.spans) <= p1
    assert u0 <= rec.unix_ns(rec.spans[0][3]) <= u1


def test_drain_starts_a_new_list_while_on():
    trace.enable()
    with trace.span("x"):
        pass
    first = trace.drain()
    with trace.span("y"):
        pass
    trace.disable()
    second = trace.drain()
    assert names(first, -1) == ["x"] and names(second, -1) == ["y"]
    assert second.anchors[0] == first.anchors[-1]
    assert len(trace.drain()) == 0


def test_a_token_batch_is_one_span_and_the_same_batch():
    stream = TokenStream(vocab_size=50, seq_len=8, global_batch=2, seed=1)
    off = stream.batch(3)
    on, rec = traced(lambda: stream.batch(3))
    assert names(rec, -1) == ["data.batch"] and len(rec) == 1
    assert all(np.array_equal(off[k], on[k]) for k in off)


def small_lm(**kw):
    cfg = dataclasses.replace(configs.get_reduced("granite-3-2b"),
                              dtype="float32", **kw)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(3), device="cpu")
    return cfg, model, params


def batch_of(cfg, b=2, s=16, seed=4):
    g = torch.Generator().manual_seed(seed)
    tok = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=g)
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


def same(a, b):
    la, lb = (torch.utils._pytree.tree_leaves(t) for t in (a, b))
    return len(la) == len(lb) and all(
        torch.equal(x, y) for x, y in zip(la, lb))


def layer_spans(rec, parent, n_layers):
    """The forward's spans under ``parent`` with each layer's collapsed."""
    want = ["lm.embed"] + ["lm.norm", "lm.attention", "lm.norm",
                           "lm.ffn"] * n_layers + ["lm.norm", "lm.unembed"]
    assert names(rec, parent) == want
    for k, s in enumerate(rec.spans):
        if s[0] == "lm.attention":
            assert names(rec, k) == ["attn.rope", "attn.core"]


def test_train_step_tree_and_bit_equal_outputs():
    cfg, model, params = small_lm()
    opt = AdamW(lr=1e-3, weight_decay=0.1)
    step = make_train_step(model, opt)
    batch = batch_of(cfg)

    def two_steps():
        state = TrainState(params=params, opt=opt.init(params))
        out = []
        for _ in range(2):
            state, metrics = step(state, batch)
            out.append((state, metrics))
        return out

    off = two_steps()
    on, rec = traced(two_steps)
    assert same(off, on)
    children_inside_parents(rec)
    roots = [k for k, s in enumerate(rec.spans) if s[1] < 0]
    assert [rec.spans[k][0] for k in roots] == ["train.step"] * 2
    for r in roots:
        assert names(rec, r) == ["train.forward", "train.backward",
                                 "train.optimizer"]
        fwd = next(k for k, s in enumerate(rec.spans)
                   if s[1] == r and s[0] == "train.forward")
        layer_spans(rec, fwd, cfg.n_layers)
    assert len(rec) == 2 * (4 + 3 + 6 * cfg.n_layers)


def test_prefill_tree_and_bit_equal_outputs():
    cfg, model, params = small_lm(attn_impl="pallas")
    tokens = batch_of(cfg, s=24)["tokens"]

    def run():
        with torch.no_grad():
            return model.prefill(params, {"tokens": tokens})

    off = run()
    on, rec = traced(run)
    assert same(off, on)
    children_inside_parents(rec)
    assert names(rec, -1) == ["lm.prefill"]
    want = ["lm.embed", "lm.cache"] + ["lm.norm", "lm.attention",
                                       "lm.cache", "lm.norm",
                                       "lm.ffn"] * cfg.n_layers
    assert names(rec, 0) == want + ["lm.norm", "lm.unembed"]
    counts = {n: sum(s[0] == n for s in rec.spans) for n in set(want)}
    assert counts["lm.attention"] == counts["lm.ffn"] == cfg.n_layers
    assert counts["lm.cache"] == cfg.n_layers + 1


@pytest.mark.parametrize("arch, layer", [
    ("mamba2-780m", ["lm.norm", "lm.ssm", "lm.cache"]),
    ("qwen2-moe-a2.7b", ["lm.norm", "lm.attention", "lm.cache", "lm.norm",
                         "lm.ffn"])])
def test_prefill_tree_of_the_ssm_and_moe_layers(arch, layer):
    """Every layout's mamba2 mixer runs inside ``lm.ssm`` with its state
    copied inside ``lm.cache``, and every MoE inside ``lm.moe`` under
    ``lm.ffn``."""
    cfg = dataclasses.replace(configs.get_reduced(arch), dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(3), device="cpu")
    tokens = batch_of(cfg, s=16)["tokens"]

    def run():
        with torch.no_grad():
            return model.prefill(params, {"tokens": tokens})

    off = run()
    on, rec = traced(run)
    assert same(off, on)
    children_inside_parents(rec)
    assert names(rec, -1) == ["lm.prefill"]
    assert names(rec, 0) == (["lm.embed", "lm.cache"] + layer * cfg.n_layers
                             + ["lm.norm", "lm.unembed"])
    for k, s in enumerate(rec.spans):
        if s[0] == "lm.ssm":
            assert names(rec, k) == ["ssm.proj", "ssm.conv", "ssm.scan",
                                     "ssm.out"]
        elif s[0] == "lm.ffn":
            assert names(rec, k) == ["lm.moe"]
        elif s[0] == "lm.cache":
            assert names(rec, k) == []


def test_compiled_apply_tree_and_bit_equal_outputs():
    rng = np.random.default_rng(5)
    place = T.TilePlacement((1, 0), (1, 0))
    layers = []
    for l in range(3):
        tp = T.program_tiled(T.synthesize_tiled(
            rng.normal(size=(8, 8)) / np.sqrt(8), 4, device="cpu"))
        layers.append(T.apply_placement(tp, place) if l != 1 else tp)
    prog = T.lower_deep(layers)
    x = torch.from_numpy(rng.normal(size=(6, 8)).astype(np.float32))
    off = prog.apply(x)
    on, rec = traced(lambda: prog.apply(x))
    assert torch.equal(off, on)
    children_inside_parents(rec)
    assert names(rec, -1) == ["analog.apply"]
    assert names(rec, 0) == ["analog.prep", "analog.grid", "analog.readout"]
    assert len(rec) == 4
