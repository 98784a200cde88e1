"""The port's serving engine against the JAX package's.

The deployed 8x8 processor (``AnalogUnitary(n=8, hardware=PROTOTYPE,
quantize="table1", output="abs")`` with params made by the JAX package)
answers the same requests through both engines; each result must match
per request to 1e-5 (float32 sums in another order).  Deadlines, block and
reject admission, the dispatch thread and the failure-injector hook follow
the JAX engine's semantics.  The LM slot family serves the reduced
TinyLlama in float32 with the JAX package's params, wherever the greedy
choice is clear (a top-2 logit margin above the parity tolerance): every
request's tokens equal a batch-1 ``prefill`` and greedy ``decode_step`` of
its prompt, in the port and in the JAX package, whatever shares the slots;
at ``slots=1`` they also equal the JAX engine's (which shares one position
across its slots, so only there is it right).  The moe, ssm, hybrid and
encdec families' reduced configs match the JAX engine serving each request
alone at ``slots=1`` (C-ref10: the JAX engine keeps a reused slot's SSM
state), and at two staggered slots each request gets its tokens alone.  ``decode_step`` with a
position per row equals the JAX package's row by row at batch 1.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.analog_linear import AnalogUnitary as JAnalogUnitary  # noqa: E402
from repro.paper.prototype import PROTOTYPE as J_PROTOTYPE  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro_torch.core.analog_linear import AnalogUnitary  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.paper.prototype import PROTOTYPE  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    Request,
    ServableProgram,
    ServingEngine,
    as_servable,
)

jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(scope="module")
def deployed():
    jmodel = JAnalogUnitary(n=8, hardware=J_PROTOTYPE, quantize="table1",
                            output="abs")
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(4)))
    tmodel = AnalogUnitary(n=8, hardware=PROTOTYPE, quantize="table1",
                           output="abs")
    return jmodel, tree, tmodel, params_from_numpy(tree, "cpu")


def _features(k, seed=0):
    return np.random.default_rng(seed).normal(size=(k, 8)).astype(np.float32)


def _engine(deployed, **kw):
    _, _, tmodel, tparams = deployed
    return ServingEngine(tmodel, tparams, device="cpu", **kw)


@pytest.mark.parametrize("jax_backend", ["reference", "pallas"])
def test_engine_results_match_jax_engine(deployed, jax_backend):
    jmodel, tree, _, _ = deployed
    if jax_backend == "pallas":
        jmodel = JAnalogUnitary(n=8, hardware=J_PROTOTYPE, quantize="table1",
                                output="abs", backend="pallas")
    feats = _features(11)
    jeng = JServingEngine(jmodel, jax.tree.map(jnp.asarray, tree), slots=4)
    teng = _engine(deployed, slots=4)
    jreqs = [JRequest(i, features=f) for i, f in enumerate(feats)]
    treqs = [Request(i, features=f) for i, f in enumerate(feats)]
    for r in jreqs:
        jeng.submit(r)
    calls = ops.KERNEL_PATH_CALLS["mesh_apply"]
    for r in treqs:
        teng.submit(r)
    teng.run()
    jeng.run()
    assert ops.KERNEL_PATH_CALLS["mesh_apply"] == calls + 3   # 3 ticks
    for rj, rt in zip(jreqs, treqs):
        assert rt.done and not rt.failed
        assert rt.result.shape == (8,)
        np.testing.assert_allclose(rt.result, np.asarray(rj.result),
                                   rtol=1e-5, atol=1e-5)
    assert teng.stats["served"] == jeng.stats["served"] == 11
    assert teng.stats["ticks"] == jeng.stats["ticks"] == 3


def test_engine_result_equals_direct_apply_of_its_row(deployed):
    _, _, tmodel, tparams = deployed
    feats = _features(9, seed=1)
    eng = _engine(deployed, slots=4)
    reqs = [Request(i, features=f) for i, f in enumerate(feats)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    direct = tmodel.apply(tparams, torch.from_numpy(feats)).numpy()
    for i, r in enumerate(reqs):
        np.testing.assert_allclose(r.result, direct[i], rtol=0, atol=1e-7)


def test_deadline_expiry_matches_jax_semantics(deployed):
    """slots=1: the head of the queue gets exactly k service ticks."""
    jmodel, tree, _, _ = deployed
    feats = _features(4, seed=2)
    counts = []
    for eng, req_cls in ((_engine(deployed, slots=1), Request),
                         (JServingEngine(jmodel, jax.tree.map(jnp.asarray,
                                                              tree),
                                         slots=1), JRequest)):
        reqs = [req_cls(i, features=f, deadline_ticks=2)
                for i, f in enumerate(feats)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        counts.append(([r.failed for r in reqs], eng.stats["expired"],
                       eng.stats["served"]))
    assert counts[0] == counts[1]
    assert counts[0][1] > 0


def test_reject_admission_fails_fast(deployed):
    eng = _engine(deployed, slots=1, max_queue=2, admission="reject")
    reqs = [Request(i, features=f) for i, f in enumerate(_features(4))]
    assert [eng.submit(r) for r in reqs] == [True, True, False, False]
    assert reqs[3].wait(timeout=1) and reqs[3].failed
    assert eng.stats["rejected"] == 2
    eng.run()
    assert eng.stats["served"] == 2


def test_block_admission_waits_then_times_out(deployed):
    eng = _engine(deployed, slots=2, max_queue=1, admission="block")
    first, second = (Request(i, features=f) for i, f in enumerate(_features(2)))
    assert eng.submit(first)
    assert not eng.submit(second, timeout=0.05)   # full: times out, rejected
    assert second.failed and eng.stats["rejected"] == 1
    third = Request(3, features=_features(1)[0])
    t = threading.Thread(target=lambda: eng.submit(third))
    t.start()
    eng.tick()                                    # drains: third gets space
    t.join(timeout=5)
    assert not t.is_alive()
    eng.run()
    assert first.done and third.done and not third.failed
    with pytest.raises(ValueError):
        _engine(deployed, slots=1, admission="drop")


def test_dispatch_thread_serves_other_threads(deployed):
    feats = _features(20, seed=3)
    reqs = [Request(i, features=f) for i, f in enumerate(feats)]
    with _engine(deployed, slots=8) as eng:
        threads = [threading.Thread(target=eng.submit, args=(r,))
                   for r in reqs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        assert all(r.wait(timeout=10) for r in reqs)
    assert eng.stats["served"] == 20 and eng.stats["queue_depth"] == 0
    assert eng._thread is None


def test_failure_injector_swaps_program_mid_stream(deployed):
    """The hook: a fired tile_down rebinds the engine to the recovery."""
    _, _, tmodel, tparams = deployed

    class Fired:
        kind = "tile_down"

    class Injector:
        dead_tiles = {(0, 0)}

        def at_step(self, step):
            return [Fired()] if step == 1 else []

    swapped = []

    def recovery(dead):
        swapped.append(dead)
        return as_servable(tmodel, {k: v.clone() for k, v in tparams.items()})

    eng = _engine(deployed, slots=2, failure_injector=Injector(),
                  recovery=recovery)
    reqs = [Request(i, features=f) for i, f in enumerate(_features(5))]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert swapped == [((0, 0),)]
    assert eng.stats["recovered"] == 1 and eng.stats["served"] == 5
    assert eng.events == [{"tick": 1, "kind": "tile_recovery",
                           "dead_tiles": ((0, 0),)}]


def test_compiled_tiled_program_recovers_mid_stream():
    """The real ``FailureInjector`` kills physical tile row 0 at tick 1; the
    engine swaps in the program's own ``recover(dead)`` and every request is
    answered by the program bound at its tick."""
    from repro_torch import compile as t_compile
    from repro_torch.runtime import FailureInjector, tile_row_failures

    w = np.zeros((8, 8), np.float32)
    w[:4] = np.random.default_rng(5).normal(size=(4, 8))  # mass in row 0
    tp = t_compile.program_tiled(t_compile.synthesize_tiled(
        w, tile=4, device="cpu"))
    comp = t_compile.lower_tiled(t_compile.calibrate_tiled(
        tp, PROTOTYPE, key=2, steps=0))
    inj = FailureInjector(tile_row_failures(step=1, row=0, ti=2))
    eng = ServingEngine(comp, slots=2, device="cpu", failure_injector=inj)
    feats = _features(6, seed=3)
    reqs = [Request(i, features=f) for i, f in enumerate(feats)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert eng.events == [{"tick": 1, "kind": "tile_recovery",
                           "dead_tiles": ((0, 0), (0, 1))}]
    assert eng.stats["recovered"] == 1 and eng.stats["served"] == 6
    recovered = eng._impl.servable
    assert recovered is not comp and recovered.placement.row_perm == (1, 0)
    for r in reqs:
        prog = comp if r.completed_tick == 1 else recovered
        want = prog.apply(torch.from_numpy(r.payload[None]))[0].numpy()
        np.testing.assert_allclose(r.result, want, rtol=0, atol=1e-6)
    assert [r.completed_tick for r in reqs] == [1, 1, 2, 2, 3, 3]


def test_unported_engine_modes_raise(deployed):
    _, _, tmodel, tparams = deployed

    class LM:
        def decode_step(self, *a):
            pass

    # the LM slot family is ported; it refuses to start without a cache length
    with pytest.raises(ValueError, match="max_len"):
        ServingEngine(LM(), None, slots=2, device="cpu")
    with pytest.raises(ValueError, match="no axis"):
        ServingEngine(tmodel, tparams, slots=2, device="cpu", mesh=object())
    bound = as_servable(tmodel, tparams)
    assert isinstance(bound, ServableProgram) and bound.n_in == 8
    with pytest.raises(ValueError):
        bound.recover(((0, 0),))


@pytest.mark.parametrize("kind", ["tiled", "sequence"])
def test_engine_serves_deep_models_with_zero_steady_state_packs(kind):
    """A bound ``TiledAnalogLinear`` (the 1 x To x Ti deep grid) and an
    ``AnalogSequence`` (L x 1 x 1) served: each result equals the JAX
    engine's for the same request, and after the first tick packed the
    coefficients no tick packs again."""
    from repro.core import analog_linear as j_al
    from repro_torch.core import analog_linear as t_al

    if kind == "tiled":
        jmodel = j_al.TiledAnalogLinear(in_dim=16, out_dim=8, tile_size=4,
                                        output="abs")
        tmodel = t_al.TiledAnalogLinear(in_dim=16, out_dim=8, tile_size=4,
                                        output="abs")
        event, d_in = "tiled_apply", 16
    else:
        jmodel = j_al.AnalogSequence(n=8, depth=3)
        tmodel = t_al.AnalogSequence(n=8, depth=3)
        event, d_in = "rfnn_network", 8
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(6)))
    feats = np.random.default_rng(6).normal(size=(9, d_in)).astype(np.float32)
    jeng = JServingEngine(jmodel, jax.tree.map(jnp.asarray, tree), slots=3)
    teng = ServingEngine(as_servable(tmodel, params_from_numpy(tree, "cpu")),
                         slots=3, device="cpu")
    assert teng.stats["served"] == 0
    jreqs = [JRequest(i, features=f) for i, f in enumerate(feats)]
    treqs = [Request(i, features=f) for i, f in enumerate(feats)]
    for rj, rt in zip(jreqs, treqs):
        jeng.submit(rj)
        teng.submit(rt)
    jeng.run()
    assert teng.tick() == 3                    # the first tick packs once
    packs = ops.PACK_EVENTS[event]
    teng.run()
    assert ops.PACK_EVENTS[event] == packs     # steady state: no packing
    for rj, rt in zip(jreqs, treqs):
        assert rt.done and not rt.failed
        np.testing.assert_allclose(rt.result, np.asarray(rj.result),
                                   rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the LM slot family
# ---------------------------------------------------------------------------

LM_MARGIN = 1e-3   # top-2 logit margin above the 1e-4 parity of the LM tests


@pytest.fixture(scope="module")
def tiny_lm():
    import dataclasses

    from repro import configs as j_configs
    from repro.models import Model as JModel
    from repro_torch import configs as t_configs
    from repro_torch.models import Model

    jcfg = dataclasses.replace(j_configs.get_reduced("tinyllama-1.1b"),
                               dtype="float32")
    tcfg = dataclasses.replace(t_configs.get_reduced("tinyllama-1.1b"),
                               dtype="float32")
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(7))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, Model(tcfg), tp


def _prompts(k, length, vocab=512, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, length).astype(np.int32) for _ in range(k)]


def _lm_engine(tiny_lm, margins=None, **kw):
    _, _, tm, tp = tiny_lm
    engine = None

    def sample(logits):
        top2 = torch.topk(logits.float(), 2, dim=-1).values
        active = [i for i, s in enumerate(engine._impl.slots) if s.req]
        margins.extend((top2[active, 0] - top2[active, 1]).tolist())
        return torch.argmax(logits, -1)

    engine = ServingEngine(tm, tp, device="cpu",
                           sample=None if margins is None else sample, **kw)
    return engine


_J_DECODE: dict = {}


def _port_greedy(tiny_lm, prompt, n, max_len):
    """``n`` tokens of a batch-1 prefill of ``prompt`` and greedy decode."""
    tm, tp = tiny_lm[2:]
    out = []
    with torch.no_grad():
        logits, cache = tm.prefill(
            tp, {"tokens": torch.from_numpy(prompt[None])}, max_len=max_len)
        while True:
            out.append(int(torch.argmax(logits[0])))
            if len(out) == n:
                return out
            logits, cache = tm.decode_step(
                tp, torch.tensor(out[-1:], dtype=torch.int32), cache,
                len(prompt) + len(out) - 1)


def _jax_greedy(tiny_lm, prompt, n, max_len):
    """The same through the JAX package's ``Model.prefill``/``decode_step``."""
    jm, jp = tiny_lm[:2]
    if max_len not in _J_DECODE:
        _J_DECODE[max_len] = (
            jax.jit(lambda p, b: jm.prefill(p, b, max_len=max_len)),
            jax.jit(lambda p, tk, c, pos: jm.decode_step(p, tk, c, pos)))
    prefill, decode = _J_DECODE[max_len]
    logits, cache = prefill(jp, {"tokens": jnp.asarray(prompt[None])})
    out = []
    while True:
        out.append(int(jnp.argmax(logits[0])))
        if len(out) == n:
            return out
        logits, cache = decode(jp, jnp.asarray(out[-1:], jnp.int32), cache,
                               jnp.asarray(len(prompt) + len(out) - 1,
                                           jnp.int32))


@pytest.mark.parametrize("slots", [1, 4])
def test_lm_engine_tokens_match_jax_engine(tiny_lm, slots):
    """Six requests through both engines: the same ticks and served count.
    At ``slots=1`` the tokens equal the JAX engine's; at ``slots=4`` the JAX
    engine decodes every slot at one shared position (ROADMAP C-ref6), so
    there the tokens are held to each prompt's batch-1 prefill and greedy
    decode, in both packages."""
    jm, jp = tiny_lm[:2]
    prompts = _prompts(6, 5)
    jeng = JServingEngine(jm, jp, slots=slots, max_len=24)
    jreqs = [JRequest(i, prompt=p, max_new=6) for i, p in enumerate(prompts)]
    for r in jreqs:
        jeng.submit(r)
    jeng.run()
    margins: list = []
    teng = _lm_engine(tiny_lm, margins, slots=slots, max_len=24)
    treqs = [Request(i, prompt=p, max_new=6) for i, p in enumerate(prompts)]
    for r in treqs:
        teng.submit(r)
    teng.run()
    assert min(margins) > LM_MARGIN  # every greedy choice is clear
    for jr, tr, p in zip(jreqs, treqs, prompts):
        assert tr.done and not tr.failed and len(tr.result) == 6
        assert tr.output == list(tr.result)
        if slots == 1:
            np.testing.assert_array_equal(tr.result, jr.result)
        else:
            want = _port_greedy(tiny_lm, p, 6, 24)
            np.testing.assert_array_equal(tr.result, want)
            assert _jax_greedy(tiny_lm, p, 6, 24) == want
    assert teng.ticks == jeng.ticks
    assert teng.stats["served"] == 6


@pytest.mark.parametrize("slots", [2, 4])
def test_lm_engine_staggered_requests_match_batch1_decode(tiny_lm, slots):
    """ROADMAP C-ref6: requests of different prompt lengths (one of a single
    token) and ``max_new``, submitted at different ticks, overlap in the slots;
    each one's tokens equal a batch-1 prefill and greedy decode of its
    prompt, in the port and in the JAX package."""
    rng = np.random.default_rng(10 + slots)
    lens, max_new = [5, 3, 8, 1, 6, 4], [6, 2, 4, 5, 3, 7]
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in lens]
    reqs = [Request(i, prompt=p, max_new=m)
            for i, (p, m) in enumerate(zip(prompts, max_new))]
    submit_at = {0: [0, 1], 2: [2], 3: [3, 4], 5: [5]}  # tick -> requests
    margins: list = []
    engine = _lm_engine(tiny_lm, margins, slots=slots, max_len=24)
    busy = []
    for tick in range(100):
        for i in submit_at.get(tick, []):
            engine.submit(reqs[i])
        engine.tick()
        busy.append(engine._impl.n_active())
        if tick > max(submit_at) and not engine._has_work():
            break
    assert max(busy) == slots  # the requests did share the slots
    assert min(margins) > LM_MARGIN
    for r, p, m in zip(reqs, prompts, max_new):
        assert r.done and not r.failed
        want = _port_greedy(tiny_lm, p, m, 24)
        np.testing.assert_array_equal(r.result, want)
        assert _jax_greedy(tiny_lm, p, m, 24) == want
    assert engine.stats["served"] == len(reqs)


def test_decode_step_per_row_positions_match_jax_rows(tiny_lm):
    """``decode_step`` with a position per row (one past the cache's end,
    clamped) against the JAX package's ``decode_step`` on each row alone;
    an int position and a tensor of that position agree exactly."""
    jm, jp, tm, tp = tiny_lm
    rng = np.random.default_rng(5)
    max_len, pos = 16, np.array([3, 0, 9, 15, 18], np.int32)
    tokens = rng.integers(0, 512, len(pos)).astype(np.int32)
    cache = tm.init_cache(len(pos), max_len, device="cpu")
    for layer in cache.values():
        for t in layer.values():
            t.copy_(torch.from_numpy(rng.normal(size=t.shape).astype(
                np.float32)))
    host = {n: {kv: t.numpy().copy() for kv, t in layer.items()}
            for n, layer in cache.items()}
    with torch.no_grad():
        logits, cache = tm.decode_step(tp, torch.from_numpy(tokens), cache,
                                       torch.from_numpy(pos))
    decode = jax.jit(lambda p, tk, c, ps: jm.decode_step(p, tk, c, ps))
    for b, p in enumerate(pos):
        row = jax.tree.map(lambda a: jnp.asarray(a[:, b:b + 1]), host)
        jl, jc = decode(jp, jnp.asarray(tokens[b:b + 1]), row,
                        jnp.asarray(p, jnp.int32))
        jl = np.asarray(jl)[0]
        assert np.abs(logits[b].numpy() - jl).max() <= 1e-4 * np.abs(jl).max()
        for n, layer in cache.items():
            for kv, t in layer.items():
                np.testing.assert_allclose(t[:, b].numpy(),
                                           np.asarray(jc[n][kv])[:, 0],
                                           rtol=0, atol=1e-5)
    same = np.full(len(pos), 7, np.int32)
    with torch.no_grad():
        by_int, _ = tm.decode_step(tp, torch.from_numpy(tokens),
                                   tm.init_cache(len(pos), max_len,
                                                 device="cpu"), 7)
        by_row, _ = tm.decode_step(tp, torch.from_numpy(tokens),
                                   tm.init_cache(len(pos), max_len,
                                                 device="cpu"),
                                   torch.from_numpy(same))
    assert torch.equal(by_int, by_row)


def test_lm_engine_admission_eos_and_max_new(tiny_lm):
    """At most ``slots`` requests decode at once; a request stops at its
    ``max_new`` or at its ``eos_id`` (the token included), and its slot
    frees for the next queued request on the following tick."""
    prompts = _prompts(5, 4, seed=1)

    def requests(eos_id):
        return [Request(0, prompt=prompts[0], max_new=5, eos_id=eos_id)] + [
            Request(i, prompt=p, max_new=3)
            for i, p in enumerate(prompts[1:], 1)]

    probe = _lm_engine(tiny_lm, slots=2, max_len=20)
    free_run = requests(None)
    for r in free_run:
        probe.submit(r)
    probe.run()
    eos = int(free_run[0].result[2])  # request 0's third greedy token
    stop = list(free_run[0].result).index(eos) + 1

    engine = _lm_engine(tiny_lm, slots=2, max_len=20)
    reqs = requests(eos)
    for r in reqs:
        engine.submit(r)
    active_seen = []
    while engine.tick() or engine._has_work():
        active_seen.append(engine._impl.n_active())
    assert max(active_seen) <= 2
    np.testing.assert_array_equal(reqs[0].result, free_run[0].result[:stop])
    assert reqs[0].result[-1] == eos and len(free_run[0].result) == 5
    assert all(len(r.result) == 3 for r in reqs[1:])
    assert engine.stats["served"] == 5 and engine.queue_depth == 0


def _lm_pair(name):
    """The reduced ``name`` in float32 in both packages, with the JAX
    package's params carried across."""
    import dataclasses

    from repro import configs as j_configs
    from repro.models import Model as JModel
    from repro_torch import configs as t_configs
    from repro_torch.models import Model

    jm = JModel(dataclasses.replace(j_configs.get_reduced(name),
                                    dtype="float32"))
    jp = jm.init(jax.random.PRNGKey(3))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, Model(dataclasses.replace(t_configs.get_reduced(name),
                                             dtype="float32")), tp


@pytest.mark.parametrize("kind", ["long_prompts", "vlm"])
def test_lm_engine_serves_what_jax_engine_serves_alone(tiny_lm, kind):
    """Prompts the cache cannot hold (longer than ``max_len + 1``) and a vlm
    served from tokens alone (a Request carries no patch embeddings): each
    request, sharing two slots with the others, gets the tokens the JAX
    engine gives it alone at ``slots=1`` (fed a token at a time, each write
    past the cache's end clamped into its last slot)."""
    max_len = 12
    if kind == "vlm":
        lm = _lm_pair("internvl2-2b")
        lens, max_new = [5, 9, 3, 7], [4, 3, 5, 2]
    else:
        lm = tiny_lm
        lens, max_new = [max_len + 5, 4, max_len - 3, max_len + 1,
                         2 * max_len], [3, 5, 6, 2, 1]
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in lens]
    margins: list = []
    engine = _lm_engine(lm, margins, slots=2, max_len=max_len)
    reqs = [Request(i, prompt=p, max_new=m)
            for i, (p, m) in enumerate(zip(prompts, max_new))]
    for r in reqs:
        engine.submit(r)
    engine.run()
    assert min(margins) > LM_MARGIN
    jm, jp = lm[:2]
    for r, p, m in zip(reqs, prompts, max_new):
        jeng = JServingEngine(jm, jp, slots=1, max_len=max_len)
        jr = JRequest(0, prompt=p, max_new=m)
        jeng.submit(jr)
        jeng.run()
        assert r.done and not r.failed and not jr.failed
        np.testing.assert_array_equal(r.result, jr.result)
    assert engine.stats["served"] == len(reqs)


FAMILIES = ["qwen2-moe-a2.7b", "mamba2-780m", "zamba2-1.2b",
            "whisper-large-v3"]
_FAMILY_LM: dict = {}


def _family(name):
    if name not in _FAMILY_LM:
        _FAMILY_LM[name] = _lm_pair(name)
    return _FAMILY_LM[name]


# heads of 4, 11, 2 and 18 tokens and none: within and past ssm_chunk 8
# (prefilled to 8 and 16, the rest decoded), shorter than the conv window,
# past the MoE's no-drop prefix.  Their prompts' seeds (33, 36) give every
# greedy choice of the four families a top-2 margin above LM_MARGIN, the
# precondition of comparing tokens (seeds 31 and 32 have a near-tie of
# 3.8e-4 in zamba2, where a 1e-4 difference could flip a token)
FAMILY_LENS, FAMILY_NEW = [5, 12, 3, 19, 1], [4, 3, 5, 2, 3]


def _serve_alone(lm, prompt, max_new, max_len, margins=None):
    engine = _lm_engine(lm, margins, slots=1, max_len=max_len)
    req = Request(0, prompt=prompt, max_new=max_new)
    engine.submit(req)
    engine.run()
    assert req.done and not req.failed
    return req.result


def _jax_alone(lm, prompt, max_new, max_len):
    jm, jp = lm[:2]
    jeng = JServingEngine(jm, jp, slots=1, max_len=max_len)
    jr = JRequest(0, prompt=prompt, max_new=max_new)
    jeng.submit(jr)
    jeng.run()
    assert jr.done and not jr.failed
    return jr.result


@pytest.mark.parametrize("name", FAMILIES)
def test_lm_engine_family_matches_jax_engine(name):
    """The moe, ssm, hybrid and encdec families at ``slots=1``: each request,
    through one port engine after the others, gets the tokens a fresh JAX
    engine gives it alone.  The port prefills what ``Model.prefill_len``
    allows and decodes the rest; the JAX engine decodes every prompt token
    (an encdec request, which carries no frames, against an empty cross
    cache in both).  A fresh JAX engine per request, because the JAX engine
    keeps a reused slot's SSM state (ROADMAP C-ref10, pinned below)."""
    lm = _family(name)
    rng = np.random.default_rng(33)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in FAMILY_LENS]
    margins: list = []
    teng = _lm_engine(lm, margins, slots=1, max_len=24)
    treqs = [Request(i, prompt=p, max_new=m)
             for i, (p, m) in enumerate(zip(prompts, FAMILY_NEW))]
    for r in treqs:
        teng.submit(r)
    teng.run()
    assert min(margins) > LM_MARGIN
    for tr, p, m in zip(treqs, prompts, FAMILY_NEW):
        assert tr.done and not tr.failed
        np.testing.assert_array_equal(tr.result, _jax_alone(lm, p, m, 24))
    assert teng.stats["served"] == len(prompts)


def test_jax_engine_keeps_a_reused_slots_ssm_state():
    """ROADMAP C-ref10, held as the reference's behaviour: at ``slots=1`` the
    JAX engine admits a request into the slot the last one left without
    resetting its SSM state, so a mamba2 request served after others gets
    other tokens than alone; the port's engine writes the whole row at
    admission and gives every request its tokens alone."""
    lm = _family("mamba2-780m")
    jm, jp = lm[:2]
    rng = np.random.default_rng(33)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in FAMILY_LENS]
    jeng = JServingEngine(jm, jp, slots=1, max_len=24)
    jreqs = [JRequest(i, prompt=p, max_new=m)
             for i, (p, m) in enumerate(zip(prompts, FAMILY_NEW))]
    for r in jreqs:
        jeng.submit(r)
    jeng.run()
    alone = [_jax_alone(lm, p, m, 24) for p, m in zip(prompts, FAMILY_NEW)]
    np.testing.assert_array_equal(jreqs[0].result, alone[0])
    assert any(not np.array_equal(r.result, a)
               for r, a in zip(jreqs[1:], alone[1:]))
    teng = _lm_engine(lm, slots=1, max_len=24)
    treqs = [Request(i, prompt=p, max_new=m)
             for i, (p, m) in enumerate(zip(prompts, FAMILY_NEW))]
    for r in treqs:
        teng.submit(r)
    teng.run()
    for r, a in zip(treqs, alone):
        np.testing.assert_array_equal(r.result, a)


@pytest.mark.parametrize("name", FAMILIES)
def test_lm_engine_family_staggered_matches_alone(name):
    """Two slots, requests submitted at different ticks and overlapping:
    each request's tokens equal the port engine's for it alone at
    ``slots=1`` (which the tests above hold to the JAX engine).  An SSM
    row's state starts from its own prompt whatever the row held before."""
    lm = _family(name)
    rng = np.random.default_rng(36)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in FAMILY_LENS]
    reqs = [Request(i, prompt=p, max_new=m)
            for i, (p, m) in enumerate(zip(prompts, FAMILY_NEW))]
    submit_at = {0: [0, 1], 2: [2], 3: [3], 5: [4]}
    margins: list = []
    engine = _lm_engine(lm, margins, slots=2, max_len=24)
    busy = []
    for tick in range(100):
        for i in submit_at.get(tick, []):
            engine.submit(reqs[i])
        engine.tick()
        busy.append(engine._impl.n_active())
        if tick > max(submit_at) and not engine._has_work():
            break
    assert max(busy) == 2
    assert min(margins) > LM_MARGIN
    for r, p, m in zip(reqs, prompts, FAMILY_NEW):
        assert r.done and not r.failed
        np.testing.assert_array_equal(r.result, _serve_alone(lm, p, m, 24))
    assert engine.stats["served"] == len(reqs)


def test_engine_prefill_len_per_family():
    """How much of a prompt head the engine prefills (``Model.prefill_len``):
    all of it (dense), up to the SSM chunk or a multiple of it, none for
    moe (whose prefill can drop what decode keeps), vlm and encdec."""
    from repro_torch import configs as t_configs
    from repro_torch.models import Model
    from repro_torch.models.moe import capacity

    def plen(name, n):
        return Model(t_configs.get_reduced(name)).prefill_len(n)

    assert [plen("tinyllama-1.1b", n) for n in (0, 7, 300)] == [0, 7, 300]
    for name in ("mamba2-780m", "zamba2-1.2b"):
        assert [plen(name, n) for n in (0, 2, 8, 11, 16, 23)] == \
            [0, 2, 8, 8, 16, 16]
    for name in ("qwen2-moe-a2.7b", "internvl2-2b", "whisper-large-v3"):
        assert [plen(name, n) for n in (1, 4, 9, 40)] == [0, 0, 0, 0]
    moe = t_configs.get_reduced("qwen2-moe-a2.7b")
    assert [capacity(moe, n) for n in (1, 5, 6, 12, 13)] == [4, 4, 4, 8, 12]


@pytest.mark.parametrize("threaded", [False, True])
def test_lm_engine_fails_an_unservable_request_alone(tiny_lm, threaded):
    """An empty prompt completes as failed (counted ``rejected``, logged in
    ``events``); the requests beside it are served, from ``run()`` and from
    the dispatch thread alike."""
    prompts = _prompts(3, 4, seed=3)
    reqs = [Request(0, prompt=prompts[0], max_new=2),
            Request(1, prompt=np.zeros(0, np.int32), max_new=2),
            Request(2, prompt=prompts[1], max_new=2),
            Request(3, prompt=prompts[2], max_new=2)]
    engine = _lm_engine(tiny_lm, slots=2, max_len=16)
    if threaded:
        with engine:
            for r in reqs:
                engine.submit(r)
            assert all(r.wait(timeout=60) for r in reqs)
    else:
        for r in reqs:
            engine.submit(r)
        engine.run()
    assert reqs[1].failed and reqs[1].result is None
    assert all(r.done and not r.failed and len(r.result) == 2
               for r in reqs[:1] + reqs[2:])
    assert engine.stats["rejected"] == 1 and engine.stats["served"] == 3
    assert [e["rid"] for e in engine.events
            if e["kind"] == "admission_failed"] == [1]


def test_lm_engine_deadline_expiry_matches_jax(tiny_lm):
    """slots=1: queued requests past ``deadline_ticks`` complete as failed
    at the same ticks as in the JAX engine."""
    jm, jp = tiny_lm[:2]
    prompts = _prompts(3, 3, seed=2)
    jeng = JServingEngine(jm, jp, slots=1, max_len=16)
    jreqs = [JRequest(i, prompt=p, max_new=2, deadline_ticks=2)
             for i, p in enumerate(prompts)]
    for r in jreqs:
        jeng.submit(r)
    jeng.run()
    teng = _lm_engine(tiny_lm, slots=1, max_len=16)
    treqs = [Request(i, prompt=p, max_new=2, deadline_ticks=2)
             for i, p in enumerate(prompts)]
    for r in treqs:
        teng.submit(r)
    teng.run()
    assert [r.failed for r in treqs] == [r.failed for r in jreqs]
    assert [r.completed_tick for r in treqs] == \
        [r.completed_tick for r in jreqs]
    assert teng.stats["expired"] == jeng.stats["expired"] > 0
    with pytest.raises(ValueError, match="analog-path"):
        teng._impl.rebind(None)


def test_serve_main_runs_on_cpu(capsys):
    from repro_torch.launch.serve import main

    assert main(["--arch", "tinyllama-1.1b", "--reduced", "--batch", "2",
                 "--prompt-len", "32", "--gen", "4", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "prefill[2x32]" in out and "generated[2x5]" in out
