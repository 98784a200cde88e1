"""The port's serving engine against the JAX package's.

The deployed 8x8 processor (``AnalogUnitary(n=8, hardware=PROTOTYPE,
quantize="table1", output="abs")`` with params made by the JAX package)
answers the same requests through both engines; each result must match
per request to 1e-5 (float32 sums in another order).  Deadlines, block and
reject admission, the dispatch thread and the failure-injector hook follow
the JAX engine's semantics.
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


def test_unported_engine_modes_raise(deployed):
    _, _, tmodel, tparams = deployed

    class LM:
        def decode_step(self, *a):
            pass

    with pytest.raises(NotImplementedError, match="A10"):
        ServingEngine(LM(), None, slots=2, device="cpu")
    with pytest.raises(NotImplementedError, match="A11"):
        ServingEngine(tmodel, tparams, slots=2, device="cpu", mesh=object())
    bound = as_servable(tmodel, tparams)
    assert isinstance(bound, ServableProgram) and bound.n_in == 8
    with pytest.raises(ValueError):
        bound.recover(((0, 0),))
