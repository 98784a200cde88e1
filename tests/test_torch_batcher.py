"""The port's deprecated serving shims, as ``tests/test_serving_deprecated.py``
holds the JAX package's: they warn, map onto the engine, keep the old
``stats`` keys, and serve the same results as the JAX shims."""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro_torch.serving import Request, ServingEngine  # noqa: E402

jax.config.update("jax_platform_name", "cpu")


def test_retired_batchers_warn_on_access():
    from repro_torch import serving

    for name in ("AnalogRequest", "AnalogTickBatcher", "ContinuousBatcher"):
        assert name not in serving.__all__
        assert name in dir(serving)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        serving.AnalogRequest(rid=0, features=np.ones(8, np.float32))
    assert any(w.category is DeprecationWarning for w in rec)
    with pytest.raises(AttributeError):
        serving.NoSuchBatcher  # noqa: B018


def _compiled_tiled(seed=11):
    from repro_torch import compile as compile_mod

    w = np.random.default_rng(seed).normal(size=(8, 8)) / np.sqrt(8)
    return w, compile_mod.lower_tiled(compile_mod.program_tiled(
        compile_mod.synthesize_tiled(w, tile=4, device="cpu"), method="reck"))


def test_analog_shims_serve_and_warn():
    from repro_torch.serving import AnalogRequest, AnalogTickBatcher

    w, comp = _compiled_tiled()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        batcher = AnalogTickBatcher(comp, slots=2, device="cpu")
        reqs = [AnalogRequest(rid=i, features=np.full(8, 1.0 + i, np.float32),
                              deadline_ticks=None) for i in range(3)]
    assert sum(1 for x in rec if x.category is DeprecationWarning) >= 2
    assert isinstance(batcher, ServingEngine)
    assert all(isinstance(r, Request) for r in reqs)
    for r in reqs:
        batcher.submit(r)
    batcher.run()
    assert all(r.done and not r.failed for r in reqs)
    for r in reqs:
        np.testing.assert_allclose(r.result, np.abs(r.features @ w.T),
                                   atol=1e-4)


def test_analog_shim_stats_keep_old_keys():
    """Old dashboards read served/dropped/recovered; ``dropped`` maps to the
    engine's ``expired`` counter, with the JAX shim's counts."""
    from repro.serving import AnalogRequest as JAnalogRequest
    from repro.serving import AnalogTickBatcher as JAnalogTickBatcher
    from repro_torch.serving import AnalogRequest, AnalogTickBatcher
    from repro import compile as j_compile

    _, comp = _compiled_tiled()
    w = np.random.default_rng(11).normal(size=(8, 8)) / np.sqrt(8)
    jcomp = j_compile.lower_tiled(j_compile.program_tiled(
        j_compile.synthesize_tiled(w, tile=4), method="reck"))
    stats = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        for make, req in ((lambda: AnalogTickBatcher(comp, slots=1,
                                                     device="cpu"),
                           AnalogRequest),
                          (lambda: JAnalogTickBatcher(jcomp, slots=1),
                           JAnalogRequest)):
            batcher = make()
            for i in range(5):
                batcher.submit(req(rid=i, features=np.ones(8, np.float32),
                                   deadline_ticks=2))
            batcher.run()
            stats.append(batcher.stats)
    assert stats[0] == stats[1] == {"served": 2, "dropped": 3, "recovered": 0}


def test_shims_refuse_a_mesh_and_default_to_the_card():
    from repro_torch.serving import AnalogTickBatcher, ContinuousBatcher

    _, comp = _compiled_tiled()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with pytest.raises(ValueError, match="no axis"):
            AnalogTickBatcher(comp, slots=2, mesh=object(), device="cpu")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                AnalogTickBatcher(comp, slots=2)
            with pytest.raises(RuntimeError, match="CUDA"):
                ContinuousBatcher(None, None, slots=2, max_len=8)


def _tiny_lm():
    import dataclasses

    from repro import configs as j_configs
    from repro.models import Model as JModel
    from repro_torch import configs as t_configs
    from repro_torch.interop import params_from_numpy
    from repro_torch.models import Model

    jm = JModel(dataclasses.replace(j_configs.get_reduced("tinyllama-1.1b"),
                                    dtype="float32"))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(dataclasses.replace(t_configs.get_reduced("tinyllama-1.1b"),
                                   dtype="float32"))
    return jm, jp, tm, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def test_lm_shim_serves_and_warns():
    """The LM shim serves as the JAX shim does at ``slots=1`` (where the JAX
    engine's shared position is each request's own): the same tokens."""
    from repro.serving import ContinuousBatcher as JContinuousBatcher
    from repro.serving import Request as JRequest
    from repro_torch.serving import ContinuousBatcher

    jm, jp, tm, tp = _tiny_lm()
    prompts = np.random.default_rng(1).integers(
        0, 512, size=(3, 4)).astype(np.int32)
    with pytest.warns(DeprecationWarning):
        b = ContinuousBatcher(tm, tp, slots=1, max_len=32, device="cpu")
    with pytest.warns(DeprecationWarning):
        jb = JContinuousBatcher(jm, jp, slots=1, max_len=32)
    reqs = [Request(rid=i, prompt=prompts[i], max_new=3) for i in range(3)]
    jreqs = [JRequest(rid=i, prompt=prompts[i], max_new=3) for i in range(3)]
    for r, jr in zip(reqs, jreqs):
        b.submit(r)
        jb.submit(jr)
    b.run()
    jb.run()
    assert all(r.done and len(r.output) == 3 for r in reqs)
    for r, jr in zip(reqs, jreqs):
        np.testing.assert_array_equal(r.result, jr.result)


def test_lm_shim_tick_takes_a_sampler():
    """``tick(sample=...)`` swaps the sampler, as the JAX shim's does."""
    from repro_torch.serving import ContinuousBatcher

    _, _, tm, tp = _tiny_lm()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        b = ContinuousBatcher(tm, tp, slots=2, max_len=16, device="cpu")
    reqs = [Request(rid=i, prompt=np.array([3, 4, 5], np.int32), max_new=2)
            for i in range(2)]
    for r in reqs:
        b.submit(r)
    seen = []

    def always_seven(logits):
        seen.append(tuple(logits.shape))
        return torch.full((logits.shape[0],), 7, dtype=torch.long)

    while b.tick(sample=always_seven) or b._has_work():
        pass
    assert seen and all(s == (2, 512) for s in seen)
    assert all(list(r.result) == [7, 7] for r in reqs)
