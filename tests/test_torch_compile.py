"""The port's matrix programming (``core/decompose``, ``core/svd_synthesis``,
the ``synthesize``/``program`` passes of ``compile``) and its AdamW,
against the JAX package's.

The analytic Reck factorization is the same numpy arithmetic in both
packages, so plans are held equal and params within 1e-6.  Reconstruction
errors are held under the thresholds of ``tests/test_mesh.py`` and
``tests/test_compile.py``.  The gradient fits start from the port's own
generator (other numbers than JAX's ``PRNGKey``), so they are held to the
same error thresholds, not to JAX's params.  AdamW runs 10 steps on the same
params and gradients in both packages: within 1e-6.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import compile as j_compile  # noqa: E402
from repro.core import decompose as j_decompose  # noqa: E402
from repro.optim.adamw import AdamW as JAdamW  # noqa: E402
from repro_torch import compile as t_compile  # noqa: E402
from repro_torch.core import decompose, svd_synthesis  # noqa: E402
from repro_torch.core import mesh as t_mesh  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.optim import AdamW, OptState  # noqa: E402

jax.config.update("jax_platform_name", "cpu")


# ---------------------------------------------------------------------------
# core/decompose
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4, 8, 16])
def test_reck_program_matches_jax_and_reconstructs(n):
    u = decompose.random_unitary(n, seed=n)
    np.testing.assert_array_equal(u, j_decompose.random_unitary(n, seed=n))
    plan, params = decompose.reck_program(u, device="cpu")
    jplan, jparams = j_decompose.reck_program(u)
    assert plan == t_mesh.MeshPlan(jplan.n, jplan.top, jplan.active,
                                   jplan.slot, jplan.role)
    assert plan.n_cells == n * (n - 1) // 2
    assert sorted(params) == sorted(jparams)
    for k in params:
        assert params[k].dtype == torch.float32
        np.testing.assert_allclose(params[k].numpy(), np.asarray(jparams[k]),
                                   rtol=0, atol=1e-6)
    assert decompose.reconstruction_error(plan, params, u) < 5e-6


def test_reck_depth_is_triangular_and_rejects_nonunitary():
    plan, _ = decompose.reck_program(decompose.random_unitary(8, 1),
                                     device="cpu")
    assert plan.n_columns == 2 * 8 - 3
    with pytest.raises(ValueError):
        decompose.reck_program(np.ones((4, 4)), device="cpu")


def test_fit_program_rectangle():
    """The Clements rectangle programmed by AdamW (the paper's method)."""
    u = decompose.random_unitary(4, seed=3)
    plan, params, err = decompose.fit_program(u, steps=2000, lr=0.05, seed=0,
                                              device="cpu")
    assert plan == t_mesh.clements_plan(4)
    assert err < 1e-2
    assert "alpha" in params and "alpha_in" in params


def test_output_screen_only_is_not_universal():
    """As in the JAX package (DESIGN.md): without the input screen the
    single-phase cell and an output-only screen stay far from the target."""
    u = decompose.random_unitary(4, seed=3)
    errs = [decompose.fit_program(u, steps=1200, lr=0.05, seed=s,
                                  with_input_screen=False, device="cpu")[2]
            for s in range(2)]
    assert min(errs) > 5e-2


# ---------------------------------------------------------------------------
# compile: synthesize + program
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 5), (5, 3), (8, 8)])
def test_synthesize_matches_jax_and_reck_program_realizes_matrix(shape):
    m = np.random.default_rng(0).normal(size=shape)
    prog = t_compile.synthesize(m, device="cpu")
    jprog = j_compile.synthesize(m)
    la, jla = prog.layers[0], jprog.layers[0]
    assert (la.n, la.out_dim, la.in_dim) == (jla.n, jla.out_dim, jla.in_dim)
    np.testing.assert_array_equal(la.target_u, jla.target_u)
    np.testing.assert_array_equal(la.target_vh, jla.target_vh)
    np.testing.assert_allclose(la.attenuation.numpy(),
                               np.asarray(jla.attenuation), rtol=0, atol=1e-7)
    assert float(la.scale) == float(jla.scale)
    prog = t_compile.program(prog, method="reck")
    jprog = j_compile.program(jprog, method="reck")
    assert prog.programmed and prog.n_cells() == jprog.n_cells()
    assert t_compile.program_error(prog) < 1e-4
    assert float(prog.layers[0].attenuation.max()) <= 1.0 + 1e-6
    if shape == (3, 5):  # rank 3 of 6: exact zeros in the attenuation
        assert int((prog.layers[0].attenuation == 0).sum()) >= 2


def test_synthesize_stack_shape_checks_and_nested_list():
    prog = t_compile.synthesize([np.ones((3, 5)), np.ones((8, 3))],
                                device="cpu")
    assert prog.n == 8 and prog.depth == 2
    assert prog.in_dim == 5 and prog.out_dim == 8
    with pytest.raises(ValueError, match="does not chain"):
        t_compile.synthesize([np.ones((4, 6)), np.ones((8, 3))], device="cpu")
    prog = t_compile.synthesize([[1.0, 0.0], [0.0, 1.0]], device="cpu")
    assert prog.depth == 1 and prog.layers[0].target.shape == (2, 2)
    with pytest.raises(ValueError, match="method"):
        t_compile.program(prog, method="svd")


def test_program_fit_is_kernel_backed():
    """The gradient programming path sweeps identity probes through
    ``ops.mesh_apply`` (kernels B1/B2 on the card)."""
    m = np.random.default_rng(1).normal(size=(4, 4))
    before = ops.KERNEL_PATH_CALLS["mesh_apply"]
    prog = t_compile.program(t_compile.synthesize(m, device="cpu"),
                             method="fit", steps=1200, lr=0.05, seed=0)
    assert ops.KERNEL_PATH_CALLS["mesh_apply"] - before >= 2 * 1200
    assert prog.layers[0].v_plan == t_mesh.clements_plan(4)
    assert t_compile.program_error(prog) < 2e-2


def test_link_functions_match_jax():
    p = np.asarray([0.0, 1e-9, 0.3, 0.9, 1.0], np.float32)
    s = np.asarray([1e-9, 0.5, 2.0, 7.5], np.float32)
    np.testing.assert_allclose(t_compile.logit(torch.from_numpy(p)).numpy(),
                               np.asarray(j_compile.passes.logit(jnp.asarray(p))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        t_compile.inv_softplus(torch.from_numpy(s)).numpy(),
        np.asarray(j_compile.passes.inv_softplus(jnp.asarray(s))),
        rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# core/svd_synthesis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 2), (3, 5), (5, 3), (8, 8)])
def test_svd_synthesis_arbitrary_matrix(shape):
    m = np.random.default_rng(0).normal(size=shape)
    syn = svd_synthesis.synthesize(m, device="cpu")
    assert svd_synthesis.synthesis_error(m, syn) < 1e-4
    assert float(syn.attenuation.max()) <= 1.0 + 1e-6
    x = np.random.default_rng(1).normal(size=(3, shape[1])).astype(np.float32)
    np.testing.assert_allclose(syn.apply(torch.from_numpy(x)).numpy(),
                               x @ m.T, rtol=0, atol=1e-4)


def test_svd_synthesis_complex_matrix():
    rng = np.random.default_rng(1)
    m = rng.normal(size=(4, 4)) + 1j * rng.normal(size=(4, 4))
    syn = svd_synthesis.synthesize(m, device="cpu")
    assert svd_synthesis.synthesis_error(m, syn) < 1e-4
    assert syn.n_cells == 2 * 6


# ---------------------------------------------------------------------------
# optim/adamw
# ---------------------------------------------------------------------------

def _tree(rng):
    return {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": {"c": rng.normal(size=(5,)).astype(np.float32)}}


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(tree.copy())


@pytest.mark.parametrize("kw", [
    {"clip_norm": 0.0},
    {"clip_norm": 1.0},
    {"clip_norm": 0.5, "weight_decay": 0.1, "lr": 0.05, "b2": 0.999},
])
def test_adamw_matches_jax_for_ten_steps(kw):
    rng = np.random.default_rng(0)
    p = _tree(rng)
    jo, to = JAdamW(**kw), AdamW(**kw)
    jp, tp = jax.tree.map(jnp.asarray, p), _to_torch(p)
    js, ts = jo.init(jp), to.init(tp)
    for _ in range(10):
        g = _tree(rng)
        g["a"] *= 3.0  # a norm above the clip
        jp, js, jn = jo.update(jp, jax.tree.map(jnp.asarray, g), js)
        tp, ts, tn = to.update(tp, _to_torch(g), ts)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6, atol=1e-6)
    assert isinstance(ts, OptState) and int(ts.step) == 10
    for got, want in ((tp["a"], jp["a"]), (tp["b"]["c"], jp["b"]["c"]),
                      (ts.m["a"], js.m["a"]), (ts.v["b"]["c"], js.v["b"]["c"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)


def test_adamw_moment_dtype_grad_compression_and_schedule():
    rng = np.random.default_rng(1)
    p = _tree(rng)
    kw = {"lr": lambda step: 0.01 * step, "clip_norm": 0.0}
    jo = JAdamW(moment_dtype=jnp.bfloat16, grad_compression=True, **kw)
    to = AdamW(moment_dtype=torch.bfloat16, grad_compression=True, **kw)
    jp, tp = jax.tree.map(jnp.asarray, p), _to_torch(p)
    js, ts = jo.init(jp), to.init(tp)
    assert ts.m["a"].dtype == torch.bfloat16
    for _ in range(3):
        g = _tree(rng)
        gj = jo.compress_grads(jax.tree.map(jnp.asarray, g))
        gt = to.compress_grads(_to_torch(g))
        assert gt["a"].dtype == torch.bfloat16
        np.testing.assert_array_equal(gt["a"].float().numpy(),
                                      np.asarray(gj["a"], np.float32))
        jp, js, _ = jo.update(jp, gj, js)
        tp, ts, _ = to.update(tp, gt, ts)
    assert tp["a"].dtype == torch.float32
    np.testing.assert_allclose(tp["a"].numpy(), np.asarray(jp["a"]), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(ts.v["a"].float().numpy(),
                               np.asarray(js.v["a"], np.float32), rtol=1e-2,
                               atol=1e-6)


def test_adamw_update_is_functional():
    p = {"w": torch.ones(3)}
    g = {"w": torch.full((3,), 0.5)}
    opt = AdamW(lr=0.1, clip_norm=0.0)
    state = opt.init(p)
    new_p, new_state, _ = opt.update(p, g, state)
    assert torch.equal(p["w"], torch.ones(3)) and int(state.step) == 0
    assert int(new_state.step) == 1 and not torch.equal(new_p["w"], p["w"])
    with pytest.raises(ValueError, match="structure"):
        opt.update(p, {"w": g["w"], "x": g["w"]}, state)
