"""The port's compiler passes (``quantize``, ``calibrate``, ``lower*``, the
tiled passes) and compiled programs against the JAX package's.

Both packages run on the same program: the JAX package synthesizes and
programs it, ``repro_torch.interop`` carries its fields into the port, and
the noise a JAX program binds as PRNG keys is passed to the port as the
draws those keys stand for (``jax.random`` on this side).  JAX runs its
kernels in interpret mode, as ``tests/test_compile.py`` does.

Tolerances: codebooks, codes and snapped phases equal; 5 calibration steps
(AdamW on float32 gradients summed in another order) within 1e-4 in params,
attenuation and scale; STE calibration (whose code hops may fall on another
step) held by ``program_error`` within 1e-4 of JAX's and never above the
uncalibrated error; a bound, untrimmed layer's matrix within 1e-5; compiled
applies within 1e-5 of the largest output.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import compile as J  # noqa: E402
from repro.paper.prototype import PROTOTYPE as J_PROTOTYPE  # noqa: E402
from repro_torch import compile as T  # noqa: E402
from repro_torch.interop import (  # noqa: E402
    params_from_numpy,
    program_layer_from_numpy,
    tiled_program_from_numpy,
)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.paper.prototype import PROTOTYPE  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

HW = {"ideal": (None, None), "prototype": (J_PROTOTYPE, PROTOTYPE)}


def mesh_draws(key, params):
    """The standard normals ``imperfect_cell_matrix`` draws from ``key``."""
    k1, k2 = jax.random.split(key)
    return {"theta": np.asarray(jax.random.normal(k1, params["theta"].shape)),
            "phi": np.asarray(jax.random.normal(k2, params["phi"].shape))}


def layer_draws(key, la):
    """The (V, U) draws a JAX layer bound to ``key`` applies."""
    kv, ku = jax.random.split(key)
    return mesh_draws(kv, la.v_params), mesh_draws(ku, la.u_params)


def calibrate_draws(key, prog):
    """JAX ``calibrate``'s draws: layer ``i`` folds ``i`` into ``key``."""
    return [layer_draws(jax.random.fold_in(key, i), la)
            for i, la in enumerate(prog.layers)]


def tiled_draws(key, tp):
    """JAX ``calibrate_tiled``'s draws, by physical position."""
    return [[layer_draws(jax.random.fold_in(
                jax.random.fold_in(key, o * tp.ti + i), 0), la)
             for i, la in enumerate(row)] for o, row in enumerate(tp.grid)]


def port_program(jprog):
    return T.AnalogProgram(tuple(program_layer_from_numpy(la, "cpu")
                                 for la in jprog.layers))


def to_port_draws(draws):
    return [tuple(params_from_numpy(d, "cpu") for d in pair)
            for pair in draws]


def close_rel(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


@pytest.fixture(scope="module")
def two_layer():
    rng = np.random.default_rng(2)
    mats = [rng.normal(size=(8, 8)) * 0.5 for _ in range(2)]
    jprog = J.program(J.synthesize(mats), method="reck")
    return mats, jprog, port_program(jprog)


# ---------------------------------------------------------------------------
# quantize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("book", ["table1", "uniform3", "uniform6",
                                  [0.0, 1.0, 2.5, 4.0]])
def test_resolve_codebook_equals_jax(book):
    got = T.resolve_codebook(book, device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(J.resolve_codebook(book)))
    with pytest.raises(ValueError):
        T.resolve_codebook("table2", device="cpu")


@pytest.mark.parametrize("mode", ["nearest", "ste"])
@pytest.mark.parametrize("book", ["table1", "uniform6"])
def test_quantize_params_and_codes_equal_jax(two_layer, mode, book):
    _, jprog, tprog = two_layer
    jq = J.quantize(jprog, book, mode=mode)
    tq = T.quantize(tprog, book, mode=mode)
    for jl, tl in zip(jq.layers, tq.layers):
        assert tl.quant_mode == mode
        np.testing.assert_array_equal(tl.codebook.numpy(),
                                      np.asarray(jl.codebook))
        for w in ("v", "u"):
            jp, tp = getattr(jl, f"{w}_params"), getattr(tl, f"{w}_params")
            for k in jp:
                np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
            jc, tc = getattr(jl, f"{w}_codes"), getattr(tl, f"{w}_codes")
            assert sorted(jc) == sorted(tc)
            for k in jc:
                np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]))
            jd, td = jl.device_params(w), tl.device_params(w)
            for k in jd:
                np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]))
    with pytest.raises(ValueError):
        T.quantize(tprog, book, mode="round")


# ---------------------------------------------------------------------------
# calibrate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw", ["ideal", "prototype"])
def test_calibrate_continuous_matches_jax(two_layer, hw):
    _, jprog, tprog = two_layer
    jhw, thw = HW[hw]
    key = jax.random.PRNGKey(3)
    draws = to_port_draws(calibrate_draws(key, jprog)) if jhw else None
    jc = J.calibrate(jprog, jhw, key=key, steps=5)
    tc = T.calibrate(tprog, thw, draws=draws, steps=5)
    for jl, tl in zip(jc.layers, tc.layers):
        for w in ("v_params", "u_params"):
            for k, v in getattr(jl, w).items():
                np.testing.assert_allclose(getattr(tl, w)[k].numpy(),
                                           np.asarray(v), rtol=0, atol=1e-4)
        np.testing.assert_allclose(tl.attenuation.numpy(),
                                   np.asarray(jl.attenuation), atol=1e-4)
        np.testing.assert_allclose(float(tl.scale), float(jl.scale),
                                   rtol=0, atol=1e-4)
        assert tl.hardware == thw
        assert (tl.draws_v is None) == (jhw is None)
        # detached: a compiled apply must run B6, not B7
        leaves = [tl.attenuation, tl.scale, *tl.v_params.values(),
                  *tl.u_params.values()]
        assert not any(t.requires_grad for t in leaves)


def test_calibrate_ste_layers_error_matches_jax_and_never_regresses(
        two_layer):
    _, jprog, tprog = two_layer
    key = jax.random.PRNGKey(4)
    jq = J.quantize(jprog, "table1", mode="ste")
    tq = T.quantize(tprog, "table1", mode="ste")
    draws = to_port_draws(calibrate_draws(key, jprog))
    uncal = T.program_error(T.calibrate(tq, PROTOTYPE, draws=draws, steps=0))
    jc = J.calibrate(jq, J_PROTOTYPE, key=key, steps=5)
    tc = T.calibrate(tq, PROTOTYPE, draws=draws, steps=5)
    err = T.program_error(tc)
    assert abs(err - J.program_error(jc)) <= 1e-4
    assert err <= uncal
    for tl in tc.layers:
        assert tl.quant_mode == "ste"
        for k, v in tl.device_params("v").items():
            np.testing.assert_array_equal(
                v.numpy(), tl.codebook[tl.v_codes[k].long()].numpy())


@pytest.mark.parametrize("hw", ["ideal", "prototype"])
def test_calibrate_steps_zero_binds_without_trimming(two_layer, hw):
    _, jprog, tprog = two_layer
    jhw, thw = HW[hw]
    key = jax.random.PRNGKey(5)
    draws = to_port_draws(calibrate_draws(key, jprog)) if jhw else None
    jc = J.calibrate(jprog, jhw, key=key, steps=0)
    tc = T.calibrate(tprog, thw, draws=draws, steps=0)
    for jl, tl, src in zip(jc.layers, tc.layers, tprog.layers):
        assert tl.v_params is src.v_params and tl.u_params is src.u_params
        assert tl.attenuation is src.attenuation and tl.scale is src.scale
        assert tl.hardware == thw
        np.testing.assert_allclose(T.layer_matrix(tl), J.layer_matrix(jl),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(
            T.layer_matrix(tl, with_hardware=False),
            J.layer_matrix(jl, with_hardware=False), rtol=0, atol=1e-5)


def test_calibrate_draws_follow_the_key(two_layer):
    """``key=`` derives each layer's draws from (key, layer): the same key
    binds the same device, another key another one."""
    _, _, tprog = two_layer
    a = T.calibrate(tprog, PROTOTYPE, key=7, steps=0)
    b = T.calibrate(tprog, PROTOTYPE, key=7, steps=0)
    c = T.calibrate(tprog, PROTOTYPE, key=8, steps=0)
    for la, lb, lc in zip(a.layers, b.layers, c.layers):
        for k in ("theta", "phi"):
            assert torch.equal(la.draws_v[k], lb.draws_v[k])
            assert la.draws_v[k].shape == la.v_params[k].shape
            assert la.draws_u[k].shape == la.u_params[k].shape
            assert not torch.equal(la.draws_v[k], lc.draws_v[k])
            assert not torch.equal(la.draws_v[k], la.draws_u[k])
    assert not torch.equal(a.layers[0].draws_v["theta"],
                           a.layers[1].draws_v["theta"])
    with pytest.raises(ValueError):
        T.calibrate(tprog, PROTOTYPE, key=7, draws=[], steps=0)


# ---------------------------------------------------------------------------
# lower + compiled applies
# ---------------------------------------------------------------------------

def test_compiled_program_matches_jax_and_packs_once(two_layer):
    mats, jprog, tprog = two_layer
    key = jax.random.PRNGKey(6)
    draws = to_port_draws(calibrate_draws(key, jprog))
    jc = J.calibrate(J.quantize(jprog, "table1", mode="ste"), J_PROTOTYPE,
                     key=key, steps=0)
    tc = T.calibrate(T.quantize(tprog, "table1", mode="ste"), PROTOTYPE,
                     draws=draws, steps=0)
    packs = ops.PACK_EVENTS["rfnn_network"]
    comp = T.lower(tc)
    assert ops.PACK_EVENTS["rfnn_network"] == packs + 1   # at lower time
    x = np.random.default_rng(3).normal(size=(5, 8)).astype(np.float32)
    want = np.asarray(J.lower(jc).apply(jnp.asarray(x)))
    calls = ops.KERNEL_PATH_CALLS["rfnn_network"]
    for _ in range(3):
        got = comp.apply(torch.from_numpy(x))
    assert ops.KERNEL_PATH_CALLS["rfnn_network"] == calls + 3
    assert ops.PACK_EVENTS["rfnn_network"] == packs + 1   # never at apply
    close_rel(got.numpy(), want, 1e-5)
    assert comp.depth == 2 and comp.n_in == comp.n_out == 8
    assert comp.placement is None
    with pytest.raises(ValueError):
        comp.recover(((0, 0),))
    # the ideal program is the digital stack
    ideal = T.lower(tprog).apply(x)
    np.testing.assert_allclose(ideal.numpy(), np.abs(np.abs(
        x @ mats[0].T) @ mats[1].T), atol=1e-4)
    with pytest.raises(ValueError):
        T.lower(T.synthesize(np.ones((4, 4)), device="cpu"))


def test_compiled_apply_detaches_from_autograd(two_layer):
    """A calibrated program's apply under grad mode builds no graph (the
    deep grid then runs B6 on the card, never B7)."""
    _, _, tprog = two_layer
    comp = T.lower(T.calibrate(tprog, PROTOTYPE, key=1, steps=2))
    y = comp.apply(torch.ones(3, 8))
    assert y.grad_fn is None and not y.requires_grad


@pytest.fixture(scope="module")
def tiled():
    """A ragged 10x12 matrix on a 3x3 grid of 4x4 tiles, Reck-programmed."""
    w = np.random.default_rng(3).normal(size=(10, 12)) / np.sqrt(12)
    return w, J.program_tiled(J.synthesize_tiled(w, tile=4), method="reck")


def test_compiled_tiled_program_placed_matches_jax(tiled):
    w, jtp = tiled
    pl = J.TilePlacement((2, 0, 1), (1, 2, 0))
    key = jax.random.PRNGKey(7)
    jplaced = J.calibrate_tiled(J.apply_placement(jtp, pl), J_PROTOTYPE,
                                key=key, steps=0)
    tplaced = tiled_program_from_numpy(
        J.apply_placement(jtp, pl), "cpu")
    tplaced = T.calibrate_tiled(
        tplaced, PROTOTYPE, steps=0,
        draws=[[tuple(params_from_numpy(d, "cpu") for d in pair)
                for pair in row] for row in tiled_draws(key, jplaced)])
    assert tplaced.placement == T.TilePlacement((2, 0, 1), (1, 2, 0))
    packs = ops.PACK_EVENTS["tiled_apply"]
    comp = T.lower_tiled(tplaced)
    assert ops.PACK_EVENTS["tiled_apply"] == packs + 1
    x = np.random.default_rng(4).normal(size=(5, 12)).astype(np.float32)
    want = np.asarray(J.lower_tiled(jplaced).apply(jnp.asarray(x)))
    for _ in range(2):
        got = comp.apply(torch.from_numpy(x))
    assert ops.PACK_EVENTS["tiled_apply"] == packs + 1
    close_rel(got.numpy(), want, 1e-5)
    np.testing.assert_allclose(tplaced.realized_matrix(),
                               jplaced.realized_matrix(), atol=1e-5)
    # the ideal placed grid is |w x|, the placement undone digitally
    ideal = T.lower_tiled(T.apply_placement(
        tiled_program_from_numpy(jtp, "cpu"), T.TilePlacement(
            (2, 0, 1), (1, 2, 0)))).apply(x)
    np.testing.assert_allclose(ideal.numpy(), np.abs(x @ w.T), atol=1e-4)
    with pytest.raises(ValueError, match="no axis"):
        T.lower_tiled(tplaced, mesh=object())


def test_quantize_calibrate_tiled_never_regresses(tiled):
    w, jtp = tiled
    ttp = tiled_program_from_numpy(jtp, "cpu")
    tq = T.quantize_tiled(ttp, "uniform6")
    bound = T.calibrate_tiled(tq, PROTOTYPE, key=7, steps=0)
    draws = [la.draws_v["theta"] for row in bound.grid for la in row]
    assert len({tuple(d.flatten().tolist()) for d in draws}) == len(draws)
    cal = T.calibrate_tiled(tq, PROTOTYPE, key=7, steps=5)
    assert (np.abs(cal.realized_matrix() - w).max()
            <= np.abs(bound.realized_matrix() - w).max() + 1e-6)
    only = T.calibrate_tiled(bound, PROTOTYPE, key=7, steps=2,
                             only=[(0, 1)])
    for o in range(3):
        for i in range(3):
            assert (only.grid[o][i] is bound.grid[o][i]) == ((o, i) != (0, 1))


def test_compiled_deep_program_placements_match_jax():
    """Three 8x8 layers of 2x2 tiles of 4, placed on the first, an interior
    and the last layer: one launch, within 1e-5 of JAX's cascade."""
    rng = np.random.default_rng(8)
    key = jax.random.PRNGKey(9)
    places = [J.TilePlacement((1, 0), (1, 0)), J.TilePlacement((1, 0), (0, 1)),
              J.TilePlacement((0, 1), (1, 0))]
    jtps, ttps = [], []
    for l, pl in enumerate(places):
        w = rng.normal(size=(8, 8)) / np.sqrt(8)
        jtp = J.apply_placement(J.program_tiled(J.synthesize_tiled(w, tile=4),
                                                method="reck"), pl)
        lkey = jax.random.fold_in(key, l)
        jtp_c = J.calibrate_tiled(jtp, J_PROTOTYPE, key=lkey, steps=0)
        ttp = T.calibrate_tiled(
            tiled_program_from_numpy(jtp, "cpu"), PROTOTYPE, steps=0,
            draws=[[tuple(params_from_numpy(d, "cpu") for d in pair)
                    for pair in row] for row in tiled_draws(lkey, jtp)])
        jtps.append(jtp_c)
        ttps.append(ttp)
    packs = ops.PACK_EVENTS["deep_apply"]
    comp = T.lower_deep(ttps)
    assert ops.PACK_EVENTS["deep_apply"] == packs + 1
    x = rng.normal(size=(6, 8)).astype(np.float32)
    want = np.asarray(J.lower_deep(jtps).apply(jnp.asarray(x)))
    calls = ops.KERNEL_PATH_CALLS["deep_apply"]
    for _ in range(2):
        got = comp.apply(torch.from_numpy(x))
    assert ops.KERNEL_PATH_CALLS["deep_apply"] == calls + 2
    assert ops.PACK_EVENTS["deep_apply"] == packs + 1
    close_rel(got.numpy(), want, 1e-5)
    assert comp.depth == 3 and comp.placement == ttps[-1].placement
    with pytest.raises(ValueError, match="does not chain"):
        T.lower_deep([ttps[0], T.program_tiled(T.synthesize_tiled(
            np.ones((8, 12)), 4, device="cpu"))])


# ---------------------------------------------------------------------------
# the digital->analog transfer
# ---------------------------------------------------------------------------

def test_digital_to_analog_transfer_on_the_deep_grid():
    """4-layer 8x8 stack: train digital, compile every layer, serve through
    ``rfnn_network``: the bounds of ``tests/test_compile.py``."""
    from repro_torch.data.digits import load_digits
    from repro_torch.paper.mnist_rfnn import digital_to_analog_transfer

    x_tr, y_tr, x_te, y_te = load_digits(n_train=200, n_test=100, seed=0)
    settings = ("float", "uniform6")
    calls = ops.KERNEL_PATH_CALLS["rfnn_network"]
    res = digital_to_analog_transfer(
        x_tr, y_tr, x_te, y_te, depth=4, epochs=3, settings=settings,
        device="cpu")
    assert ops.KERNEL_PATH_CALLS["rfnn_network"] - calls == len(settings)
    f = res["settings"]["float"]
    assert f["synthesis_error"] < 1e-4
    assert abs(f["acc_drop"]) <= 0.01
    assert res["compiled"]["float"].depth == 4
    assert res["settings"]["uniform6"]["synthesis_error"] > f["synthesis_error"]
