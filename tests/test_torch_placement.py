"""The port's yield-aware placement, failure injection and tile recovery
(``compile/placement.py``, ``runtime/failures.py``, ``runtime/elastic.py``)
against the JAX package's.

The permutation algebra, ``tile_sensitivities``, ``plan_placement``,
``apply_placement``/``undo_placement`` and ``plan_tile_recovery`` are held
exactly equal to JAX's on the cases of ``tests/test_placement.py``; the
per-position yield error within 1e-5 of JAX's, given JAX's probe params
and the draws its keys stand for.  The degraded-grid scenario of
``tests/test_tile_recovery.py`` runs on the port alone (its own draws) and
meets the same four bounds.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import compile as J  # noqa: E402
from repro import runtime as J_runtime  # noqa: E402
from repro.paper.prototype import PROTOTYPE as J_PROTOTYPE  # noqa: E402
from repro_torch import compile as T  # noqa: E402
from repro_torch import runtime as T_runtime  # noqa: E402
from repro_torch.interop import (  # noqa: E402
    params_from_numpy,
    tiled_program_from_numpy,
)
from repro_torch.paper.prototype import PROTOTYPE  # noqa: E402

jax.config.update("jax_platform_name", "cpu")


def _programmed(w, tile=4):
    jtp = J.program_tiled(J.synthesize_tiled(w, tile=tile), method="reck")
    return jtp, tiled_program_from_numpy(jtp, "cpu")


# ---------------------------------------------------------------------------
# TilePlacement algebra
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("perms", [((2, 0, 1), (1, 0)), ((0, 1, 2), (0, 1)),
                                   ((1, 0), (3, 1, 0, 2))])
def test_placement_algebra_equals_jax(perms):
    jp, tp = J.TilePlacement(*perms), T.TilePlacement(*perms)
    assert tp.is_identity == jp.is_identity
    assert tp.inv_row_perm == jp.inv_row_perm
    assert tp.inv_col_perm == jp.inv_col_perm
    assert T.TilePlacement.identity(3, 4).is_identity
    with pytest.raises(ValueError):
        T.TilePlacement((0, 0, 1), (0, 1))


def test_apply_undo_placement_equals_jax():
    rng = np.random.default_rng(0)
    jtp, ttp = _programmed(rng.normal(size=(8, 12)).astype(np.float32))
    pl = T.TilePlacement((1, 0), (2, 0, 1))
    placed = T.apply_placement(ttp, pl)
    jplaced = J.apply_placement(jtp, J.TilePlacement((1, 0), (2, 0, 1)))
    assert placed.placement is pl
    for po in range(ttp.to):
        for pi in range(ttp.ti):
            assert placed.grid[po][pi] is ttp.grid[pl.row_perm[po]][
                pl.col_perm[pi]]
            np.testing.assert_array_equal(placed.grid[po][pi].target,
                                          jplaced.grid[po][pi].target)
    back = T.undo_placement(placed)
    assert back.placement is None
    assert all(back.grid[o][i] is ttp.grid[o][i]
               for o in range(ttp.to) for i in range(ttp.ti))
    with pytest.raises(ValueError):
        T.apply_placement(placed, pl)
    with pytest.raises(ValueError):
        T.apply_placement(ttp, T.TilePlacement((0, 1, 2), (0, 1, 2)))
    np.testing.assert_allclose(placed.realized_matrix(),
                               ttp.realized_matrix(), atol=1e-6)
    np.testing.assert_allclose(placed.realized_matrix(),
                               jplaced.realized_matrix(), atol=1e-6)


# ---------------------------------------------------------------------------
# sensitivity, yield scoring and matching
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["eye_block", "random"])
def test_tile_sensitivities_equal_jax(case):
    if case == "eye_block":
        w = np.zeros((8, 8), np.float32)
        w[:4, :4] = np.eye(4)
    else:
        w = np.random.default_rng(1).normal(size=(10, 16)).astype(np.float32)
    jtp, ttp = _programmed(w)
    s = T.tile_sensitivities(ttp)
    np.testing.assert_array_equal(s, J.tile_sensitivities(jtp))
    if case == "eye_block":
        assert s[0, 0] > 0
        assert s[0, 1] == s[1, 0] == s[1, 1] == 0.0


@pytest.mark.parametrize("case", ["mass_to_yield", "uniform", "random"])
def test_plan_placement_equals_jax(case):
    if case == "mass_to_yield":
        sens = np.array([[9.0, 9.0], [1.0, 1.0], [5.0, 5.0]])
        scores = np.array([[-0.5, -0.1], [-0.05, -0.4], [-0.3, -0.2]])
    elif case == "uniform":
        sens, scores = np.ones((2, 3)), np.full((2, 3), -0.1)
    else:
        rng = np.random.default_rng(2)
        sens, scores = rng.uniform(size=(4, 5)), -rng.uniform(size=(4, 5))
    pl = T.plan_placement(sens, scores)
    jpl = J.plan_placement(sens, scores)
    assert (pl.row_perm, pl.col_perm) == (jpl.row_perm, jpl.col_perm)
    if case == "uniform":
        assert pl.is_identity
    with pytest.raises(ValueError):
        T.plan_placement(np.ones((2, 2)), np.ones((2, 3)))


def test_position_yield_error_matches_jax():
    """The yield error of every position of a 2x3 grid of tiles of 4, given
    JAX's probe params and the draws of JAX's per-position keys."""
    from repro.core import mesh as j_mesh

    to, ti, tile = 2, 3, 4
    key = jax.random.PRNGKey(0)
    want = J.position_yield_scores(to, ti, J_PROTOTYPE, key=key, tile=tile)
    plan = j_mesh.clements_plan(tile)
    kp, kq = jax.random.split(jax.random.PRNGKey(0))
    probe = tuple(params_from_numpy(jax.tree.map(
        np.asarray, j_mesh.init_mesh_params(k, plan, with_sigma=False)), "cpu")
        for k in (kp, kq))

    def mesh_draws(k, p):
        k1, k2 = jax.random.split(k)
        return params_from_numpy(
            {"theta": np.asarray(jax.random.normal(k1, p["theta"].shape)),
             "phi": np.asarray(jax.random.normal(k2, p["phi"].shape))}, "cpu")

    draws = []
    for o in range(to):
        row = []
        for i in range(ti):
            kv, ku = jax.random.split(jax.random.fold_in(
                jax.random.fold_in(key, o * ti + i), 0))
            row.append((mesh_draws(kv, probe[0]), mesh_draws(ku, probe[1])))
        draws.append(row)
    got = T.position_yield_scores(to, ti, PROTOTYPE, tile=tile,
                                  probe_params=probe, draws=draws,
                                  device="cpu")
    assert got.shape == (to, ti)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_position_yield_scores_deterministic_and_keyed():
    s1 = T.position_yield_scores(2, 3, PROTOTYPE, key=0, tile=4, device="cpu")
    s2 = T.position_yield_scores(2, 3, PROTOTYPE, key=0, tile=4, device="cpu")
    s3 = T.position_yield_scores(2, 3, PROTOTYPE, key=9, tile=4, device="cpu")
    assert s1.shape == (2, 3)
    np.testing.assert_array_equal(s1, s2)
    assert (s1 <= 0).all()
    assert not np.array_equal(s1, s3)
    with pytest.raises(ValueError):
        T.position_yield_scores(2, 3, PROTOTYPE, tile=4, device="cpu")


# ---------------------------------------------------------------------------
# plan_tile_recovery and the failure injector
# ---------------------------------------------------------------------------

def _recovery_cases():
    sens_row = np.zeros((4, 4))
    sens_row[0] = 10.0
    sens_placed = np.zeros((3, 2))
    sens_placed[1] = 5.0
    return {
        "row_kill": (sens_row, [(0, i) for i in range(4)], {}),
        "nonviable": (np.ones((2, 2)), [(0, 0)],
                      {"max_dropped_mass": 0.05}),
        "placed": (sens_placed, [(0, 0), (0, 1)],
                   {"row_perm": (2, 1, 0), "col_perm": (1, 0)}),
        "column": (np.random.default_rng(3).uniform(size=(3, 4)),
                   [(0, 2), (1, 2)], {"max_dropped_mass": 0.5}),
    }


@pytest.mark.parametrize("case", sorted(_recovery_cases()))
def test_plan_tile_recovery_equals_jax(case):
    sens, dead, kw = _recovery_cases()[case]
    plan = T_runtime.plan_tile_recovery(sens, dead, **kw)
    jplan = J_runtime.plan_tile_recovery(sens, dead, **kw)
    assert plan == T_runtime.TileRecoveryPlan(**vars(jplan))
    if case == "row_kill":
        assert plan.viable and plan.dropped_mass == 0.0
        assert plan.row_perm[0] != 0
    if case == "nonviable":
        assert not plan.viable and "sensitivity mass" in plan.reason
    with pytest.raises(ValueError):
        T_runtime.plan_tile_recovery(np.ones((2, 2)), [(5, 0)])


def test_failure_injector_equals_jax():
    sched = [("host_down", dict(host=2)), ("straggler", dict(host=1,
             factor=3.0)), ("tile_down", dict(tile=(1, 2))), ("crash", {})]
    t_inj = T_runtime.FailureInjector(
        [T_runtime.Failure(step=s % 3, kind=k, **kw)
         for s, (k, kw) in enumerate(sched)]
        + T_runtime.tile_row_failures(step=2, row=0, ti=3))
    j_inj = J_runtime.FailureInjector(
        [J_runtime.Failure(step=s % 3, kind=k, **kw)
         for s, (k, kw) in enumerate(sched)]
        + J_runtime.tile_row_failures(step=2, row=0, ti=3))
    for step in range(4):
        fired = t_inj.at_step(step)
        jfired = j_inj.at_step(step)
        assert [vars(f) for f in fired] == [vars(f) for f in jfired]
        assert t_inj.down_hosts == j_inj.down_hosts
        assert t_inj.slow_hosts == j_inj.slow_hosts
        assert t_inj.dead_tiles == j_inj.dead_tiles
        assert t_inj.alive(4) == j_inj.alive(4)
        assert t_inj.step_time(1, 2.0) == j_inj.step_time(1, 2.0)


# ---------------------------------------------------------------------------
# the degraded-grid scenario of tests/test_tile_recovery.py, on the port
# ---------------------------------------------------------------------------

N, TILE, N_CLASSES = 64, 16, 10


def _classifier_setup(seed=0):
    """A 10-way matched-filter classifier on a 64x64 grid: the class filters
    live in the first output tile row, rows 10..63 are zero."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(N, N)))
    w = np.zeros((N, N), np.float32)
    w[:N_CLASSES] = 3.0 * q[:N_CLASSES]
    labels = rng.integers(0, N_CLASSES, size=80)
    x = (q[labels] + 0.05 * rng.normal(size=(len(labels), N))).astype(
        np.float32)
    return w, torch.from_numpy(x), labels


def _accuracy(compiled, x, labels) -> float:
    pred = np.argmax(compiled.apply(x).numpy()[:, :N_CLASSES], axis=1)
    return float(np.mean(pred == labels))


@pytest.fixture(scope="module")
def bound_classifier():
    w, x, labels = _classifier_setup()
    tp = T.program_tiled(T.synthesize_tiled(w, tile=TILE, device="cpu"),
                         method="reck")
    return T.calibrate_tiled(tp, PROTOTYPE, key=5, steps=0), x, labels


def test_row_kill_recovery_restores_accuracy(bound_classifier):
    tp, x, labels = bound_classifier
    compiled = T.lower_tiled(tp)
    acc_pre = _accuracy(compiled, x, labels)
    assert acc_pre >= 0.9, f"pre-failure accuracy {acc_pre} too low to test"
    inj = T_runtime.FailureInjector(
        schedule=T_runtime.tile_row_failures(step=0, row=0, ti=tp.ti))
    inj.at_step(0)
    dead = sorted(inj.dead_tiles)
    assert len(dead) == tp.ti
    degraded = tp.map_tiles(
        lambda o, i, la: T.blank_tile(la) if (o, i) in inj.dead_tiles else la)
    acc_degraded = _accuracy(T.lower_tiled(degraded), x, labels)
    assert acc_degraded <= 0.5, f"degraded accuracy {acc_degraded}"
    plan = T_runtime.plan_tile_recovery(T.tile_sensitivities(tp), dead)
    assert plan.viable and plan.dropped_mass == 0.0
    assert plan.row_perm[0] != 0
    recovered = T.recover_tiled(tp, plan, PROTOTYPE, key=5, steps=0)
    acc_rec = _accuracy(recovered, x, labels)
    assert acc_rec > acc_degraded
    assert acc_rec >= acc_pre - 0.02
    # the compiled program's own recover() takes the same path
    acc_self = _accuracy(compiled.recover(dead, key=5), x, labels)
    assert acc_self == acc_rec


def test_recovery_moves_only_what_it_must(bound_classifier):
    tp, _, _ = bound_classifier
    dead = [(0, i) for i in range(tp.ti)]
    plan = T_runtime.plan_tile_recovery(T.tile_sensitivities(tp), dead)
    assert plan.col_perm == tuple(range(tp.ti))
    recovered = T.recover_tiled(tp, plan, PROTOTYPE, key=5, steps=0,
                                lower=False)
    from repro_torch.core.hardware import frozen_draws

    for po in range(tp.to):
        for pi in range(tp.ti):
            la = recovered.grid[po][pi]
            src = tp.grid[plan.row_perm[po]][pi]
            if (po, pi) in set(dead):
                assert float(la.scale) == 0.0
            elif (po, pi) in set(plan.recalibrate):
                # re-bound to this position's draw
                dv, _ = frozen_draws(5, (src.v_params, src.u_params),
                                     layer=0, position=po * tp.ti + pi)
                assert torch.equal(la.draws_v["theta"], dv["theta"])
            else:
                assert la is src


def test_recover_without_key_binds_no_draws(bound_classifier):
    """C-ref8, as in the JAX package: ``recover(dead)`` without ``key`` (how
    the serving engine calls it) re-binds the moved tiles to the hardware
    model with no noise draws, so they serve noise-free."""
    tp, _, _ = bound_classifier
    dead = [(0, i) for i in range(tp.ti)]
    out = T.lower_tiled(tp).recover(dead)
    plan = T_runtime.plan_tile_recovery(T.tile_sensitivities(tp), dead)
    assert plan.recalibrate
    for po, pi in plan.recalibrate:
        la = out.source.grid[po][pi]
        assert la.hardware == PROTOTYPE
        assert la.draws_v is None and la.draws_u is None
        assert "draws_v" not in out.tile_args[po][pi]
