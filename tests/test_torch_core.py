"""The port's core modules against the JAX package, and the port's rules.

Inputs are made with numpy from a seed and fed to both packages (their
generators differ, so no seed is shared).  Complex64 physics is held at
1e-5 relative (float32 transcendental functions differ in the last bits
between the two libraries).  Also: the port imports neither ``jax`` nor
``repro``, and its entry points default to CUDA and raise without it.
"""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import cell as j_cell  # noqa: E402
from repro.core import hardware as j_hw  # noqa: E402
from repro.core import mesh as j_mesh  # noqa: E402
from repro.core import quantize as j_q  # noqa: E402
from repro.data import digits as j_digits  # noqa: E402
from repro.data import toys as j_toys  # noqa: E402
from repro.paper import prototype as j_proto  # noqa: E402
from repro.runtime.slo import SLOTracker as JSLOTracker  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import cell as t_cell  # noqa: E402
from repro_torch.core import hardware as t_hw  # noqa: E402
from repro_torch.core import mesh as t_mesh  # noqa: E402
from repro_torch.core import quantize as t_q  # noqa: E402
from repro_torch.core.analog_linear import AnalogUnitary  # noqa: E402
from repro_torch.data import digits as t_digits  # noqa: E402
from repro_torch.data import toys as t_toys  # noqa: E402
from repro_torch.paper import prototype as t_proto  # noqa: E402
from repro_torch.runtime.slo import SLOTracker  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
RTOL = 1e-5


def _close(t, j, rtol=RTOL, atol=1e-6):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol,
                               atol=atol)


def _angles(seed, shape=(5, 3)):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-np.pi, 2 * np.pi, shape).astype(np.float32),
            rng.uniform(-np.pi, 2 * np.pi, shape).astype(np.float32))


_HW = {"ideal": (j_hw.IDEAL, t_hw.IDEAL),
       "default": (j_hw.HardwareModel(), t_hw.HardwareModel()),
       "prototype": (j_proto.PROTOTYPE, t_proto.PROTOTYPE)}


# ---------------------------------------------------------------------------
# cell
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["cell_matrix", "cell_matrix_structural"])
def test_cell_matrix_matches_jax(fn):
    th, ph = _angles(0)
    _close(getattr(t_cell, fn)(torch.from_numpy(th), torch.from_numpy(ph)),
           getattr(j_cell, fn)(jnp.asarray(th), jnp.asarray(ph)))


def test_cell_constants_and_blocks_match_jax():
    assert t_cell.TABLE_I_PHASES_DEG == j_cell.TABLE_I_PHASES_DEG
    np.testing.assert_array_equal(t_cell.TABLE_I_PHASES_RAD,
                                  j_cell.TABLE_I_PHASES_RAD)
    assert (t_cell.Z0_OHM, t_cell.F0_HZ, t_cell.N_DISCRETE_STATES) == (
        j_cell.Z0_OHM, j_cell.F0_HZ, j_cell.N_DISCRETE_STATES)
    _close(t_cell.quadrature_hybrid(), j_cell.quadrature_hybrid())
    ph = np.linspace(-3, 7, 11).astype(np.float32)
    _close(t_cell.phase_shifter(torch.from_numpy(ph)),
           j_cell.phase_shifter(jnp.asarray(ph)))


def test_cell_s_parameters_and_powers_match_jax():
    th, ph = _angles(1)
    rng = np.random.default_rng(1)
    p1 = rng.uniform(0, 1e-3, th.shape).astype(np.float32)
    p4 = rng.uniform(0, 1e-3, th.shape).astype(np.float32)
    ts = t_cell.s_parameters(torch.from_numpy(th), torch.from_numpy(ph))
    js = j_cell.s_parameters(jnp.asarray(th), jnp.asarray(ph))
    assert ts.keys() == js.keys()
    for k in ts:
        _close(ts[k], js[k])
    targs = [torch.from_numpy(a) for a in (th, ph, p1, p4)]
    jargs = [jnp.asarray(a) for a in (th, ph, p1, p4)]
    for fn in ("output_voltages", "output_powers"):
        for t, j in zip(getattr(t_cell, fn)(*targs),
                        getattr(j_cell, fn)(*jargs)):
            _close(t, j, atol=1e-9)
    for t, j in zip(t_cell.output_powers_closed_form(targs[0], *targs[2:]),
                    j_cell.output_powers_closed_form(jargs[0], *jargs[2:])):
        _close(t, j, rtol=1e-4, atol=1e-9)
    assert t_cell.is_unitary(t_cell.cell_matrix(targs[0], targs[1]))


# ---------------------------------------------------------------------------
# hardware
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw", sorted(_HW))
def test_imperfect_cell_matrix_matches_jax(hw):
    jhw, thw = _HW[hw]
    th, ph = _angles(2)
    _close(t_hw.imperfect_hybrid(thw), j_hw.imperfect_hybrid(jhw))
    _close(t_hw.imperfect_cell_matrix(torch.from_numpy(th),
                                      torch.from_numpy(ph), thw),
           j_hw.imperfect_cell_matrix(jnp.asarray(th), jnp.asarray(ph), jhw))
    assert thw.cell_gain == pytest.approx(float(jhw.cell_gain))


@pytest.mark.parametrize("hw", sorted(_HW))
def test_detect_magnitude_matches_jax(hw):
    jhw, thw = _HW[hw]
    rng = np.random.default_rng(3)
    v = (rng.normal(size=(6, 8)) + 1j * rng.normal(size=(6, 8))).astype(
        np.complex64) * np.float32(1e-3)
    v[0, :3] = 0.0  # below the detector floor
    _close(t_hw.detect_magnitude(torch.from_numpy(v), thw),
           j_hw.detect_magnitude(jnp.asarray(v), jhw), atol=1e-9)


def test_noise_draws_follow_the_generator():
    th, ph = _angles(4)
    args = (torch.from_numpy(th), torch.from_numpy(ph), t_proto.PROTOTYPE)
    a = t_hw.imperfect_cell_matrix(*args, torch.Generator().manual_seed(1))
    b = t_hw.imperfect_cell_matrix(*args, torch.Generator().manual_seed(1))
    c = t_hw.imperfect_cell_matrix(*args)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (a - c).abs().max() > 1e-4


# ---------------------------------------------------------------------------
# mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 8, 16])
def test_clements_plan_matches_jax(n):
    jp, tp = j_mesh.clements_plan(n), t_mesh.clements_plan(n)
    for f in ("top", "active", "slot", "role"):
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f))
    assert tp.n_cells == jp.n_cells == n * (n - 1) // 2


def test_mesh_plan_hashes_by_content():
    rng = np.random.default_rng(5)
    cells = [(int(rng.integers(0, 7)), 0.1, 0.2) for _ in range(20)]
    a, _, _ = t_mesh.pack_cells_to_columns(8, cells)
    b, _, _ = t_mesh.pack_cells_to_columns(8, cells)
    assert a is not b and a == b and hash(a) == hash(b)
    assert a != t_mesh.clements_plan(8)


def test_pack_cells_to_columns_matches_jax():
    rng = np.random.default_rng(6)
    cells = [(int(rng.integers(0, 7)), float(rng.uniform(0, 3)),
              float(rng.uniform(0, 6))) for _ in range(25)]
    jp, jth, jph = j_mesh.pack_cells_to_columns(8, cells, pad_to_columns=30)
    tp, tth, tph = t_mesh.pack_cells_to_columns(8, cells, pad_to_columns=30)
    for f in ("top", "active", "slot", "role"):
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f))
    np.testing.assert_array_equal(tth.numpy(), np.asarray(jth))
    np.testing.assert_array_equal(tph.numpy(), np.asarray(jph))
    with pytest.raises(ValueError):
        t_mesh.pack_cells_to_columns(8, cells, pad_to_columns=2)


@pytest.mark.parametrize("n", [2, 8, 16])
@pytest.mark.parametrize("hw", [None, "prototype"])
def test_apply_mesh_matches_jax(n, hw):
    rng = np.random.default_rng(n)
    plan_j, plan_t = j_mesh.clements_plan(n), t_mesh.clements_plan(n)
    shape = plan_j.param_shape()
    p = {"theta": rng.uniform(0, np.pi, shape).astype(np.float32),
         "phi": rng.uniform(0, 2 * np.pi, shape).astype(np.float32),
         "alpha": rng.uniform(0, 2 * np.pi, n).astype(np.float32),
         "alpha_in": rng.uniform(0, 2 * np.pi, n).astype(np.float32)}
    x = (rng.normal(size=(5, n)) + 1j * rng.normal(size=(5, n))).astype(
        np.complex64)
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    pt = interop.params_from_numpy(p)
    if hw is None:
        yj = j_mesh.apply_mesh(plan_j, pj, jnp.asarray(x))
        yt = t_mesh.apply_mesh(plan_t, pt, torch.from_numpy(x))
        _close(t_mesh.mesh_matrix(plan_t, pt), j_mesh.mesh_matrix(plan_j, pj),
               atol=1e-5)
        assert t_mesh.mesh_is_unitary(plan_t, pt)
    else:
        jhw, thw = _HW[hw]
        yj = j_hw.apply_mesh_hw(plan_j, pj, jnp.asarray(x), jhw)
        yt = t_hw.apply_mesh_hw(plan_t, pt, torch.from_numpy(x), thw)
    _close(yt, yj, atol=1e-5 * n)


def test_init_mesh_params_shapes_ranges_and_seed():
    plan = t_mesh.clements_plan(8)
    a = t_mesh.init_mesh_params(torch.Generator().manual_seed(0), plan,
                                device="cpu")
    b = t_mesh.init_mesh_params(torch.Generator().manual_seed(0), plan,
                                device="cpu")
    assert {k: tuple(v.shape) for k, v in a.items()} == {
        "theta": (8, 4), "phi": (8, 4), "alpha": (8,)}
    assert all(v.dtype == torch.float32 for v in a.values())
    assert 0 <= a["theta"].min() and a["theta"].max() <= np.pi
    assert a["phi"].max() <= 2 * np.pi
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert "alpha" not in t_mesh.init_mesh_params(
        torch.Generator(), plan, with_sigma=False)


# ---------------------------------------------------------------------------
# quantize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("book", ["table1", "uniform3"])
def test_nearest_code_matches_jax_with_floor_mod(book):
    if book == "table1":
        jcb, tcb = j_q.table_i_codebook(), t_q.table_i_codebook()
    else:
        jcb, tcb = j_q.uniform_codebook(3), t_q.uniform_codebook(3)
    _close(tcb, jcb, atol=1e-6)
    rng = np.random.default_rng(7)
    # negative phases and phases past 2 pi: the circular wrap must be floor-mod
    ph = rng.uniform(-4 * np.pi, 4 * np.pi, 500).astype(np.float32)
    np.testing.assert_array_equal(
        t_q.nearest_code(torch.from_numpy(ph), torch.as_tensor(np.array(jcb))),
        np.asarray(j_q.nearest_code(jnp.asarray(ph), jcb)))


def test_quantize_mesh_params_and_ste_gradient():
    rng = np.random.default_rng(8)
    p = {"theta": rng.uniform(-1, 7, (8, 4)).astype(np.float32),
         "phi": rng.uniform(-1, 7, (8, 4)).astype(np.float32),
         "alpha": rng.uniform(-1, 7, 8).astype(np.float32),
         "w": rng.normal(size=3).astype(np.float32)}
    jq = j_q.quantize_mesh_params({k: jnp.asarray(v) for k, v in p.items()},
                                  j_q.table_i_codebook())
    pt = interop.params_from_numpy(p)
    tq = t_q.quantize_mesh_params(pt, t_q.table_i_codebook())
    for k in p:
        np.testing.assert_array_equal(tq[k].numpy(), np.asarray(jq[k]))
    # straight-through: d quantized / d phase is the identity
    th = pt["theta"].clone().requires_grad_(True)
    t_q.ste_quantize(th, t_q.table_i_codebook()).sum().backward()
    torch.testing.assert_close(th.grad, torch.ones_like(th))
    codes = t_q.mesh_params_to_codes(pt, t_q.table_i_codebook())
    back = t_q.codes_to_mesh_params(codes, t_q.table_i_codebook())
    np.testing.assert_array_equal(back["phi"].numpy(), np.asarray(jq["phi"]))


def test_prototype_constants_match_jax():
    for name in ("PROTOTYPE", "IDEAL_CELL"):
        assert (dataclass_values(getattr(t_proto, name))
                == dataclass_values(getattr(j_proto, name)))
    assert dataclass_values(t_hw.IDEAL) == dataclass_values(j_hw.IDEAL)


def dataclass_values(hw):
    import dataclasses
    return tuple(float(v) for v in dataclasses.astuple(hw))


# ---------------------------------------------------------------------------
# data, SLO, interop
# ---------------------------------------------------------------------------

def test_digits_and_toys_match_jax_package():
    a = t_digits.load_digits(n_train=12, n_test=5, seed=3)
    b = j_digits.load_digits(n_train=12, n_test=5, seed=3)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)
    for case in ("corner", "diag_up", "diag_down", "ring"):
        for u, v in zip(t_toys.make_toy_dataset(case, 50, 1),
                        j_toys.make_toy_dataset(case, 50, 1)):
            np.testing.assert_array_equal(u, v)
    assert t_toys.GAMMA == j_toys.GAMMA


def test_slo_tracker_matches_jax_package():
    a, b = SLOTracker(), JSLOTracker()
    for tr in (a, b):
        tr.count("submitted", 3)
        tr.count("served", 2)
        for s in (1e-3, 2e-3, 4e-3):
            tr.record_tick(s)
    sa, sb = a.summary(), b.summary()
    assert sa.keys() == sb.keys()
    for k in ("submitted", "served", "ticks", "p50_tick_us", "p99_tick_us"):
        assert sa[k] == sb[k]
    with pytest.raises(KeyError):
        a.count("bogus")


def test_interop_roundtrips_mnist_and_2x2_params():
    from repro.paper.mnist_rfnn import MnistRFNN as JMnist

    jp = JMnist(hardware=None).init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jp)
    tp = interop.params_from_numpy(tree, "cpu")
    assert set(tp) == {"w1", "b1", "w3", "b3", "mesh"}
    assert set(tp["mesh"]) == {"theta", "phi", "alpha"}
    back = interop.params_to_numpy(tp)
    jax.tree.map(np.testing.assert_array_equal, back, tree)
    assert tp["w1"].dtype == torch.float32 and tp["w1"].shape == (784, 8)
    two = {"w": np.asarray([0.9, -1.1], np.float32), "b": np.float32(0.2)}
    back2 = interop.params_to_numpy(interop.params_from_numpy(two, "cpu"))
    np.testing.assert_array_equal(back2["w"], two["w"])
    assert back2["b"].shape == () and back2["b"] == two["b"]
    c = {"z": np.ones(3, np.complex64), "d": np.ones(2, np.float64)}
    tc = interop.params_from_numpy(c)
    assert tc["z"].dtype == torch.complex64 and tc["d"].dtype == torch.float32


# ---------------------------------------------------------------------------
# rules of the port
# ---------------------------------------------------------------------------

def _imported_modules(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_repro():
    files = sorted((SRC / "repro_torch").rglob("*.py"))
    assert len(files) > 20
    bad = [(f.name, m) for f in files for m in _imported_modules(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad


def test_importing_port_loads_no_jax():
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.kernels.ops,"
            " repro_torch.paper, repro_torch.serving, repro_torch.data,"
            " repro_torch.runtime, repro_torch.interop, repro_torch.paper.rfnn2x2,"
            " repro_torch.compile, repro_torch.optim, repro_torch.core.decompose;"
            " bad = [m for m in sys.modules if m.split('.')[0] in"
            " ('jax', 'jaxlib', 'repro')]; print(bad); sys.exit(1 if bad else 0)")
    env = {"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the CUDA default would run")
    from repro_torch.paper.mnist_rfnn import MnistRFNN
    from repro_torch.serving import ServingEngine

    g = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        AnalogUnitary(n=8).init(g)
    with pytest.raises(RuntimeError, match="CUDA"):
        MnistRFNN().init(g)
    params = AnalogUnitary(n=8).init(g, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(AnalogUnitary(n=8), params, slots=4)
    from repro_torch.paper.rfnn2x2 import RFNN2x2
    with pytest.raises(RuntimeError, match="CUDA"):
        RFNN2x2().device_output(0, 0, np.zeros((2, 2), np.float32))
    assert AnalogUnitary(n=8).backend == "kernel"
    assert MnistRFNN().backend == "kernel"
