"""The port's sharded deep grid (``ops.tiled_apply``/``deep_apply`` and
``compile.lower_tiled`` with ``mesh=``) against the JAX package's
single-device path.

Eight CPU ranks (gloo, one spawn for the whole file) each build a
``DeviceMesh`` over ("rows", "data") at 4 x 2 and 2 x 4 and run the grid on
their tile-row slab and batch shard through the plain versions of B7/B8.
The test process computes JAX's reference (Pallas interpret mode) and hands
it over as an ``.npz``; every rank's forward and every gradient leaf are
held to it.  Tolerances: the tile grid within 1e-5 relative of each output
and each gradient leaf, the bound of JAX's ``tests/test_tilegrid_sharded.py``
(a gradient multiplied by ``rows`` or ``data`` fails it); the two-layer grid
within 1e-5 of the largest tile-parameter gradient and of x's largest, the
bound of ``tests/test_torch_deepgrid.py``.  The validation errors run in
this process on a fake process group of three ranks.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402
from torch.testing._internal.distributed.fake_pg import FakeStore  # noqa: E402

import repro.compile as J  # noqa: E402
from repro.core import mesh as j_mesh  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro_torch.interop import tiled_program_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

from _torch_ranks import Ranks  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

REL_TOL = 1e-5
N, TO, TI, B = 4, 4, 2, 10            # JAX's sharded test: ragged B = 10
DEPTH, G = 2, 4                       # the two-layer grid, 4 x 4 tiles
SHAPES = ((4, 2), (2, 4))             # rows x data
WORLD = 8


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tile(rng, o, i):
    plan = j_mesh.clements_plan(N)
    shape = plan.param_shape()

    def mesh():
        return {"alpha": rng.uniform(0, 2 * np.pi, N).astype(np.float32),
                "alpha_in": rng.uniform(0, 2 * np.pi, N).astype(np.float32),
                "phi": rng.uniform(0, 2 * np.pi, shape).astype(np.float32),
                "theta": rng.uniform(0, np.pi, shape).astype(np.float32)}

    return {"atten": rng.uniform(0.2, 0.9, N).astype(np.float32),
            "scale": np.float32(1.0 + 0.05 * (o + i)),
            "u": mesh(), "v": mesh()}


def _grid(rng, to, ti):
    return tuple(tuple(_tile(rng, o, i) for i in range(ti)) for o in range(to))


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


# the ranks' program: rebuild the trees from the leaves (sorted keys, as
# _leaves), run every case, write this rank's outputs
_BODY = r"""
from repro_torch import compile as T
from repro_torch.kernels import ops

inp = np.load(WORK + "/in.npz")
N, TO, TI, DEPTH, G = (int(v) for v in inp["dims"])
MESH_KEYS = ("alpha", "alpha_in", "phi", "theta")


def grid(prefix, to, ti):
    it = iter(torch.from_numpy(inp[f"{prefix}{k}"]).requires_grad_(True)
              for k in range(to * ti * 10))
    def tile():
        t = {"atten": next(it), "scale": next(it)}
        for m in ("u", "v"):
            t[m] = {k: next(it) for k in MESH_KEYS}
        return t
    return tuple(tuple(tile() for _ in range(ti)) for _ in range(to))


def leaves(tree):
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in leaves(v)]
    return [tree]


tiles = grid("tiled_", TO, TI)
deep = tuple(grid(f"deep{l}_", G, G) for l in range(DEPTH))
out = {}
calls = dict(ops.KERNEL_PATH_CALLS)
for rows, data in ((4, 2), (2, 4)):
    mesh = init_device_mesh("cpu", (rows, data), mesh_dim_names=("rows", "data"))
    tag = f"{rows}x{data}"
    x = torch.from_numpy(inp["tiled_x"]).requires_grad_(True)
    y = ops.tiled_apply(tiles, x, n=N, mesh=mesh)
    (y.abs() * torch.from_numpy(inp["tiled_w"])).sum().backward()
    out[f"tiled_{tag}_y"] = y.detach().numpy()
    for j, t in enumerate(leaves(tiles) + [x]):
        out[f"tiled_{tag}_g{j}"] = t.grad.numpy()
        t.grad = None
    xd = torch.from_numpy(inp["deep_x"]).requires_grad_(True)
    y = ops.deep_apply(deep, xd, n=N, mesh=mesh)
    (y * torch.from_numpy(inp["deep_w"])).sum().backward()
    out[f"deep_{tag}_y"] = y.detach().numpy()
    for j, t in enumerate(leaves(deep) + [xd]):
        out[f"deep_{tag}_g{j}"] = t.grad.numpy()
        t.grad = None
prog = torch.load(WORK + "/tiled_program.pt", weights_only=False)
mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("rows", "data"))
comp = T.lower_tiled(prog, mesh=mesh)
out["lowered_y"] = comp.apply(torch.from_numpy(inp["lowered_x"])).numpy()
out["calls"] = np.array([ops.KERNEL_PATH_CALLS[k] - calls[k] for k in
                         ("tiled_apply_sharded", "deep_apply_sharded")])
np.savez(f"{WORK}/out{RANK}.npz", **out)
"""


def _per_layer(layers, x):
    """JAX's unfused oracle of the deep grid (``tests/test_deepgrid_kernel.py``):
    one ``tiled_apply`` a layer, |.| between layers in plain JAX."""
    for tiles in layers:
        x = jnp.abs(j_ops.tiled_apply(tiles, x, n=N))
    return x


def _value_and_grads(fn, tree, x, w, detect=lambda y: y):
    """``fn(tree, x)`` and the gradients of ``sum(w * detect(fn))`` in every
    leaf of ``tree`` (in ``_leaves`` order) and in ``x``."""
    def loss(t, xx):
        y = fn(t, xx)
        return jnp.sum(w * detect(y)), y

    (_, y), (g_t, g_x) = jax.value_and_grad(loss, argnums=(0, 1),
                                            has_aux=True)(
        _jnp(tree), jnp.asarray(x))
    return np.asarray(y), [np.asarray(a) for a in _leaves(g_t)] + [
        np.asarray(g_x)]


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """JAX's single-device references and the eight ranks' outputs."""
    work = tmp_path_factory.mktemp("sharded_grid")
    rng = np.random.default_rng(0)
    tiles = _grid(rng, TO, TI)
    x = rng.normal(size=(B, TI * N)).astype(np.float32)
    w = rng.normal(size=(B, TO * N)).astype(np.float32)
    deep = tuple(_grid(rng, G, G) for _ in range(DEPTH))
    xd = rng.normal(size=(B, G * N)).astype(np.float32)
    wd = rng.normal(size=(B, G * N)).astype(np.float32)
    w_low = rng.normal(size=(16, 8)) / np.sqrt(8)
    x_low = rng.normal(size=(B, 8)).astype(np.float32)
    jtp = J.program_tiled(J.synthesize_tiled(w_low, tile=4), method="reck")

    arrays = {"dims": np.array([N, TO, TI, DEPTH, G]), "tiled_x": x,
              "tiled_w": w, "deep_x": xd, "deep_w": wd, "lowered_x": x_low}
    arrays.update({f"tiled_{k}": a for k, a in enumerate(_leaves(tiles))})
    for l, layer in enumerate(deep):
        arrays.update({f"deep{l}_{k}": a
                       for k, a in enumerate(_leaves(layer))})
    np.savez(work / "in.npz", **arrays)
    torch.save(tiled_program_from_numpy(jtp, "cpu"), work / "tiled_program.pt")
    ranks = Ranks(work, _BODY, WORLD)
    try:  # the references while the ranks run
        ref = {}
        ref["tiled_y"], ref["tiled_g"] = _value_and_grads(
            lambda ts, xx: j_ops.tiled_apply(ts, xx, n=N), tiles, x, w,
            detect=jnp.abs)
        ref["deep_y"], ref["deep_g"] = _value_and_grads(_per_layer, deep, xd,
                                                        wd)
        ref["lowered_y"] = np.asarray(J.lower_tiled(jtp).apply(
            jnp.asarray(x_low)))
    finally:
        ranks.join()
    outs = [dict(np.load(work / f"out{r}.npz")) for r in range(WORLD)]
    return ref, outs


def _rel(got, want):
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                  1e-30)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_tiled_apply_sharded_matches_jax(sharded, shape):
    """Forward and every gradient leaf (each tile's phases, screens,
    attenuation, scale, and x) within 1e-5 relative on every rank."""
    ref, outs = sharded
    tag = f"tiled_{shape[0]}x{shape[1]}"
    for rank, out in enumerate(outs):
        assert out[f"{tag}_y"].shape == ref["tiled_y"].shape
        assert _rel(out[f"{tag}_y"], ref["tiled_y"]) <= REL_TOL, rank
        for j, want in enumerate(ref["tiled_g"]):
            got = out[f"{tag}_g{j}"]
            assert got.shape == np.shape(want)
            assert _rel(got, want) <= REL_TOL, (rank, j)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_deep_apply_sharded_matches_jax(sharded, shape):
    """Two layers of 4 x 4 tiles as a chain of single-layer sharded
    launches: forward within 1e-5 relative, the tile gradients within 1e-5
    of the largest, x's within 1e-5 of its largest, on every rank."""
    ref, outs = sharded
    tag = f"deep_{shape[0]}x{shape[1]}"
    want_tiles, want_x = ref["deep_g"][:-1], ref["deep_g"][-1]
    scale = max(float(np.abs(g).max()) for g in want_tiles)
    for rank, out in enumerate(outs):
        assert _rel(out[f"{tag}_y"], ref["deep_y"]) <= REL_TOL, rank
        err = max(float(np.abs(out[f"{tag}_g{j}"] - g).max())
                  for j, g in enumerate(want_tiles))
        assert err <= REL_TOL * scale, rank
        assert _rel(out[f"{tag}_g{len(want_tiles)}"], want_x) <= REL_TOL


def test_sharded_grads_are_equal_on_every_rank(sharded):
    """The replicated convention: every rank holds the same whole output
    and gradients, bit for bit."""
    _, outs = sharded
    for out in outs[1:]:
        for k, a in outs[0].items():
            np.testing.assert_array_equal(out[k], a, err_msg=k)


def test_lower_tiled_sharded_matches_jax(sharded):
    """A Reck-programmed 16 x 8 matrix on 4 x 2 tiles of 4, lowered with
    ``mesh=`` at 4 x 2: its apply within 1e-5 relative of JAX's lowered
    program on every rank; the sharded entry points were counted."""
    ref, outs = sharded
    for out in outs:
        assert _rel(out["lowered_y"], ref["lowered_y"]) <= REL_TOL
        # two tiled and two deep calls of the grid, one lowered apply
        assert out["calls"].tolist() == [3, 5]


@pytest.fixture
def fake_world():
    """A fake process group of three ranks in this process."""
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=3)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_sharded_grid_validates_before_any_collective(fake_world):
    """To % rows != 0 and a missing axis raise ``ValueError`` up front."""
    rng = np.random.default_rng(1)
    tiles = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a)),
                         _grid(rng, TO, TI))
    x = torch.from_numpy(rng.normal(size=(B, TI * N)).astype(np.float32))
    mesh3 = init_device_mesh("cpu", (3, 1), mesh_dim_names=("rows", "data"))
    with pytest.raises(ValueError, match="do not shard"):
        ops.tiled_apply(tiles, x, n=N, mesh=mesh3)
    meshx = init_device_mesh("cpu", (3,), mesh_dim_names=("r",))
    with pytest.raises(ValueError, match="no axis 'rows'"):
        ops.tiled_apply(tiles, x, n=N, mesh=meshx)
    with pytest.raises(ValueError, match="no axis 'data'"):
        ops.deep_apply((tiles,), x, n=N, mesh=init_device_mesh(
            "cpu", (3,), mesh_dim_names=("rows",)))
