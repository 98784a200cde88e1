"""The port's deep tile grid (kernels B6/B7/B8 behind ``ops.deep_apply``)
against the JAX package's.

Inputs are made with numpy from a seed and fed to both packages.  JAX runs
``ops.deep_apply`` in Pallas interpret mode on the CPU, as its own tests
do; the port runs the plain versions of its CUDA kernels (a CPU tensor
never reaches a kernel).  Tolerance: forward and VJP within 1e-5 of each
output's (or gradient's) largest magnitude, the bound of
``tests/test_deepgrid_kernel.py``; padding, parked tiles and zero rows
exactly zero.  The ``gpu`` tests hold the CUDA kernels to their plain
versions on the card and skip without one; they need no JAX (where it is
absent, run them with ``pytest --noconftest -m gpu``).
"""

import importlib.util

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import decompose as t_decompose  # noqa: E402
from repro_torch.core import mesh as t_mesh  # noqa: E402
from repro_torch.core.cell import cell_matrix  # noqa: E402
from repro_torch.kernels import givens_mesh, ops, ref, schedule  # noqa: E402

if importlib.util.find_spec("jax") is None:
    jax = None  # the card's machine runs the gpu tests without JAX
else:  # with JAX present, a broken reference package fails the run
    import jax
    import jax.numpy as jnp

    from repro.core import decompose as j_decompose
    from repro.kernels import ops as j_ops

    jax.config.update("jax_platform_name", "cpu")

needs_jax = pytest.mark.skipif(jax is None,
                               reason="needs the JAX reference package")

REL_TOL = 1e-5


def _mesh(rng, plan, screens):
    shape = plan.param_shape()
    p = {"theta": rng.uniform(0, np.pi, shape).astype(np.float32),
         "phi": rng.uniform(0, 2 * np.pi, shape).astype(np.float32)}
    if screens:
        for k in ("alpha", "alpha_in"):
            p[k] = rng.uniform(0, 2 * np.pi, plan.n).astype(np.float32)
    return p


def _layers(rng, n, depth, to, ti, screens=False):
    """``[L][To][Ti]`` tile dicts of numpy arrays (Clements meshes)."""
    plan = t_mesh.clements_plan(n)
    return [[[{"v": _mesh(rng, plan, screens), "u": _mesh(rng, plan, screens),
               "atten": rng.uniform(0.2, 0.9, n).astype(np.float32),
               "scale": np.float32(1.0 + 0.1 * (o + i))}
              for i in range(ti)] for o in range(to)] for _ in range(depth)]


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return tuple(_map(v, fn) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _torch(tree, grad=False):
    return _map(tree, lambda a: torch.tensor(np.asarray(a)).requires_grad_(grad))


def _x(rng, b, width):
    return (rng.normal(size=(b, width))
            + 1j * rng.normal(size=(b, width))).astype(np.complex64)


def _loss_weights(rng, width):
    return rng.normal(size=(2, width)).astype(np.float32)


def _t_loss(y, w):
    w = torch.from_numpy(w)
    if y.is_complex():
        return (y.real * w[0] + y.imag * w[1]).sum()
    return (y * w[0]).sum()


def _j_loss(y, w):
    if jnp.iscomplexobj(y):
        return jnp.sum(jnp.real(y) * w[0] + jnp.imag(y) * w[1])
    return jnp.sum(y * w[0])


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                  1e-30)


def _torch_grads(layers_np, x_np, w, **kw):
    lt = _torch(layers_np, grad=True)
    xt = torch.from_numpy(x_np).requires_grad_(True)
    y = ops.deep_apply(lt, xt, **kw)
    y_val = y.detach().numpy()
    _t_loss(y, w).backward()
    return y_val, [leaf.grad.numpy() for leaf in _leaves(lt)], xt.grad.numpy()


def _jax_grads(layers_np, x_np, w, **kw):
    lj = _map(layers_np, jnp.asarray)
    y = np.asarray(j_ops.deep_apply(lj, jnp.asarray(x_np), **kw))
    g_l, g_x = jax.grad(lambda ls, xx: _j_loss(j_ops.deep_apply(ls, xx, **kw),
                                               w), argnums=(0, 1))(
        lj, jnp.asarray(x_np))
    # jax.grad of a real loss in a complex x is dL/dRe - i dL/dIm; PyTorch's
    # is its conjugate
    return y, [np.asarray(a) for a in _leaves(g_l)], np.conj(np.asarray(g_x))


def _assert_matches_jax(got, want):
    y_t, gl_t, gx_t = got
    y_j, gl_j, gx_j = want
    assert y_t.shape == y_j.shape and y_t.dtype == y_j.dtype
    assert _rel(y_t, y_j) <= REL_TOL
    assert len(gl_t) == len(gl_j)
    scale = max(float(np.abs(g).max()) for g in gl_j)
    err = max(float(np.abs(a - b).max()) for a, b in zip(gl_t, gl_j))
    assert err <= REL_TOL * scale
    assert _rel(gx_t, gx_j) <= REL_TOL


# ---------------------------------------------------------------------------
# deep_apply against JAX: forward and VJP
# ---------------------------------------------------------------------------

@needs_jax
@pytest.mark.parametrize("shape", [(1, 1, 1, 4), (2, 2, 2, 4), (1, 2, 3, 2),
                                   (3, 1, 1, 8)])
@pytest.mark.parametrize("readout", ["magnitude", "complex"])
def test_deep_apply_matches_jax_fwd_and_vjp(shape, readout):
    """Forward and the gradients in every tile's params (phases, screens,
    attenuation, scale) and in x: within 1e-5 of the largest magnitude."""
    depth, to, ti, n = shape
    rng = np.random.default_rng(sum(shape) + 100 * (readout == "complex"))
    layers = _layers(rng, n, depth, to, ti, screens=True)
    x = _x(rng, 5, ti * n)
    w = _loss_weights(rng, to * n)
    calls = ops.KERNEL_PATH_CALLS["deep_apply"]
    got = _torch_grads(layers, x, w, n=n, readout=readout)
    assert ops.KERNEL_PATH_CALLS["deep_apply"] == calls + 1
    _assert_matches_jax(got, _jax_grads(layers, x, w, n=n, readout=readout))


@needs_jax
def test_deep_apply_mixed_reck_plans_identity_padding():
    """Reck tiles beside Clements ones: the shorter meshes pad with identity
    columns (parity 0), exact no-ops; forward and VJP as JAX's."""
    n, depth, g = 4, 2, 2
    u = j_decompose.random_unitary(n, seed=3)
    jplan, rparams = j_decompose.reck_program(u)
    tplan, _ = t_decompose.reck_program(u, device="cpu")
    rparams = {k: np.asarray(v) for k, v in rparams.items()}
    rng = np.random.default_rng(5)
    layers = _layers(rng, n, depth, g, g)
    layers[0][0][1]["v"] = dict(rparams)
    layers[1][0][0]["u"] = dict(rparams)

    def plans(rp):
        return (((None, (rp, None)), (None, None)),
                (((None, rp), None), (None, None)))

    deep = schedule.deep_grid_schedule(n, depth, g, g, plans(tplan))
    clements = schedule.clements_schedule(n).n_columns
    assert deep.n_columns > clements                    # padding used
    pv, pu = schedule.deep_grid_parity_arrays(deep)
    assert pv[1, 0, 0, clements:].eq(0).all()           # padded: parity 0
    x = _x(rng, 6, g * n)
    w = _loss_weights(rng, g * n)
    got = _torch_grads(layers, x, w, n=n, plans=plans(tplan))
    _assert_matches_jax(got, _jax_grads(layers, x, w, n=n,
                                        plans=plans(jplan)))
    # the padding columns' packed coefficients are identity cells
    _, (coef_v, _, _) = ops.pack_deep_grid(_torch(layers), n=n,
                                           plans=plans(tplan))
    ident = torch.tensor([1, 0, 0, 0, 0, 0, 1, 0], dtype=torch.float32)
    assert (coef_v[1, 0, 0, clements:] == ident[:, None]).all()


@needs_jax
@pytest.mark.parametrize("batch", [1, 7, 130])
def test_deep_apply_ragged_batches_zero_rows_stay_zero(batch):
    """Any batch; zero input rows give exactly zero outputs and exactly zero
    input gradients (the |.| backward is 0 at the origin, never NaN); the
    other rows and every parameter gradient as JAX's."""
    n, depth, g = 4, 2, 2
    rng = np.random.default_rng(batch)
    layers = _layers(rng, n, depth, g, g)
    x = _x(rng, batch, g * n)
    x[::3] = 0
    w = _loss_weights(rng, g * n)
    y_t, gl_t, gx_t = got = _torch_grads(layers, x, w, n=n)
    assert y_t.shape == (batch, g * n)
    assert (y_t[::3] == 0).all() and (gx_t[::3] == 0).all()
    assert all(np.isfinite(a).all() for a in gl_t)
    _assert_matches_jax(got, _jax_grads(layers, x, w, n=n))


def test_parked_tile_gives_exact_zero_grads():
    """A parked tile (scale 0) inside a deep grid: its mesh and attenuation
    gradients are exactly 0 and every gradient is finite, with zero input
    rows beside it."""
    n, depth, g = 4, 2, 2
    rng = np.random.default_rng(7)
    layers = _layers(rng, n, depth, g, g)
    layers[1][0][1]["scale"] = np.float32(0.0)
    x = _x(rng, 3, g * n)
    x[1] = 0
    lt = _torch(layers, grad=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = ops.deep_apply(lt, xt, n=n)
    _t_loss(y, _loss_weights(rng, g * n)).backward()
    assert torch.isfinite(y).all() and torch.isfinite(xt.grad).all()
    assert all(torch.isfinite(leaf.grad).all() for leaf in _leaves(lt))
    parked = lt[1][0][1]
    for leaf in _leaves({k: parked[k] for k in ("v", "u", "atten")}):
        assert torch.equal(leaf.grad, torch.zeros_like(leaf))
    assert parked["scale"].grad != 0


# ---------------------------------------------------------------------------
# the degenerate wrappers and the plain backward
# ---------------------------------------------------------------------------

def test_rfnn_network_and_tiled_apply_are_deep_apply():
    """``rfnn_network`` (L x 1 x 1, magnitudes) and ``tiled_apply``
    (1 x To x Ti, complex) give deep_apply's bits."""
    rng = np.random.default_rng(2)
    net = _torch([row[0][0] for row in _layers(rng, 6, 3, 1, 1)])
    x = torch.from_numpy(_x(rng, 5, 6))
    before = dict(ops.KERNEL_PATH_CALLS)
    y_net = ops.rfnn_network(net, x, n=6)
    y_deep = ops.deep_apply(tuple(((la,),) for la in net), x, n=6)
    assert torch.equal(y_net, y_deep) and y_net.dtype == torch.float32
    tiles = _torch(_layers(rng, 4, 1, 2, 3)[0])
    x = torch.from_numpy(_x(rng, 5, 12))
    y_t = ops.tiled_apply(tiles, x, n=4)
    y_d = ops.deep_apply((tiles,), x, n=4, readout="complex")
    assert torch.equal(y_t, y_d) and y_t.shape == (5, 8)
    assert y_t.dtype == torch.complex64
    assert {k: ops.KERNEL_PATH_CALLS[k] - before[k]
            for k in ("rfnn_network", "tiled_apply", "deep_apply")} == {
        "rfnn_network": 1, "tiled_apply": 1, "deep_apply": 4}
    with pytest.raises(ValueError, match="no axis"):
        ops.tiled_apply(tiles, x, n=4, mesh=object())
    with pytest.raises(ValueError, match="readout"):
        ops.deep_apply((tiles,), x, n=4, readout="real")


def _grid_inputs(rng, depth, to, ti, n, mixed, b=6, n_cols=None):
    """Random unitary cells in ``n_cols`` columns (default n + 3), per-tile
    random (mixed) or Clements parities, random gains and complex x, as the
    kernels take them."""
    p, c = n // 2, n_cols or n + 3

    def coef():
        th = torch.from_numpy(rng.uniform(0, np.pi, (depth, to, ti, c, p))
                              .astype(np.float32))
        ph = torch.from_numpy(rng.uniform(0, 2 * np.pi, (depth, to, ti, c, p))
                              .astype(np.float32))
        t = torch.view_as_real(cell_matrix(th, ph).reshape(
            depth, to, ti, c, p, 4))
        return t.reshape(depth, to, ti, c, p, 8).movedim(-1, -2).contiguous()

    alt = np.broadcast_to(np.arange(c) % 2, (depth, to, ti, c))
    par_v = rng.integers(0, 2, (depth, to, ti, c)) if mixed else alt
    gains = rng.normal(size=(depth, to, ti, 12, p)).astype(np.float32)
    return (coef(), torch.from_numpy(np.array(par_v, np.int32)), coef(),
            torch.from_numpy(np.array(alt, np.int32)),
            torch.from_numpy(gains), torch.from_numpy(_x(rng, b, ti * n)))


@pytest.mark.parametrize("shape", [(1, 1, 1, 4), (2, 2, 2, 4), (1, 2, 3, 2),
                                   (3, 1, 1, 8), (2, 3, 3, 4)])
@pytest.mark.parametrize("detect_last", [True, False])
def test_plain_backward_equals_autograd_of_plain_forward(shape, detect_last):
    """The explicit plain B8 against autograd through the plain B6/B7, with
    per-tile mixed parities (no |z| is 0 here): within 1e-5 relative."""
    rng = np.random.default_rng(sum(shape) + 10 * detect_last)
    inputs = _grid_inputs(rng, *shape, mixed=True)
    out, sv, su = givens_mesh.deepgrid_forward_plain(
        *inputs, detect_last=detect_last)
    g = (torch.from_numpy(rng.normal(size=out.shape).astype(np.float32))
         if detect_last else torch.from_numpy(_x(rng, *out.shape)))
    grads = givens_mesh.deepgrid_backward_plain(*inputs, sv, su, g,
                                                detect_last=detect_last)
    leaves = [inputs[k].clone().requires_grad_(True) for k in (0, 2, 4, 5)]
    o, _, _ = ref.deep_grid_planes(leaves[0], inputs[1], leaves[1], inputs[3],
                                   leaves[2], leaves[3],
                                   detect_last=detect_last)
    auto = torch.autograd.grad(o, leaves, grad_outputs=g)
    for got, want in zip(grads, auto):
        assert got.shape == want.shape
        assert _rel(got.detach(), want) <= REL_TOL


@pytest.mark.parametrize("shape", [(1, 1, 1, 4), (2, 2, 2, 4), (3, 1, 1, 8)])
def test_plain_forward_in_float64_is_a_witness(shape):
    """The plain B6/B7 on a complex128 grid (float64 coefficients and gains)
    stays in float64 and agrees with the float32 grid's forward, and
    autograd through it with the plain B8: within 1e-5 relative."""
    rng = np.random.default_rng(sum(shape) + 20)
    inputs = _grid_inputs(rng, *shape, mixed=True)
    out, sv, su = givens_mesh.deepgrid_forward_plain(*inputs, detect_last=True)
    g = torch.from_numpy(rng.normal(size=out.shape).astype(np.float32))
    grads = givens_mesh.deepgrid_backward_plain(*inputs, sv, su, g,
                                                detect_last=True)
    wide = [inputs[k].to(torch.complex128 if k == 5 else torch.float64)
            .requires_grad_(True) for k in (0, 2, 4, 5)]
    o64, sv64, su64 = ref.deep_grid_planes(wide[0], inputs[1], wide[1],
                                           inputs[3], wide[2], wide[3],
                                           detect_last=True)
    assert o64.dtype == torch.float64 and sv64.dtype == torch.complex128
    for got, want in ((out, o64), (sv, sv64), (su, su64)):
        assert _rel(got, want.detach()) <= REL_TOL
    auto = torch.autograd.grad(o64, wide, grad_outputs=g.double())
    for got, want in zip(grads, auto):
        assert want.dtype in (torch.float64, torch.complex128)
        assert _rel(got, want) <= REL_TOL


def test_deep_grid_stages_and_validation():
    """The saved boundaries' layout and the checks on the kernels' inputs."""
    rng = np.random.default_rng(4)
    inputs = _grid_inputs(rng, 2, 2, 2, 4, mixed=False, b=3)
    out, sv, su = givens_mesh.deepgrid_forward_plain(*inputs)
    assert out.shape == (3, 8) and sv.shape == su.shape == (2, 3, 2, 2, 4)
    assert sv.dtype == torch.complex64
    with pytest.raises(ValueError, match="x must be"):
        givens_mesh.deepgrid_forward_plain(*inputs[:5], inputs[5][:, :4])
    with pytest.raises(ValueError, match="To must equal Ti"):
        schedule.deep_grid_schedule(4, 2, 2, 3)
    # the network and tile-grid schedules are views of the deep grid's
    deep = schedule.deep_grid_schedule(4, 3, 1, 1)
    assert schedule.network_schedule(4, 3).deep == deep
    assert deep.layer(1) == schedule.deep_grid_schedule(4, 1, 1, 1)
    grid = schedule.tile_grid_schedule(4, 2, 3)
    assert grid.deep == schedule.deep_grid_schedule(4, 1, 2, 3)
    assert (grid.to, grid.ti, grid.n_columns) == (2, 3, 4)
    padded = schedule.pad_columns(inputs[0], 9)
    assert padded.shape[3] == 9 and torch.equal(padded[:, :, :, :7],
                                                inputs[0])
    with pytest.raises(ValueError, match="gains"):
        givens_mesh.deepgrid_forward_plain(*inputs[:4], inputs[4][..., :1],
                                           inputs[5])
    with pytest.raises(ValueError, match="the deepgrid kernel runs on CUDA"):
        givens_mesh.launch_deepgrid(*inputs)


# ---------------------------------------------------------------------------
# the pack cache
# ---------------------------------------------------------------------------

def test_pack_cache_events():
    """One pack for repeated calls; a new pack after an in-place edit of a
    leaf and for new tensors; no caching when a gradient flows through the
    packing or when a tile carries a generator."""
    rng = np.random.default_rng(9)
    layers = _torch(_layers(rng, 4, 2, 2, 2))
    x = torch.from_numpy(_x(rng, 4, 8))
    packs = ops.PACK_EVENTS["deep_apply"]
    y0 = ops.deep_apply(layers, x, n=4)
    for _ in range(4):
        assert torch.equal(ops.deep_apply(layers, x, n=4), y0)
    assert ops.PACK_EVENTS["deep_apply"] == packs + 1
    with torch.no_grad():
        layers[0][0][0]["atten"].mul_(0.5)              # in-place edit
    y1 = ops.deep_apply(layers, x, n=4)
    assert ops.PACK_EVENTS["deep_apply"] == packs + 2
    assert not torch.equal(y1, y0)
    ops.deep_apply(_torch(_layers(rng, 4, 2, 2, 2)), x, n=4)   # new tensors
    assert ops.PACK_EVENTS["deep_apply"] == packs + 3
    grad_layers = _torch(_layers(rng, 4, 2, 2, 2), grad=True)
    for _ in range(2):
        ops.deep_apply(grad_layers, x, n=4).sum().backward()
    assert ops.PACK_EVENTS["deep_apply"] == packs + 5
    with torch.no_grad():                 # no gradient wanted: cached again
        ops.deep_apply(grad_layers, x, n=4)
        ops.deep_apply(grad_layers, x, n=4)
    assert ops.PACK_EVENTS["deep_apply"] == packs + 6
    net = [dict(la[0][0]) for la in layers]
    for la in net:
        la["generator"] = torch.Generator().manual_seed(0)
    for _ in range(2):
        ops.rfnn_network(net, x[:, :4], n=4)
    assert ops.PACK_EVENTS["rfnn_network"] >= 2
    events = ops.PACK_EVENTS["rfnn_network"]
    ops.rfnn_network(net, x[:, :4], n=4)
    assert ops.PACK_EVENTS["rfnn_network"] == events + 1


def test_memoize_by_leaf_ids_keeps_derived_tensors():
    calls = []
    tree = {"a": torch.ones(3), "b": (torch.zeros(2), 1.5)}

    def build():
        calls.append(1)
        return tree["a"] * 2

    first = ops.memoize_by_leaf_ids("test_memo", tree, build)
    assert ops.memoize_by_leaf_ids("test_memo", tree, build) is first
    tree["b"][0].add_(1.0)
    assert ops.memoize_by_leaf_ids("test_memo", tree, build) is not first
    assert len(calls) == 2


# ---------------------------------------------------------------------------
# launch plans of B8 (computed on the host)
# ---------------------------------------------------------------------------

def _two_per_sm(reg, n, tiles, detect_last, threads, smem):
    return 2


@pytest.mark.parametrize("b,shape,path,rows,threads,blocks,kernels", [
    (10, (4, 1, 1, 8, 8), 1, 16, 64, 1, 1),    # depth-4 MNIST's SGD step
    (1, (4, 1, 1, 8, 8), 1, 8, 32, 1, 1),
    (64, (4, 1, 1, 8, 8), 1, 64, 256, 1, 1),   # the most one block holds
    (65, (4, 1, 1, 8, 8), 1, 8, 32, 9, 2),     # spread, then summed
    (10, (4, 1, 1, 2, 1), 1, 32, 32, 1, 1),    # n = 2: one lane a row
    (10, (2, 1, 1, 32, 35), 1, 10, 160, 1, 1),
    (1024, (1, 4, 4, 16, 16), 1, 8, 128, 128, 2),  # TiledAnalogLinear(64)
    (1024, (4, 4, 4, 16, 29), 1, 8, 128, 128, 2),  # the 64x64 cascade
    (7, (1, 2, 3, 4, 7), 1, 8, 64, 1, 1),      # a grid's one block
    (1024, (2, 2, 2, 32, 35), 1, 8, 32, 128, 2),
    (1024, (2, 2, 2, 6, 9), 0, 42, 512, 25, 2),   # no register path at 6
    (8, (1, 1, 1, 64, 64), 0, 16, 512, 1, 2),     # nor at 64
    (100, (1, 8, 8, 8, 8), 0, 2, 512, 50, 2),     # nor above 32 tiles
])
def test_deepgrid_bwd_layouts_choose_path_rows_and_blocks(
        b, shape, path, rows, threads, blocks, kernels):
    depth, to, ti, n, c = shape
    plan = givens_mesh.deepgrid_bwd_layout(b, n, depth, to, ti, c, True, 132,
                                           _two_per_sm)
    assert plan["register_path"] == path
    assert (plan["rows"], plan["threads"], plan["blocks"],
            plan["kernels"]) == (rows, threads, blocks, kernels)
    assert plan["shared_bytes"] <= 232448
    if path:
        assert 1 <= plan["chunk_columns"] <= c
        assert 2 <= plan["stages"] <= 8
    else:
        assert plan["chunk_columns"] == plan["stages"] == 0


@pytest.mark.parametrize("b", [1024, 4096, 65536])
def test_deepgrid_bwd_cascade_slices_within_budget(b):
    """The cascade's per-block gradient slices stay within the budget: one
    block a row tile up to it, then blocks walk row tiles."""
    plan = givens_mesh.deepgrid_bwd_layout(b, 16, 4, 4, 4, 29, True, 132,
                                           _two_per_sm)
    assert plan["slice_bytes"] == 4 * 4 * 16 * (2 * 29 * 64 + 96)
    assert plan["blocks"] * plan["slice_bytes"] <= \
        givens_mesh.DEEP_SLICE_BUDGET
    assert plan["blocks"] == min(-(-b // 8),
                                 givens_mesh.DEEP_SLICE_BUDGET
                                 // plan["slice_bytes"])


def test_deepgrid_bwd_layout_refuses_no_rows():
    with pytest.raises(ValueError):
        givens_mesh.deepgrid_bwd_layout(0, 8, 4, 1, 1, 8, True, 132,
                                        _two_per_sm)


def test_deepgrid_bwd_plans_are_cached_per_card_and_shape(monkeypatch):
    calls = []

    def occupancy(*args):
        calls.append(args)
        return 1

    monkeypatch.setattr(givens_mesh, "_PLANS", {})
    monkeypatch.setattr(givens_mesh, "_SMS", {0: 132, 1: 66})
    monkeypatch.setattr(givens_mesh, "_deep_occupancy", occupancy)
    shape = (16, 4, 4, 4, 29, True)
    first = givens_mesh._cached_plan("deep_bwd", 0, 1024, *shape)
    assert givens_mesh._cached_plan("deep_bwd", 0, 1024, *shape) is first
    assert len(calls) == 1
    assert first["blocks"] == 128
    assert givens_mesh._cached_plan("deep_bwd", 1, 1024, *shape)["blocks"] \
        == 66                                 # one wave of the smaller card
    assert givens_mesh._cached_plan("deep_bwd", 0, 1024, 16, 4, 4, 4, 29,
                                    False) is not first
    assert givens_mesh._cached_plan("deep_bwd", 0, 10, 8, 4, 1, 1, 8,
                                    True)["kernels"] == 1
    assert len(calls) == 3                    # one block needs no wave
    assert len(givens_mesh._PLANS) == 4


# ---------------------------------------------------------------------------
# the CUDA kernels on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the deep-grid kernels have no CPU "
                    "mode")
    return torch.device("cuda")


_EYE_CELL = (1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0)


def _check_kernels_on_card(inputs, detect_last):
    """One B6, one B7 and two B8 launches on ``inputs`` against the plain
    versions: 1e-5 * n of the largest magnitude, B6 == B7 bitwise and the
    gradients bit-identical across the two calls.  Returns the gradients."""
    cuda_device = inputs[0].device
    b, to, n = inputs[5].shape[0], inputs[0].shape[1], 2 * inputs[0].shape[-1]
    g = (torch.rand(b, to * n, device=cuda_device) if detect_last
         else torch.randn(b, to * n, dtype=torch.complex64, device=cuda_device))
    before = dict(givens_mesh.LAUNCHES)
    out6 = givens_mesh.launch_deepgrid(*inputs, detect_last=detect_last)
    out7, sv, su = givens_mesh.launch_deepgrid(
        *inputs, detect_last=detect_last, save_stages=True)
    grads = givens_mesh.launch_deepgrid_backward(
        *inputs, sv, su, g, detect_last=detect_last)
    grads2 = givens_mesh.launch_deepgrid_backward(
        *inputs, sv, su, g, detect_last=detect_last)
    torch.cuda.synchronize()
    assert {k: givens_mesh.LAUNCHES[k] - before[k] for k in (
        "deepgrid_fwd", "deepgrid_fwd_res", "deepgrid_bwd")} == {
        "deepgrid_fwd": 1, "deepgrid_fwd_res": 1, "deepgrid_bwd": 2}
    assert torch.equal(out6, out7)
    for a, c in zip(grads[:3], grads2[:3]):
        assert torch.equal(a, c)
    pout, psv, psu = givens_mesh.deepgrid_forward_plain(
        *inputs, detect_last=detect_last)
    # 1e-5 * n of the largest magnitude, as the fused kernels' card
    # tests: float32 sums in another order over n-wide columns
    for got, want in ((out6, pout), (sv, psv), (su, psu)):
        assert _rel(got.cpu(), want.cpu()) <= REL_TOL * n
    want = givens_mesh.deepgrid_backward_plain(
        *inputs, sv, su, g, detect_last=detect_last)
    for got, w in zip(grads, want):
        assert _rel(got.cpu(), w.cpu()) <= REL_TOL * n
    return grads


@pytest.mark.gpu
@pytest.mark.parametrize("eye_tile", [False, True])
@pytest.mark.parametrize("shape", [(1, 1, 1, 8), (4, 1, 1, 8), (1, 4, 4, 16),
                                   (4, 4, 4, 16), (1, 2, 3, 4), (1, 1, 1, 2),
                                   (2, 2, 2, 32), (2, 2, 2, 6)])
def test_deepgrid_kernels_match_plain_on_card(cuda_device, shape, eye_tile):
    """B6, B7 and B8 against their plain versions on the same card inputs,
    both readouts, mixed per-tile parities, ragged batches and zero rows
    (exactly zero dx wherever a |.| lies behind them); the gradients
    bit-identical across two calls.  n = 2 and 32 are the register path's
    edges, n = 6 takes the general path; ``eye_tile`` makes one tile's V
    identity cells only (every column skipped)."""
    rng = np.random.default_rng(sum(shape))
    to, ti, n = shape[1], shape[2], shape[3]
    plan = givens_mesh.deepgrid_fwd_plan(130, n, shape[0], to, ti, n + 3)
    assert plan["register_path"] == int(n in (2, 4, 8, 16, 32))
    for detect_last in (True, False):
        for b in (1, 7, 130):
            inputs = [t.to(cuda_device) for t in _grid_inputs(
                rng, *shape, mixed=True, b=b)]
            inputs[5][::5] = 0
            if eye_tile:
                inputs[0][0, to - 1, ti - 1] = torch.tensor(
                    _EYE_CELL, device=cuda_device)[:, None]
            grads = _check_kernels_on_card(inputs, detect_last)
            if detect_last or shape[0] > 1:  # a |.| behind the zero rows
                assert (grads[3][::5] == 0).all()


@pytest.mark.gpu
def test_deepgrid_kernels_around_rows_per_block_on_card(cuda_device):
    """The 64x64 cascade's grid (4 layers of 4x4 tiles of 16, 29 columns)
    at batches around its rows a block R at B = 1024 (R - 1, R, R + 1), at
    131 and 133 (one and two rows a block on a 132-SM card, ragged) and at
    1024: B6, B7 and B8 against their plain versions.  A random 40% of the
    cells are the identity, so lanes of a warp skip different runs."""
    rng = np.random.default_rng(29)
    r = givens_mesh.deepgrid_fwd_plan(1024, 16, 4, 4, 4, 29)["rows"]
    for b in sorted({max(r - 1, 1), r, r + 1, 131, 133, 1024}):
        for detect_last in (True, False):
            inputs = _grid_inputs(rng, 4, 4, 4, 16, mixed=True, b=b,
                                  n_cols=29)
            for coef in (inputs[0], inputs[2]):
                eye = torch.from_numpy(rng.random((4, 4, 4, 29, 8)) < 0.4)
                coef.movedim(4, -1)[eye] = torch.tensor(_EYE_CELL)
            _check_kernels_on_card([t.to(cuda_device) for t in inputs],
                                   detect_last)


@pytest.mark.gpu
def test_deep_apply_launch_choice_and_gradient_on_card(cuda_device):
    """Inference launches only B6; a gradient launches B7 then B8 once each
    and matches the same gradient on the CPU; B = 0 launches nothing."""
    rng = np.random.default_rng(3)
    layers = _layers(rng, 4, 2, 2, 2, screens=True)
    x = _x(rng, 9, 8)
    grads = {}
    for dev in ("cpu", cuda_device):
        lt = _map(_torch(layers, grad=True), lambda t: t.detach().to(dev)
                  .requires_grad_(True))
        xt = torch.from_numpy(x).to(dev)
        before = dict(givens_mesh.LAUNCHES)
        with torch.no_grad():
            ops.deep_apply(lt, xt, n=4)
        ops.deep_apply(lt, xt, n=4).sum().backward()
        on_card = int(dev != "cpu")
        assert {k: givens_mesh.LAUNCHES[k] - before[k] for k in (
            "deepgrid_fwd", "deepgrid_fwd_res", "deepgrid_bwd")} == {
            "deepgrid_fwd": on_card, "deepgrid_fwd_res": on_card,
            "deepgrid_bwd": on_card}
        grads[str(dev)] = [leaf.grad.cpu() for leaf in _leaves(lt)]
    for got, want in zip(grads[str(cuda_device)], grads["cpu"]):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    inputs = [t.to(cuda_device) for t in _grid_inputs(rng, 2, 2, 2, 4, False,
                                                      b=0)]
    before = dict(givens_mesh.LAUNCHES)
    out, sv, su = givens_mesh.launch_deepgrid(*inputs, save_stages=True)
    dcv, dcu, dg, dx = givens_mesh.launch_deepgrid_backward(
        *inputs, sv, su, torch.zeros(0, 8, device=cuda_device))
    assert givens_mesh.LAUNCHES == before
    assert out.shape == (0, 8) and dx.shape == (0, 8)
    assert not (dcv.any() or dcu.any() or dg.any())


@pytest.mark.gpu
@pytest.mark.parametrize("shape,batches", [
    ((4, 1, 1, 8), (7, 8, 9, 10, 63, 64, 65, 1024)),   # one tile, 8 rows a warp
    ((2, 1, 1, 32), (1, 2, 3, 16, 17, 130)),           # 2 rows a warp
    ((1, 4, 4, 16), (7, 8, 9, 1024, 1025)),            # 8 rows a block
    ((2, 2, 2, 4), (1, 8, 9, 131)),
])
def test_deepgrid_backward_plan_edges_on_card(cuda_device, shape, batches):
    """B8 at batches around its plan's rows a warp and a block and its
    one-block limit (one kernel a call there, two above): against its plain
    version, bit-identical twice (its own generator)."""
    rng = np.random.default_rng(1900 + sum(shape))
    depth, to, ti, n = shape
    for b in batches:
        inputs = [t.to(cuda_device) for t in _grid_inputs(
            rng, *shape, mixed=True, b=b)]
        inputs[5][::5] = 0
        _check_kernels_on_card(inputs, detect_last=bool(b % 2))
        plan = givens_mesh.deepgrid_bwd_plan(b, n, depth, to, ti,
                                             inputs[0].shape[3], b % 2)
        assert plan["register_path"] == 1
        assert plan["kernels"] == (1 if plan["blocks"] == 1 else 2)
        assert (plan["blocks"] == 1) == (b <= plan["rows"])


@pytest.mark.gpu
def test_compiled_apply_launches_one_b6_kernel_on_card(cuda_device):
    """A calibrated, placed ``CompiledTiledProgram`` (64x64 in tiles of 16,
    PROTOTYPE draws) applies through one B6 launch per call, no B7 or B8 and
    no packing, and agrees with the same program carried to the CPU within
    1e-5 of its largest output."""
    import dataclasses

    from repro_torch import compile as t_compile
    from repro_torch.paper.prototype import PROTOTYPE

    w = np.random.default_rng(21).normal(size=(64, 64)) / 8.0
    tp = t_compile.program_tiled(t_compile.synthesize_tiled(
        w, tile=16, device=cuda_device))
    tp = t_compile.apply_placement(tp, t_compile.TilePlacement(
        (2, 0, 3, 1), (1, 3, 0, 2)))
    tp = t_compile.calibrate_tiled(tp, PROTOTYPE, key=3, steps=2)
    comp = t_compile.lower_tiled(tp)
    x = torch.randn(1024, 64, device=cuda_device)
    packs = dict(ops.PACK_EVENTS)
    before = dict(givens_mesh.LAUNCHES)
    with torch.enable_grad():
        y = comp.apply(x)
    torch.cuda.synchronize()
    assert {k: givens_mesh.LAUNCHES[k] - before[k] for k in (
        "deepgrid_fwd", "deepgrid_fwd_res", "deepgrid_bwd")} == {
        "deepgrid_fwd": 1, "deepgrid_fwd_res": 0, "deepgrid_bwd": 0}
    assert ops.PACK_EVENTS == packs and y.grad_fn is None

    # the same packed tensors on the CPU: the plain B6
    cpu = dataclasses.replace(comp, packed=tuple(t.cpu() for t in comp.packed))
    want = cpu.apply(x.cpu())
    assert _rel(y.cpu(), want) <= 1e-5
