"""Public wrappers around the mesh kernels.

``mesh_apply`` and ``mesh_apply_cells`` build the ``[C', 8, P]``
coefficients (ideal cells, or the hardware model with optional phase
noise), apply the optional ``alpha_in``/``alpha`` phase screens as plain
PyTorch, and run the column sweep through
:func:`repro_torch.kernels.givens_mesh.mesh_forward`: the CUDA kernel on a
CUDA tensor, its plain version on a CPU tensor.

Both are differentiable with respect to the params (or ``t_all``), the
screens and ``x``: the sweep's backward is kernel B2 on a CUDA tensor and
its plain version on a CPU tensor, and autograd carries the gradient
through the coefficient build and the screens around it.

``rfnn_linear`` is the fused analog linear layer ``|scale * U D V x|``
(paper Eq. 31) over kernels B3/B4 (forward) and B5 (backward): the phase
screens fold into the gains around the kernel, and autograd carries the
gains gradient back into the attenuation and the scale.

``deep_apply`` runs a whole deep tiled network, L layers of a (To x Ti)
grid of tiles, through kernels B6/B7 (forward) and B8 (backward), one
launch per direction; ``rfnn_network`` (L x 1 x 1) and ``tiled_apply``
(1 x To x Ti) are its degenerate cases.  ``pack_deep_grid`` builds the
stacked coefficients and gains through a leaf-identity cache
(``PACK_EVENTS`` counts the builds), so serving in steady state packs
nothing.

The JAX package's ``_auto_block``/``_pad_batch`` sized batch blocks for the
TPU's VMEM; the CUDA kernels mask the ragged last tile themselves, so there
is no ``block_b`` (nor ``interpret``) argument here.

With ``mesh=`` (a ``DeviceMesh`` naming a row and a data axis) the deep
grid shards by tile rows and batch: each rank runs B6/B7 and B8 on its
tile-row slab of its batch shard, one layer a launch, and every rank
returns the whole output (``repro_torch.parallel.collectives``).
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from repro_torch.core import hardware as hw_lib
from repro_torch.core import mesh as mesh_lib
from repro_torch.core.cell import as_complex, cell_matrix, expj
from repro_torch.kernels import givens_mesh
from repro_torch.kernels.schedule import (
    MeshSchedule,
    clements_schedule,
    deep_grid_parity_arrays,
    deep_grid_schedule,
    pack_cells,
    pad_columns,
    parity_array,
    schedule_from_plan,
)
from repro_torch.parallel import collectives as coll

#: Per-entry-point invocation counts of the kernel path (proof that a
#: configuration went through the kernel wrappers).
KERNEL_PATH_CALLS = {"mesh_apply": 0, "mesh_apply_cells": 0, "rfnn_linear": 0,
                     "rfnn_network": 0, "tiled_apply": 0, "deep_apply": 0,
                     "deep_apply_sharded": 0, "tiled_apply_sharded": 0}

#: Coefficient-pack builds actually executed by :func:`pack_deep_grid`
#: (cache misses and bypasses), keyed by the entry point that asked for the
#: pack.  Steady-state serving must not tick this.
PACK_EVENTS = {"rfnn_network": 0, "tiled_apply": 0, "deep_apply": 0}


def _mesh_coefficients(sched: MeshSchedule, params: dict,
                       hardware: hw_lib.HardwareModel | None,
                       generator: torch.Generator | None,
                       draws: dict | None = None) -> torch.Tensor:
    """Packed [C', 8, P] coefficients from mesh params.

    With a hardware model, cells come from ``imperfect_cell_matrix`` — the
    same function (and the same generator draws, or the same frozen
    ``draws``) as the reference ``apply_mesh_hw`` path.
    """
    theta, phi = params["theta"], params["phi"]
    if hardware is None:
        t_all = cell_matrix(theta, phi)
    else:
        t_all = hw_lib.imperfect_cell_matrix(theta, phi, hardware, generator,
                                             draws)
    return pack_cells(sched, t_all)


def _sweep(sched: MeshSchedule, coef: torch.Tensor, x: torch.Tensor,
           alpha_in, alpha) -> torch.Tensor:
    batch_shape = x.shape[:-1]
    if x.shape[-1] != sched.n:
        raise ValueError(f"expected trailing dim {sched.n}, got {tuple(x.shape)}")
    x2 = mesh_lib.apply_screens(as_complex(x).reshape(-1, sched.n), alpha_in)
    y = givens_mesh.mesh_forward(coef, parity_array(sched, x2.device),
                                 x2.contiguous())
    y = mesh_lib.apply_screens(y, alpha)
    return y.reshape(batch_shape + (sched.n,))


def mesh_apply(params: dict, x: torch.Tensor, *, n: int,
               plan: mesh_lib.MeshPlan | None = None,
               hardware: hw_lib.HardwareModel | None = None,
               generator: torch.Generator | None = None,
               draws: dict | None = None) -> torch.Tensor:
    """Apply a mesh to ``x[..., n]`` through the kernel path.

    Semantics match ``repro_torch.core.mesh.apply_mesh`` on the given plan
    (``None`` = the Clements rectangle), including the optional phase
    screens ``alpha_in`` / ``alpha``; with ``hardware`` they match
    ``repro_torch.core.hardware.apply_mesh_hw`` (imperfect hybrids, per-cell
    insertion loss, and phase-shifter noise sampled from ``generator`` or
    taken from the frozen ``draws``).
    """
    sched = clements_schedule(n) if plan is None else schedule_from_plan(plan)
    KERNEL_PATH_CALLS["mesh_apply"] += 1
    coef = _mesh_coefficients(sched, params, hardware, generator, draws)
    return _sweep(sched, coef, x, params.get("alpha_in"), params.get("alpha"))


def mesh_apply_cells(t_all: torch.Tensor, x: torch.Tensor, *,
                     plan: mesh_lib.MeshPlan,
                     alpha_in: torch.Tensor | None = None,
                     alpha: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel mesh apply from explicit per-cell 2x2 matrices ``[C, P, 2, 2]``.

    The cells-level entry point: callers that build transfer matrices
    directly (e.g. from noise draws made elsewhere) hit the same sweep
    without going through (theta, phi).
    """
    sched = schedule_from_plan(plan)
    KERNEL_PATH_CALLS["mesh_apply_cells"] += 1
    return _sweep(sched, pack_cells(sched, t_all), x, alpha_in, alpha)


def _gains(atten, scale, v_params: dict, u_params: dict, n: int,
           device) -> torch.Tensor:
    """The kernel's float32 ``[8, P]`` gains: g1 = atten with V's output
    screen and U's input screen folded in (rows 0-3), g2 = scale with U's
    output screen (rows 4-7); even re, even im, odd re, odd im.  All are
    diagonal, so they commute with each other."""
    g1 = torch.as_tensor(atten, device=device).to(torch.complex64)
    for alpha in (v_params.get("alpha"), u_params.get("alpha_in")):
        if alpha is not None:
            g1 = g1 * expj(alpha)
    g2 = torch.as_tensor(scale, dtype=torch.float32, device=device) \
        .expand(n).to(torch.complex64)
    if u_params.get("alpha") is not None:
        g2 = g2 * expj(u_params["alpha"])
    return torch.stack([part for g in (g1, g2) for h in (g[0::2], g[1::2])
                        for part in (h.real, h.imag)]).to(torch.float32)


def rfnn_linear(v_params: dict, atten, u_params: dict, x: torch.Tensor, *,
                n: int, scale=1.0, v_plan: mesh_lib.MeshPlan | None = None,
                u_plan: mesh_lib.MeshPlan | None = None,
                hardware: hw_lib.HardwareModel | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
    """Fused analog linear layer ``|scale * U (D (V x))|`` through the
    kernel path; the counterpart of the JAX package's ``ops.rfnn_linear``.

    ``atten``: [n] attenuation (the paper's diagonal D / sigma_max);
    ``scale``: the digital gamma.  Returns the detected magnitude
    ``[..., n]`` (float32); ``hardware.detect_magnitude`` composes on top for
    the detector's noise and floor.  ``v_plan``/``u_plan`` default to the
    Clements rectangle; Reck programs (more columns) run in the same fused
    sweep.  With ``hardware`` the cells come from the imperfection model,
    V's phase noise and then U's drawn from ``generator``.  V's input screen
    ``alpha_in`` applies before the kernel; the other screens fold into the
    gains.  Differentiable in both meshes' params, ``atten``, ``scale`` and
    ``x``.
    """
    sched_v = clements_schedule(n) if v_plan is None else schedule_from_plan(v_plan)
    sched_u = clements_schedule(n) if u_plan is None else schedule_from_plan(u_plan)
    KERNEL_PATH_CALLS["rfnn_linear"] += 1
    batch_shape = x.shape[:-1]
    if x.shape[-1] != n:
        raise ValueError(f"expected trailing dim {n}, got {tuple(x.shape)}")
    x2 = mesh_lib.apply_screens(as_complex(x).reshape(-1, n),
                                v_params.get("alpha_in"))
    coef_v = _mesh_coefficients(sched_v, v_params, hardware, generator)
    coef_u = _mesh_coefficients(sched_u, u_params, hardware, generator)
    gains = _gains(atten, scale, v_params, u_params, n, x2.device)
    out = givens_mesh.rfnn_forward(
        coef_v, parity_array(sched_v, x2.device), coef_u,
        parity_array(sched_u, x2.device), gains, x2.contiguous())
    return out.reshape(batch_shape + (n,))


# ---------------------------------------------------------------------------
# the deep tile grid: L layers x (To x Ti) tiles, one launch per direction
# ---------------------------------------------------------------------------

def _layer_gains(n: int, la: dict, device) -> torch.Tensor:
    """One tile's float32 ``[12, P]`` gains: g0 (V's input screen,
    rows 0-3) above :func:`_gains`' g1 and g2 (rows 4-11)."""
    g0 = torch.ones(n, dtype=torch.complex64, device=device)
    if la["v"].get("alpha_in") is not None:
        g0 = g0 * expj(la["v"]["alpha_in"])
    rows = [part for h in (g0[0::2], g0[1::2]) for part in (h.real, h.imag)]
    return torch.cat([torch.stack(rows).to(torch.float32),
                      _gains(la["atten"], la.get("scale", 1.0), la["v"],
                             la["u"], n, device)])


def _pack_deep_grid_impl(deep, hardware, layers) -> tuple[torch.Tensor, ...]:
    """Stacked ``[L, To, Ti, C, 8, P]`` coefficients and ``[L, To, Ti, 12,
    P]`` gains, every mesh identity-padded to the grid's column count.
    Tiles are built in order (layer, row, tile; V then U): a tile's
    ``generator`` draws its V noise, then its U noise; a calibrated tile's
    frozen ``draws_v``/``draws_u`` are used as they are."""
    c = deep.n_columns
    coef_v, coef_u, gains = [], [], []
    for slayer, tlayer in zip(deep.layers, layers):
        for srow, trow in zip(slayer, tlayer):
            for (sv, su), ta in zip(srow, trow):
                gen = ta.get("generator")
                coef_v.append(pad_columns(_mesh_coefficients(
                    sv, ta["v"], hardware, gen, ta.get("draws_v")), c))
                coef_u.append(pad_columns(_mesh_coefficients(
                    su, ta["u"], hardware, gen, ta.get("draws_u")), c))
                gains.append(_layer_gains(deep.n, ta, coef_v[-1].device))
    lead = (deep.n_layers, deep.to, deep.ti)
    return tuple(torch.stack(t).reshape(lead + t[0].shape)
                 for t in (coef_v, coef_u, gains))


def _leaf_key(leaf):
    if isinstance(leaf, torch.Tensor):
        return ("tensor", id(leaf), leaf._version)
    if leaf is None or isinstance(leaf, (bool, int, float, str)):
        return ("value", leaf)
    return ("object", id(leaf))


def _cacheable(leaves) -> bool:
    """Whether a tree's derived values may be cached: never when a leaf is a
    noise generator (its draws are stateful and must not be replayed), nor
    when autograd would have to flow through the derivation."""
    if any(isinstance(leaf, torch.Generator) for leaf in leaves):
        return False
    return not (torch.is_grad_enabled() and any(
        isinstance(leaf, torch.Tensor) and leaf.requires_grad
        for leaf in leaves))


class _LeafIdCache:
    """Small cache keyed on (static key, identity and version of every
    leaf); the oldest entry goes first when it is full.

    Holding strong references to the keyed leaves keeps their ids from being
    recycled, and a tensor's ``_version`` moves with every in-place edit, so
    a hit is exact: same schedule, same parameter tensors -> the same derived
    values, with no work.  Trees that are not :func:`_cacheable` bypass it.
    """

    def __init__(self, maxsize: int = 8):
        self._maxsize = maxsize
        self._entries: dict[tuple, tuple] = {}  # key -> (leaves, value)

    def get_or_build(self, static_key, tree, builder):
        leaves = pytree.tree_leaves(tree)
        if not _cacheable(leaves):
            return builder()
        key = (static_key,) + tuple(_leaf_key(leaf) for leaf in leaves)
        hit = self._entries.get(key)
        if hit is not None:
            return hit[1]
        value = builder()
        while len(self._entries) >= self._maxsize:
            self._entries.pop(next(iter(self._entries)))
        self._entries[key] = (leaves, value)
        return value


_DEEPGRID_PACK_CACHE = _LeafIdCache(maxsize=8)

_SHARED_LEAF_CACHES: dict = {}


def memoize_by_leaf_ids(static_key, tree, builder):
    """Leaf-identity memoization for derived-parameter pipelines.

    Callers (``AnalogSequence``, ``TiledAnalogLinear``) keep *derived*
    tensors (sigmoid'd attenuations, quantized phases) stable across calls
    with the same underlying parameters, which is what lets the pack cache
    downstream hit.  Trees carrying a generator, or needing a gradient,
    bypass; each static key has its own small cache.
    """
    cache = _SHARED_LEAF_CACHES.setdefault(static_key, _LeafIdCache())
    return cache.get_or_build(static_key, tree, builder)


def pack_deep_grid(layers, *, n: int, plans=None,
                   hardware: hw_lib.HardwareModel | None = None,
                   _event: str = "deep_apply"):
    """The deep kernels' inputs for L layers of (To x Ti) tiles.

    ``layers``: nested ``[L][To][Ti]`` sequence of per-tile dicts with keys
    ``v``/``u`` (mesh params, optional ``alpha_in``/``alpha`` screens),
    ``atten`` ([n] diagonal), optional ``scale`` (the digital gamma) and,
    with ``hardware``, an optional ``generator`` for phase noise or the
    frozen ``draws_v``/``draws_u`` of a calibrated tile (``{"theta": z,
    "phi": z}`` each; ordinary leaves, so the pack cache keys them exactly).
    ``plans``: a matching ``[L][To][Ti]`` nesting of ``(v_plan, u_plan)``
    pairs (``None`` for Clements).

    Returns ``(deep, (coef_v, coef_u, gains))``: the static
    :class:`~repro_torch.kernels.schedule.DeepGridSchedule` and the stacked
    tensors, ready for :func:`deep_apply`'s ``packed=``.  Results go through
    the leaf-identity pack cache (``PACK_EVENTS`` counts the builds): repeat
    calls with the same tile tensors pack nothing; a gradient through the
    packing, or a generator, bypasses it.
    """
    layers = tuple(tuple(tuple(row) for row in layer) for layer in layers)
    deep = deep_grid_schedule(n, len(layers), len(layers[0]),
                              len(layers[0][0]), plans)

    def build():
        PACK_EVENTS[_event] += 1
        return _pack_deep_grid_impl(deep, hardware, layers)

    return deep, _DEEPGRID_PACK_CACHE.get_or_build((deep, hardware), layers,
                                                   build)


# ---------------------------------------------------------------------------
# the sharded deep grid: (tile-row x batch) over a DeviceMesh
# ---------------------------------------------------------------------------
#
# Each rank runs the same single-layer launch on its (To/rows)-row slab of
# the replicated coefficients with its batch shard.  The forward needs no
# collective inside a layer: every row's combine is local to the rank that
# holds the row.  The backward's input cotangent is the transpose of the row
# combine: B8 sums its own rows' partials, and an all-reduce over the row
# axis finishes the sum.  Depth does not fuse across ranks: a layer's
# re-detected rows are the next layer's whole input, so L > 1 is a chain of
# single-layer launches, the row slabs gathered back at each boundary, with
# the boundary |detect| inside the kernel (``detect_last=True``) so padded
# batch rows get exact zero gradients.

def _slab(t: torch.Tensor, r: int, rows: int) -> torch.Tensor:
    """Tile-row slab ``r`` of ``rows`` (axis 1, To) of a layer's operand."""
    k = t.shape[1] // rows
    return t.narrow(1, r * k, k)


def _grid_layer(slabs, x, detect_last: bool, save: bool):
    """One layer's slab launch: B7 (``save``: ``(out, sv, su)``) or B6
    (``out``) on a CUDA tensor, the plain version on a CPU tensor."""
    if x.device.type == "cuda":
        return givens_mesh.launch_deepgrid(*slabs, x, detect_last=detect_last,
                                           save_stages=save)
    if x.device.type != "cpu":
        raise ValueError(f"the deep grid runs on cuda or cpu tensors, got "
                         f"{x.device}")
    out = givens_mesh.deepgrid_forward_plain(*slabs, x,
                                             detect_last=detect_last)
    return out if save else out[0]


class _ShardedGridLayer(torch.autograd.Function):
    """One layer of the deep grid on this rank's tile-row slab and batch
    shard: B7 forward and B8 backward (their plain versions on CPU
    tensors).  Takes the layer's whole ``[1, To, Ti, ...]`` operands, the
    same on every rank, and this rank's ``[B_shard, Ti n]`` input; returns
    its ``[B_shard, To/rows n]`` rows.  The backward hands back the whole
    coefficient and gain gradients (summed over the data axis, gathered over
    the row axis) and the shard's input cotangent summed over the row
    axis."""

    @staticmethod
    def forward(ctx, coef_v, par_v, coef_u, par_u, gains, x, detect_last,
                mesh, row_axis, data_axis):
        r = coll.axis_index(mesh, row_axis)
        rows = coll.axis_size(mesh, row_axis)
        slabs = [_slab(t, r, rows) for t in (coef_v, par_v, coef_u, par_u,
                                              gains)]
        out, sv, su = _grid_layer(slabs, x, detect_last, save=True)
        ctx.detect_last, ctx.mesh = detect_last, mesh
        ctx.row_axis, ctx.data_axis = row_axis, data_axis
        ctx.save_for_backward(*slabs, x, sv, su)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        args = ctx.saved_tensors + (g.contiguous(),)
        if g.device.type == "cuda":
            dcv, dcu, dg, dx = givens_mesh.launch_deepgrid_backward(
                *args, detect_last=ctx.detect_last)
        else:
            dcv, dcu, dg, dx = givens_mesh.deepgrid_backward_plain(
                *args, detect_last=ctx.detect_last)
        rows = coll.axis_group(ctx.mesh, ctx.row_axis)
        data = coll.axis_group(ctx.mesh, ctx.data_axis)
        dx = coll.all_reduce(dx, rows)
        dcv, dcu, dg = (coll.all_gather(coll.all_reduce(d, data), rows, dim=1)
                        for d in (dcv, dcu, dg))
        return dcv, None, dcu, None, dg, dx, None, None, None, None


def _sharded_layer(layer_ops, x, detect_last, mesh, row_axis, data_axis):
    """:class:`_ShardedGridLayer` when a gradient is wanted, else B6 (or
    its plain version) on the slab."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in layer_ops + (x,)):
        return _ShardedGridLayer.apply(*layer_ops, x, detect_last, mesh,
                                       row_axis, data_axis)
    slabs = [_slab(t, coll.axis_index(mesh, row_axis),
                   coll.axis_size(mesh, row_axis)) for t in layer_ops]
    return _grid_layer(slabs, x, detect_last, save=False)


def _deep_apply_sharded(deep, tensors, x2, detect_last, mesh, row_axis,
                        data_axis) -> torch.Tensor:
    """The grid over ``mesh``: ``x2`` is the whole ``[B, Ti n]`` complex
    input, the result the whole ``[B, To n]`` rows, on every rank."""
    coef_v, coef_u, gains = tensors
    par_v, par_u = deep_grid_parity_arrays(deep, x2.device)
    b = x2.shape[0]
    h = coll.scatter(coll.pad_rows(x2, coll.axis_size(mesh, data_axis)),
                     mesh, data_axis)
    for l in range(deep.n_layers):
        last = l == deep.n_layers - 1
        layer_ops = tuple(t[l:l + 1] for t in (coef_v, par_v, coef_u, par_u,
                                                gains))
        out = _sharded_layer(layer_ops, h, detect_last if last else True,
                             mesh, row_axis, data_axis)
        h = coll.gather(out, mesh, row_axis, dim=1)
        if not last:
            # the re-detected To rows are the next layer's Ti real inputs
            h = h.to(torch.complex64)
    return coll.gather(h, mesh, data_axis)[:b]


def deep_apply(layers, x: torch.Tensor, *, n: int, plans=None,
               hardware: hw_lib.HardwareModel | None = None, packed=None,
               readout: str = "magnitude", mesh=None, row_axis: str = "rows",
               data_axis: str = "data") -> torch.Tensor:
    """A whole deep tiled network, L layers of a (To x Ti) tile grid, in one
    kernel launch per direction.

    ``layers``/``plans``/``hardware``: see :func:`pack_deep_grid`.  ``x``
    is ``[..., Ti n]``; each layer's rows combine their Ti tile outputs
    (the matched-line power combiner) and the re-detected row magnitudes
    feed the next layer inside the kernel.  ``readout="magnitude"`` returns
    the last layer's row magnitudes, float32 ``[..., To n]``;
    ``"complex"`` the combined complex rows, so digital readouts (real
    part, detector noise) compose on top.  Differentiable in every tile's
    params and ``x``: the backward unwinds all layers in one kernel from the
    saved stage boundaries.  ``packed``: a :func:`pack_deep_grid` result,
    skipping the pack and its cache.

    ``mesh``: a ``DeviceMesh`` naming ``row_axis`` and ``data_axis``.  Each
    layer's grid then shards its tile rows over ``row_axis`` and the batch
    over ``data_axis``, each rank launching the same kernels on its
    row slab and batch shard; depth runs as a chain of single-layer
    launches.  Every rank passes the same whole ``x`` and gets the whole
    output; gradients come back whole on every rank.  Matches the
    single-device call to float tolerance; needs ``To % rows == 0``.
    """
    if readout not in ("magnitude", "complex"):
        raise ValueError(f"readout must be 'magnitude' or 'complex', "
                         f"got {readout!r}")
    KERNEL_PATH_CALLS["deep_apply"] += 1
    if packed is None:
        packed = pack_deep_grid(layers, n=n, plans=plans, hardware=hardware)
    deep, tensors = packed
    if x.shape[-1] != deep.ti * deep.n:
        raise ValueError(
            f"expected trailing dim {deep.ti * deep.n} (Ti={deep.ti} tiles "
            f"of n={deep.n}), got {tuple(x.shape)}")
    batch_shape = x.shape[:-1]
    x2 = as_complex(x).reshape(-1, deep.ti * deep.n).contiguous()
    detect_last = readout == "magnitude"
    if mesh is None:
        par_v, par_u = deep_grid_parity_arrays(deep, x2.device)
        y = givens_mesh.deepgrid_forward(tensors[0], par_v, tensors[1], par_u,
                                         tensors[2], x2,
                                         detect_last=detect_last)
    else:
        KERNEL_PATH_CALLS["deep_apply_sharded"] += 1
        coll.require_axes(mesh, row_axis, data_axis)
        rows = coll.axis_size(mesh, row_axis)
        if deep.to % rows:
            raise ValueError(
                f"To={deep.to} tile rows do not shard over {rows} ranks on "
                f"axis {row_axis!r}")
        y = _deep_apply_sharded(deep, tensors, x2, detect_last, mesh,
                                row_axis, data_axis)
    return y.reshape(batch_shape + (deep.to * deep.n,))


def pack_network(layers, *, n: int, plans=None,
                 hardware: hw_lib.HardwareModel | None = None):
    """:func:`pack_deep_grid` for an L-layer RFNN (the To = Ti = 1 case):
    ``layers`` a flat per-layer sequence of tile dicts, ``plans`` a flat
    per-layer sequence of ``(v_plan, u_plan)`` pairs.  Ticks
    ``PACK_EVENTS["rfnn_network"]``."""
    return pack_deep_grid(
        tuple(((la,),) for la in layers), n=n,
        plans=None if plans is None else tuple(((p,),) for p in plans),
        hardware=hardware, _event="rfnn_network")


def rfnn_network(layers, x: torch.Tensor, *, n: int, plans=None,
                 hardware: hw_lib.HardwareModel | None = None,
                 packed=None) -> torch.Tensor:
    """The fused L-layer RFNN ``|.. |scale_l U_l (D_l (V_l ..))| ..|``:
    :func:`deep_apply` on the ``L x 1 x 1`` grid with the magnitude
    readout (see :func:`pack_network` for the arguments)."""
    KERNEL_PATH_CALLS["rfnn_network"] += 1
    if packed is None:
        packed = pack_network(layers, n=n, plans=plans, hardware=hardware)
    return deep_apply(None, x, n=n, packed=packed, readout="magnitude")


def pack_tile_grid(tiles, *, n: int, plans=None,
                   hardware: hw_lib.HardwareModel | None = None):
    """:func:`pack_deep_grid` for one (To x Ti) grid (the L = 1 case):
    ``tiles`` a nested ``[To][Ti]`` sequence of tile dicts, ``plans`` a
    matching nesting of ``(v_plan, u_plan)`` pairs.  Ticks
    ``PACK_EVENTS["tiled_apply"]``."""
    return pack_deep_grid(
        (tuple(tuple(row) for row in tiles),), n=n,
        plans=None if plans is None else (tuple(tuple(r) for r in plans),),
        hardware=hardware, _event="tiled_apply")


def tiled_apply(tiles, x: torch.Tensor, *, n: int, plans=None,
                hardware: hw_lib.HardwareModel | None = None, packed=None,
                mesh=None, row_axis: str = "rows",
                data_axis: str = "data") -> torch.Tensor:
    """A (To x Ti) tile-grid matmul, ``sum_i gamma U (D (V x_i))`` per row:
    :func:`deep_apply` on the ``1 x To x Ti`` grid with the complex readout
    (see :func:`pack_tile_grid`; ``mesh``/``row_axis``/``data_axis`` as
    there).  ``x`` is ``[..., Ti n]``, the result the complex ``[..., To
    n]``; the readout (|.|, real part, detector noise) composes on top."""
    KERNEL_PATH_CALLS["tiled_apply"] += 1
    if packed is None:
        packed = pack_tile_grid(tiles, n=n, plans=plans, hardware=hardware)
    if mesh is not None:
        KERNEL_PATH_CALLS["tiled_apply_sharded"] += 1
    return deep_apply(None, x, n=n, packed=packed, readout="complex",
                      mesh=mesh, row_axis=row_axis, data_axis=data_axis)
