"""Logical-axis sharding rules, the mesh context, the tile grid's shard
specs and the data-parallel wrapper: the counterpart of the JAX package's
``repro.parallel.sharding``.

Model code names its axes logically (``batch``, ``heads``, ``ffn`` ...).  A
:class:`ShardingRules` table maps each logical name onto mesh axes; a spec
is the port's own tuple with one entry a tensor dimension: ``None``
(replicated), a mesh-axis name or a tuple of names, compared element by
element with the JAX package's ``PartitionSpec``.

Parallelism encoded by the default rules:
  * DP: ``batch`` over ("pod", "data")
  * TP: ``heads`` / ``kv_heads`` / ``ffn`` / ``vocab`` over "model"
  * EP: ``experts`` over "data" with the expert FFN dim over "model"
  * SP: ``kv_seq`` over "data" for long-context decode
  * ZeRO-1: the optimizer state's ``fsdp`` axis over "data"

Under an active mesh (:func:`use_mesh_and_rules`) the model code's
:func:`constrain` calls make each annotated activation a ``DTensor`` with
the placements of its spec (:func:`placements`), as the JAX package's
``with_sharding_constraint`` does; outside one they return their input
itself.  The mesh context also runs the enclosed block under DTensor's
``implicit_replication``: a plain tensor the model makes itself (positions,
RoPE tables, masks, fills, zero caches) meets the DTensors as the
replicated value every rank holds.  :func:`local_call` runs a function on
the local shards (the kernels' wrappers take device pointers, never a
DTensor), and :func:`local_index_put_` writes rows into a sharded cache
where each rank holds them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import (implicit_replication,
                                                   local_map)
from torch.utils import _pytree as pytree

from repro_torch.parallel import collectives as coll


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Mapping logical axis name -> mesh axis (str or tuple) or None."""

    rules: dict

    def spec(self, *names: str | None) -> tuple:
        axes = []
        used: set[str] = set()
        for nm in names:
            if nm is None:
                axes.append(None)
                continue
            ax = self.rules.get(nm)
            members = set(ax) if isinstance(ax, tuple) else {ax}
            # a mesh axis may appear at most once in a spec; earlier
            # logical names win (e.g. batch over kv_seq on "data")
            if ax is None or (members & used):
                axes.append(None)
            else:
                # a one-axis tuple is that axis, as PartitionSpec keeps it
                axes.append(ax[0] if isinstance(ax, tuple) and len(ax) == 1
                            else ax)
                used |= members
        return tuple(axes)


def default_rules(multi_pod: bool = False) -> ShardingRules:
    batch_axes = ("pod", "data") if multi_pod else ("data",)
    return ShardingRules(rules={
        "batch": batch_axes,
        "expert_group": batch_axes,
        "seq": None,
        "kv_seq": "data",          # long-context decode: shard cache length
        "embed": None,
        "mlp_embed": None,
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "ffn": "model",
        "vocab": "model",
        "experts": "data",
        "expert_ffn": "model",
        "ssm_heads": "model",
        "ssm_state": None,
        "conv_dim": "model",
        "tp": "model",             # generic TP annotation (e.g. MoE out D)
        "layers": None,
        "fsdp": "data",            # optimizer-state (ZeRO-1) sharding axis
        "stage": "pod",            # pipeline stages (optional profile)
    })


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: ShardingRules | None = None


_CTX = _Ctx()


_REPLICATING = [0]   # blocks inside implicit_replication, all threads


@contextlib.contextmanager
def _replicating():
    """DTensor's ``implicit_replication`` for the outermost block only: its
    flag is one for the process, and leaving any block clears it (a
    checkpoint's recomputation re-enters the mesh context on autograd's
    thread while the forward's block is still open)."""
    _REPLICATING[0] += 1
    try:
        if _REPLICATING[0] > 1:
            yield
        else:
            with implicit_replication():
                yield
    finally:
        _REPLICATING[0] -= 1


@contextlib.contextmanager
def use_mesh_and_rules(mesh, rules: ShardingRules):
    """Install ``mesh`` (a ``DeviceMesh``) and ``rules`` for the enclosed
    block, on this thread, under ``implicit_replication``."""
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh, _CTX.rules = mesh, rules
    try:
        with _replicating():
            yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def set_rules(rules: ShardingRules) -> None:
    _CTX.rules = rules


def active_mesh():
    return _CTX.mesh


def active_rules() -> ShardingRules | None:
    return _CTX.rules


def logical_spec(*names: str | None) -> tuple:
    """The installed rules' spec of ``names``; all ``None`` without
    rules."""
    rules = _CTX.rules
    if rules is None:
        return (None,) * len(names)
    return rules.spec(*names)


def placements(mesh, spec: tuple) -> tuple:
    """DTensor placements, one a mesh dimension, of ``spec`` (one entry a
    tensor dim: ``None``, a mesh-axis name or a tuple of names).

    A tuple shards its tensor dim over several mesh dims, the first name
    major, as ``PartitionSpec`` does; DTensor splits a dim over its mesh
    dims in mesh order, so the names must come in that order.
    """
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        for a in axes:
            if a not in names:
                raise ValueError(f"mesh has no axis {a!r}: axes {names}")
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"axes {axes} must follow the mesh's order "
                             f"{names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {names[i]!r} used twice in "
                                 f"{spec}")
            out[i] = Shard(dim)
    return tuple(out)


def named_sharding(mesh, rules: ShardingRules, *names) -> tuple:
    """``(mesh, placements)`` of the logical ``names`` under ``rules``: what
    ``distribute_tensor`` and ``redistribute`` take."""
    return mesh, placements(mesh, rules.spec(*names))


def replicated(mesh, x: torch.Tensor) -> DTensor:
    """``x`` (the same value on every rank) as a replicated DTensor; a
    DTensor is returned as it is."""
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def whole(mesh, x: torch.Tensor) -> DTensor:
    """``x`` as a DTensor every rank holds whole."""
    return replicated(mesh, x).redistribute(mesh, [Replicate()] * mesh.ndim)


def constrain(x: torch.Tensor, *names: str | None) -> torch.Tensor:
    """Annotate ``x`` with logical axes: ``x`` itself without an active
    mesh and rules, else a DTensor with the placements of the rules' spec
    of ``names`` (a plain tensor is taken as replicated first)."""
    mesh, rules = _CTX.mesh, _CTX.rules
    if mesh is None or rules is None:
        return x
    if x.ndim != len(names):
        raise ValueError(f"rank {x.ndim} vs {len(names)} logical names "
                         f"{names}")
    return replicated(mesh, x).redistribute(
        mesh, placements(mesh, rules.spec(*names)))


def _reduced(t: DTensor) -> DTensor:
    """``t`` with every ``Partial`` placement summed into ``Replicate``."""
    if not any(isinstance(p, Partial) for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, [
        Replicate() if isinstance(p, Partial) else p for p in t.placements])


def local_call(fn, args: tuple, out_placements):
    """``fn(*args)`` on each rank's local shards under an active mesh (the
    mesh context suspended inside, so its ``constrain`` calls pass), its
    one output wrapped as a DTensor with ``out_placements``; ``fn(*args)``
    as it is without a mesh or DTensor argument.

    Each DTensor argument enters with the placements it has, a pending sum
    (``Partial``) reduced first.  A replicated argument's gradient is the
    sum of every rank's partial gradient over the mesh dims where another
    argument is split (``Partial`` there), so a replicated weight used on a
    batch shard trains as the whole batch.
    """
    mesh = _CTX.mesh
    flat = pytree.tree_leaves(args)
    if mesh is None or not any(isinstance(a, DTensor) for a in flat):
        return fn(*args)
    args = pytree.tree_map_only(DTensor, _reduced, args)
    flat = pytree.tree_leaves(args)
    split = [False] * mesh.ndim
    for a in flat:
        if isinstance(a, DTensor):
            for i, p in enumerate(a.placements):
                split[i] = split[i] or isinstance(p, Shard)
    in_pl, grad_pl = [], []
    for a in flat:
        if isinstance(a, DTensor):
            in_pl.append(a.placements)
            grad_pl.append(tuple(
                Partial() if split[i] and isinstance(p, Replicate) else p
                for i, p in enumerate(a.placements)))
        else:
            in_pl.append(None)
            grad_pl.append(None)

    def unmeshed(*local_args):
        prev = (_CTX.mesh, _CTX.rules)
        _CTX.mesh, _CTX.rules = None, None
        try:
            return fn(*local_args)
        finally:
            _CTX.mesh, _CTX.rules = prev

    return local_map(unmeshed, out_placements=list(out_placements),
                     in_placements=tuple(in_pl),
                     in_grad_placements=tuple(grad_pl),
                     device_mesh=mesh)(*args)


def local_window(shape, mesh, placements_) -> tuple[list, list]:
    """(size, offset) of this rank's shard of a ``shape`` tensor under
    ``placements_``, each a list over the tensor's dims: DTensor's even
    split (``torch.chunk``'s), mesh dims in order.  Plain Python, so it
    runs under any dispatch mode."""
    size, off = list(shape), [0] * len(shape)
    for i, p in enumerate(placements_):
        if isinstance(p, Shard):
            n, c = mesh.size(i), mesh.get_local_rank(i)
            full = size[p.dim]
            chunk = -(-full // n)
            start = min(c * chunk, full)
            size[p.dim] = min(start + chunk, full) - start
            off[p.dim] += start
    return size, off


def local_index_put_(t: torch.Tensor, indices: tuple,
                     values: torch.Tensor) -> torch.Tensor:
    """``t[indices] = values`` in place, ``indices`` one int64 tensor a
    leading dim of ``t`` (all of one length N, no index twice; ``values``
    [N, ...] holds the trailing dims).  Into a DTensor each rank writes the
    entries that fall in its own shard, ``values`` read whole: no
    collective on ``t``.

    The shard's writes keep static shapes (the dry run traces them on fake
    tensors): an entry outside the shard is sent to the first entry inside
    it with that entry's value, or, with none inside, to the first entry's
    clamped slot with the value already there, so every slot written twice
    gets one value twice.
    """
    vals = values.full_tensor() if isinstance(values, DTensor) else values
    idx = [i.full_tensor() if isinstance(i, DTensor) else i for i in indices]
    with torch.no_grad():
        if not isinstance(t, DTensor):
            t[tuple(idx)] = vals.to(t.dtype)
            return t
        shape, offset = local_window(t.shape, t.device_mesh, t.placements)
        if 0 in shape:
            return t
        for d in range(len(idx), t.dim()):   # this rank's trailing window
            vals = vals.narrow(d - len(idx) + 1, offset[d], shape[d])
        keep = torch.ones_like(idx[0], dtype=torch.bool)
        local_idx = []
        for d, i in enumerate(idx):
            keep &= (i >= offset[d]) & (i < offset[d] + shape[d])
            local_idx.append((i - offset[d]).clamp(0, shape[d] - 1))
        first = keep.to(torch.uint8).argmax().reshape(1)

        def at_first(x):
            return x.index_select(0, first)

        local_idx = tuple(torch.where(keep, i, at_first(i)) for i in local_idx)
        local = t.to_local()
        vals = vals.to(local.dtype)
        here = local[local_idx]
        fill = torch.where(keep.any(), at_first(vals), at_first(here))
        keep = keep.reshape((-1,) + (1,) * (vals.dim() - 1))
        local[local_idx] = torch.where(keep, vals, fill)
    return t


def local_copy_(dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``dst.copy_(src)``; into a DTensor each rank copies its own shard of
    ``src`` (redistributed to ``dst``'s placements)."""
    with torch.no_grad():
        if isinstance(dst, DTensor):
            mesh = dst.device_mesh
            src = replicated(mesh, src).redistribute(mesh, dst.placements)
            dst.to_local().copy_(src.to_local())
        else:
            dst.copy_(src.full_tensor() if isinstance(src, DTensor) else src)
    return dst


# ---------------------------------------------------------------------------
# Tile-grid scale-out: (tile-row x batch) specs of the deep-grid kernels
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TileGridShardSpecs:
    """Specs of every deep-grid operand and output class under the
    (tile-row x batch) sharding of ``ops.deep_apply(mesh=)``:

      * ``coef``: the ``[L, To, Ti, C, 8, P]`` coefficients (and the
        parities and ``[L, To, Ti, 12, P]`` gains): replicated; each rank
        slices its own tile-row slab (axis 1);
      * ``x_plane``: the ``[B, Ti n]`` input: batch-split, replicated over
        tile rows (every row sweeps the whole input);
      * ``o_plane``: the ``[B, To n]`` rows: split on both axes;
      * ``stage``: the ``[L, B, To, Ti, n]`` residuals of B7: batch and
        tile rows split;
      * ``dx_plane``: the input's cotangent after the all-reduce over the
        row axis: batch-split, replicated over rows.

    ``coef`` is also the spec of the coefficient gradients: the backward
    all-reduces them over the batch axis and all-gathers them over the row
    axis, so every rank holds them whole.
    """

    coef: tuple
    x_plane: tuple
    o_plane: tuple
    stage: tuple
    dx_plane: tuple


def tile_grid_shard_specs(row_axis: str = "rows",
                          data_axis: str = "data") -> TileGridShardSpecs:
    """The canonical (tile-row x batch) sharding of the deep grid."""
    return TileGridShardSpecs(
        coef=(),
        x_plane=(data_axis,),
        o_plane=(data_axis, row_axis),
        stage=(None, data_axis, row_axis),
        dx_plane=(data_axis,),
    )


# ---------------------------------------------------------------------------
# Data-parallel wrapper over the batch
# ---------------------------------------------------------------------------

def data_parallel(apply_fn, mesh, *, axis_name: str = "data"):
    """``apply_fn(params, x)`` split over ``mesh``'s ``axis_name`` by batch.

    Every rank passes the same ``params`` and the same whole ``x``; each
    runs ``apply_fn`` (e.g. the deep grid's kernels) on its block of ``x``'s
    leading axis, and every rank gets the whole output back.  A ragged
    batch is zero-padded to a multiple of the axis size and sliced back.
    Under autograd the gradients of ``params`` and ``x`` come back whole and
    equal on every rank; parameters that need no gradient pass through
    untouched, so a caller's pack cache keyed on their identity still hits.
    """
    coll.require_axes(mesh, axis_name)
    n_dev = coll.axis_size(mesh, axis_name)

    def share(t):
        if isinstance(t, torch.Tensor) and t.requires_grad \
                and torch.is_grad_enabled():
            return coll.replicate(t, mesh, axis_name)
        return t

    def call(params, x):
        b = x.shape[0]
        xs = coll.scatter(coll.pad_rows(x, n_dev), mesh, axis_name)
        y = apply_fn(pytree.tree_map(share, params), xs)
        return coll.gather(y, mesh, axis_name)[:b]

    return call
