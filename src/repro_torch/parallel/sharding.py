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

Annotating tensors with these specs under an active mesh (the JAX
package's ``constrain``) belongs to the LM's multi-device half (ROADMAP
A11); here the rules feed :func:`logical_spec` alone.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch
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


@contextlib.contextmanager
def use_mesh_and_rules(mesh, rules: ShardingRules):
    """Install ``mesh`` (a ``DeviceMesh``) and ``rules`` for the enclosed
    block, on this thread."""
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh, _CTX.rules = mesh, rules
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def set_rules(rules: ShardingRules) -> None:
    _CTX.rules = rules


def active_mesh():
    return _CTX.mesh


def logical_spec(*names: str | None) -> tuple:
    """The installed rules' spec of ``names``; all ``None`` without
    rules."""
    rules = _CTX.rules
    if rules is None:
        return (None,) * len(names)
    return rules.spec(*names)


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
