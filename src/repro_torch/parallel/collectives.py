"""Collectives over one axis of a ``DeviceMesh``, and their autograd forms.

The JAX package is single-controller: one program holds a global array and
``shard_map`` hands each device its block.  The port is multi-controller:
every rank of an initialised ``torch.distributed`` process group runs the
same program, and a ``torch.distributed.device_mesh.DeviceMesh`` with
``mesh_dim_names`` stands where the JAX package's ``jax.sharding.Mesh``
does.  The port's ``mesh=`` entry points take the full (replicated) input
on every rank and return the full output on every rank.

The autograd forms keep **the replicated convention**: a cotangent that
reaches a replicated value is already the same on every rank.

  * :func:`scatter` (replicated -> this rank's block) is a slice forward
    and an all-gather backward, so the input's gradient comes back whole;
  * :func:`gather` (blocks -> replicated) is an all-gather forward and a
    slice backward: each rank keeps its own block of the cotangent.
    ``torch.distributed.nn.functional.all_gather`` reduce-scatters
    instead, which would hand back the gradient multiplied by the axis
    size;
  * :func:`replicate` (a replicated value entering per-rank work) is the
    identity forward and an all-reduce backward, which sums the ranks'
    partial gradients.

Backends: NCCL runs every op on CUDA tensors; gloo runs the all-reduce,
all-gather and broadcast on CUDA tensors but not the point-to-point ops,
which this module copies through host memory.  The choice is made from the
group's backend for the tensor's device (:func:`runs_in_place`), never by
catching an error.  ``IN_PLACE`` and ``HOST_STAGED`` count the collectives
that ran on CUDA tensors as they are and those staged through the host.

DTensor redistributes through torch's functional collectives
(``_c10d_functional``), which hang on gloo's CUDA path (torch 2.11,
measured on the card, while the ordinary collectives run);
:func:`route_functional_collectives` re-registers their CUDA kernels to run
the ordinary collective the same way, counted here.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

#: The ops each backend runs on CUDA tensors as they are; any other op on a
#: CUDA tensor goes through host memory.
CUDA_OPS = {"nccl": frozenset({"all_reduce", "all_gather", "broadcast",
                               "p2p", "all_gather_into_tensor",
                               "reduce_scatter", "all_to_all"}),
            "gloo": frozenset({"all_reduce", "all_gather", "broadcast",
                               "all_gather_into_tensor", "reduce_scatter",
                               "all_to_all"})}

#: Collectives run on CUDA tensors as they are, and staged through host
#: memory, by op.
IN_PLACE: dict[str, int] = {}
HOST_STAGED: dict[str, int] = {}


def axis_names(mesh) -> tuple:
    """The mesh's axis names (none for an object that is no named
    ``DeviceMesh``)."""
    return tuple(getattr(mesh, "mesh_dim_names", None) or ())


def require_axes(mesh, *axes: str) -> None:
    """Raise ``ValueError`` unless ``mesh`` names every one of ``axes``."""
    names = axis_names(mesh)
    for ax in axes:
        if ax not in names:
            raise ValueError(f"mesh has no axis {ax!r}: axes {names}")


def axis_size(mesh, axis: str) -> int:
    return int(mesh.shape[axis_names(mesh).index(axis)])


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return int(mesh.get_local_rank(axis))


def axis_group(mesh, axis: str):
    return mesh.get_group(axis)


def _cuda_backend(group) -> str | None:
    """The backend that serves CUDA tensors in ``group`` (``None`` when
    none does); ``get_backend_config`` reads ``"cpu:gloo,cuda:gloo"`` or
    a bare ``"nccl"``."""
    config = dist.get_backend_config(group)
    if ":" not in config:
        return config
    return dict(part.split(":", 1) for part in config.split(",")).get("cuda")


def runs_in_place(op: str, t: torch.Tensor, group) -> bool:
    """Whether ``op`` runs on ``t`` as it is in ``group``: always for a CPU
    tensor; for a CUDA tensor when the group's CUDA backend lists ``op`` in
    :data:`CUDA_OPS`."""
    if t.device.type != "cuda":
        return True
    return op in CUDA_OPS.get(_cuda_backend(group), frozenset())


def _staged(op: str, t: torch.Tensor, group) -> tuple[torch.Tensor, bool]:
    """``t`` as the backend takes it for ``op`` (real, contiguous, and on
    the host when the backend does not run ``op`` on the card), and whether
    it was copied to the host."""
    work = torch.view_as_real(t) if t.is_complex() else t
    work = work.contiguous()
    if t.device.type == "cuda":
        in_place = runs_in_place(op, t, group)
        counts = IN_PLACE if in_place else HOST_STAGED
        counts[op] = counts.get(op, 0) + 1
        if not in_place:
            return work.cpu(), True
    return work, False


def _restore(work: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    work = work.to(like.device)
    return torch.view_as_complex(work) if like.is_complex() else work


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``, as a new tensor on every rank."""
    work, copied = _staged("all_reduce", t, group)
    if not copied:
        work = work.clone()
    dist.all_reduce(work, group=group)
    return _restore(work, t)


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` in group-rank order;
    every rank's ``t`` has the same shape."""
    work, _ = _staged("all_gather", t, group)
    parts = [torch.empty_like(work)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, work, group=group)
    return torch.cat([_restore(p, t) for p in parts], dim=dim)


def broadcast(t: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """Group rank ``src``'s ``t`` on every rank of ``group``."""
    work, copied = _staged("broadcast", t, group)
    if not copied:
        work = work.clone()
    dist.broadcast(work, group=group, group_src=src)
    return _restore(work, t)


def ring_shift(t: torch.Tensor, group) -> torch.Tensor:
    """Each rank's ``t`` sent to the next group rank, the previous one's
    received (JAX's ``ppermute`` over ``i -> i + 1 mod n``)."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    me = dist.get_rank(group)
    work, _ = _staged("p2p", t, group)
    got = torch.empty_like(work)
    ops = [dist.P2POp(dist.isend, work, dist.get_global_rank(group,
                                                             (me + 1) % n),
                      group),
           dist.P2POp(dist.irecv, got, dist.get_global_rank(group,
                                                            (me - 1) % n),
                      group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return _restore(got, t)


# ---------------------------------------------------------------------------
# DTensor's functional collectives on gloo's CUDA path
# ---------------------------------------------------------------------------

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "avg": dist.ReduceOp.AVG,
               "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
               "product": dist.ReduceOp.PRODUCT}
_ROUTED: list = []
_LIBS: list = []

#: Calls of the routed functional collectives, by op.
FUNCTIONAL: dict[str, int] = {}


def _count(op: str) -> None:
    FUNCTIONAL[op] = FUNCTIONAL.get(op, 0) + 1


def _group(name: str):
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(name)


def _reduce_op(name: str):
    return _REDUCE_OPS[name.lower()]


def _f_all_reduce(t, reduce_op, group_name):
    _count("all_reduce")
    group = _group(group_name)
    work, copied = _staged("all_reduce", t, group)
    if not copied:
        work = work.clone()
    dist.all_reduce(work, op=_reduce_op(reduce_op), group=group)
    return _restore(work, t)


def _f_all_gather(t, group_size, group_name):
    _count("all_gather_into_tensor")
    group = _group(group_name)
    work, _ = _staged("all_gather_into_tensor", t, group)
    out = work.new_empty((group_size * work.shape[0],) + work.shape[1:])
    dist.all_gather_into_tensor(out, work, group=group)
    return _restore(out, t)


def _f_reduce_scatter(t, reduce_op, group_size, group_name):
    _count("reduce_scatter")
    group = _group(group_name)
    work, _ = _staged("reduce_scatter", t, group)
    out = work.new_empty((work.shape[0] // group_size,) + work.shape[1:])
    dist.reduce_scatter_tensor(out, work, op=_reduce_op(reduce_op),
                               group=group)
    return _restore(out, t)


def _f_all_to_all(t, output_split_sizes, input_split_sizes, group_name):
    _count("all_to_all")
    group = _group(group_name)
    work, _ = _staged("all_to_all", t, group)
    rows = (sum(output_split_sizes) if output_split_sizes
            else work.shape[0])
    out = work.new_empty((rows,) + work.shape[1:])
    dist.all_to_all_single(out, work, output_split_sizes or None,
                           input_split_sizes or None, group=group)
    return _restore(out, t)


def _f_broadcast(t, src, group_name):
    _count("broadcast")
    group = _group(group_name)
    work, copied = _staged("broadcast", t, group)
    if not copied:
        work = work.clone()
    dist.broadcast(work, src=src, group=group)
    return _restore(work, t)


def route_functional_collectives(key: str = "CUDA") -> None:
    """Run the CUDA kernels of ``_c10d_functional``'s ``all_reduce``,
    ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
    ``all_to_all_single`` and ``broadcast`` (what DTensor's redistributions
    issue) as the ordinary collectives of this module, synchronously: on
    the card where the group's CUDA backend runs the op
    (:data:`CUDA_OPS`), through host memory otherwise, each counted in
    :data:`IN_PLACE` or :data:`HOST_STAGED`.  For a process whose CUDA
    tensors are served by gloo; idempotent.  ``key="CPU"`` routes the CPU
    kernels the same way (the CPU tests' check of these kernels)."""
    if key in _ROUTED:
        return
    lib = torch.library.Library("_c10d_functional", "IMPL")
    for name, fn in (("all_reduce", _f_all_reduce),
                     ("all_gather_into_tensor", _f_all_gather),
                     ("reduce_scatter_tensor", _f_reduce_scatter),
                     ("all_to_all_single", _f_all_to_all),
                     ("broadcast", _f_broadcast)):
        lib.impl(name, fn, key)
    _ROUTED.append(key)
    _LIBS.append(lib)


# ---------------------------------------------------------------------------
# autograd forms, with the replicated convention
# ---------------------------------------------------------------------------

def _block(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    size = t.shape[dim]
    if size % n:
        raise ValueError(f"dim {dim} of size {size} does not split over "
                         f"{n} ranks")
    k = size // n
    return t.narrow(dim, dist.get_rank(group) * k, k)


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _block(x, group, dim).clone()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.group, ctx.dim).contiguous(), None, None


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


def scatter(x: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """This rank's block of the replicated ``x`` along ``dim`` (which must
    split evenly over ``axis``); its gradient comes back whole."""
    return _Scatter.apply(x, axis_group(mesh, axis), dim)


def gather(x: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The ranks' blocks along ``dim`` joined into the replicated whole; each
    rank's gradient is its block of the replicated cotangent."""
    return _Gather.apply(x, axis_group(mesh, axis), dim)


def replicate(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``x`` itself, whose gradient is summed over ``axis``: a replicated
    value that each rank uses on its own block of the work."""
    return _Replicate.apply(x, axis_group(mesh, axis))


def pad_rows(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """``x`` with zero rows appended up to a multiple of ``multiple`` on
    its leading axis (differentiable)."""
    pad = (-x.shape[0]) % multiple
    if not pad:
        return x
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
