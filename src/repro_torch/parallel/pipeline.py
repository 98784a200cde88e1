"""Pipeline parallelism: a GPipe microbatch pipeline over a mesh axis, the
counterpart of the JAX package's ``repro.parallel.pipeline``.

The layer stack splits over the ``axis`` ranks (stage ``s`` holds
``stage_params[s]``); microbatches flow stage to stage as a ring of
``batch_isend_irecv`` (the JAX package's ``ppermute``), and at the end the
last stage's outputs are summed over the axis (its ``psum``), so every rank
returns them.

Schedule: GPipe fill-drain over M microbatches and S stages (bubble
fraction (S-1)/(M+S-1)); each tick every stage runs its layer group on its
current microbatch, then activations move one stage down.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils import _pytree as pytree

from repro_torch.parallel import collectives as coll


def pipeline_forward(block_fn: Callable, mesh, axis: str, stage_params,
                     x_microbatches: torch.Tensor) -> torch.Tensor:
    """Run a GPipe forward over ``mesh``'s ``axis``.

    ``block_fn(params, x) -> x``: one stage's layer group, its output shaped
    and typed as its input.  ``stage_params``: a pytree whose leaves have a
    leading stage axis, the same on every rank.  ``x_microbatches``: ``[M,
    mb, ...]``, the same on every rank.  Returns the ``[M, mb, ...]``
    outputs after all stages, on every rank.  Forward only: no gradient
    crosses a stage boundary.
    """
    coll.require_axes(mesh, axis)
    n_stages = coll.axis_size(mesh, axis)
    stage = coll.axis_index(mesh, axis)
    group = coll.axis_group(mesh, axis)
    m = x_microbatches.shape[0]
    n_ticks = m + n_stages - 1
    params = pytree.tree_map(lambda p: p[stage], stage_params)
    buf = torch.zeros_like(x_microbatches[0])   # this stage's activation
    outs = torch.zeros_like(x_microbatches)
    for t in range(n_ticks):
        if stage == 0:                          # stage 0 takes microbatch t
            buf = x_microbatches[min(t, m - 1)]
        buf = block_fn(params, buf)
        if stage == n_stages - 1 and t >= n_stages - 1:
            outs[t - (n_stages - 1)] = buf      # the last stage retires one
        if t < n_ticks - 1:
            buf = coll.ring_shift(buf, group)   # activations move downstream
    if stage != n_stages - 1:
        outs.zero_()
    return coll.all_reduce(outs, group)


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)
