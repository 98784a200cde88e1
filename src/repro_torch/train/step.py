"""Training steps: the LM train step and the paper pipelines' SGD step.

The counterpart of the JAX package's ``repro.train.step``.  Both steps are
functional like the JAX ones: state in, new state out, no input changed.

:func:`make_train_step` is the LM step: loss -> grads -> (compressed)
AdamW update, with microbatched gradient accumulation (``accum_steps``):
the global batch is split along axis 0 and the micro-batches' gradients
summed in float32 and divided by their count, as the JAX package's
``lax.scan`` body does, which divides activation memory by the
accumulation factor at the same global batch.  :func:`state_specs` is the
state's tree of logical axis names; with params, moments and batch given as
DTensors (``launch/specs.py`` lays them out) the step runs across the mesh
unchanged.

:func:`make_sgd_step` is the minibatch-SGD step shared by the paper
pipelines, with the JAX package's ``mesh=`` data-parallel form.

Gradients flow through whatever backend the model's layers select: with
the analog layers' ``backend="kernel"`` on CUDA tensors a mesh's backward
runs the CUDA kernel B2, a tile grid's B8 (the LM's ``linear_impl="rfnn"``
MLP through B7 and B8), so training and inference share one hot loop.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils import _pytree as pytree

from repro_torch.optim.adamw import AdamW, OptState
from repro_torch.parallel import collectives as coll
from repro_torch.runtime import trace


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: OptState


# a pytree node (paths ``.params[...]``, ``.opt.m[...]``): checkpoints
# flatten it
pytree.register_dataclass(TrainState)


def init_state(model, optimizer: AdamW, generator: torch.Generator, *,
               device=None) -> TrainState:
    """``model.init`` params drawn from ``generator`` on ``device`` (CUDA
    when None) and a fresh optimizer state beside them."""
    params = model.init(generator, device=device)
    return TrainState(params=params, opt=optimizer.init(params))


def state_specs(model, optimizer: AdamW) -> TrainState:
    pspecs = model.param_specs()
    return TrainState(params=pspecs, opt=optimizer.state_specs(pspecs))


def loss_and_grads(loss_fn, params, batch):
    """(grads, loss, metrics) of ``loss_fn(params, batch) -> (loss,
    metrics)``, all detached; a leaf the loss does not reach gets a zero
    gradient, as ``jax.grad`` gives it."""
    leaves, spec = pytree.tree_flatten(params)
    live = [t.detach().requires_grad_(True) for t in leaves]
    with torch.enable_grad():
        with trace.span("train.forward"):
            loss, metrics = loss_fn(pytree.tree_unflatten(live, spec), batch)
        with trace.span("train.backward"):
            grads = torch.autograd.grad(loss, live, allow_unused=True)
            grads = [torch.zeros_like(t) if g is None else g
                     for t, g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return pytree.tree_unflatten(grads, spec), loss.detach(), metrics


def make_train_step(model, optimizer: AdamW, accum_steps: int = 1):
    """Build ``train_step(state, batch) -> (state, metrics)``.

    ``batch`` is a dict of tensors whose axis 0 is the batch.  ``metrics``
    holds the model's loss metrics (``ce``, ``acc``, ``moe_aux``; without
    accumulation only, as in the JAX package) and ``loss``, ``grad_norm``
    (the global float32 norm before clipping) and ``step``, all detached.
    """
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

    def train_step(state: TrainState, batch: dict):
        with trace.span("train.step"):
            params = state.params
            if accum_steps == 1:
                grads, loss, metrics = loss_and_grads(model.loss, params,
                                                      batch)
                grads = optimizer.compress_grads(grads)
            else:
                b = next(iter(batch.values())).shape[0]
                if b % accum_steps:
                    raise ValueError(f"batch {b} does not split into "
                                     f"{accum_steps} micro-batches")
                mb = b // accum_steps
                gsum = pytree.tree_map(
                    lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
                loss = torch.zeros((), dtype=torch.float32,
                                   device=pytree.tree_leaves(params)[0].device)
                for i in range(accum_steps):
                    micro = {k: v[i * mb:(i + 1) * mb]
                             for k, v in batch.items()}
                    grads, micro_loss, _ = loss_and_grads(model.loss, params,
                                                          micro)
                    grads = optimizer.compress_grads(grads)
                    gsum = pytree.tree_map(lambda a, g: a + g.float(), gsum,
                                           grads)
                    loss = loss + micro_loss
                grads = pytree.tree_map(lambda g: g / accum_steps, gsum)
                loss = loss / accum_steps
                metrics = {}
            with trace.span("train.optimizer"):
                new_params, new_opt, gnorm = optimizer.update(params, grads,
                                                              state.opt)
            metrics = dict(metrics)
            metrics.update({"loss": loss, "grad_norm": gnorm,
                            "step": new_opt.step})
            return TrainState(params=new_params, opt=new_opt), metrics

    return train_step


def make_sgd_step(loss_fn, lr: float, freeze: tuple[str, ...] = (),
                  mesh=None, data_axis: str = "data",
                  replicated_args: tuple[int, ...] = ()):
    """Plain minibatch SGD: ``step(params, *batch) -> (params, (loss, aux))``.

    ``loss_fn(params, *batch) -> (loss, aux)``.  Top-level param groups
    named in ``freeze`` get zero gradients and keep their values exactly
    (the paper's stage-2 "deployed device" training, where the programmed
    mesh codes are held fixed).  Their gradients are not computed; the
    gradients of everything upstream still flow through them.  ``loss`` and
    ``aux`` come back as detached tensors, so a step does not wait for the
    card.

    With ``mesh`` (a ``DeviceMesh``) the step is data-parallel over its
    ``data_axis``: every rank passes the same params and the same whole
    batch, computes loss, aux and gradients on its block of each batch
    argument's leading axis (which must divide by the axis size), averages
    all three over the axis, and applies the same update, so the returned
    params are the same on every rank.  Batch arguments whose leading axis
    is not the batch are named in ``replicated_args`` by position and not
    split.
    """
    if mesh is not None:
        coll.require_axes(mesh, data_axis)

    def shard(i, t):
        if i in replicated_args:
            return t
        n = coll.axis_size(mesh, data_axis)
        if t.shape[0] % n:
            raise ValueError(f"batch argument {i} of {t.shape[0]} rows does "
                             f"not split over {n} ranks on {data_axis!r}")
        k = t.shape[0] // n
        return t[coll.axis_index(mesh, data_axis) * k:][:k]

    def step(params: dict, *batch):
        if mesh is not None:
            batch = tuple(shard(i, t) for i, t in enumerate(batch))
        live = {k: pytree.tree_map(
                    lambda t: t.detach().requires_grad_(k not in freeze), v)
                for k, v in params.items()}
        leaves, spec = pytree.tree_flatten(live)
        trained = [t for t in leaves if t.requires_grad]
        with torch.enable_grad():
            loss, aux = loss_fn(live, *batch)
            grads = torch.autograd.grad(loss, trained, allow_unused=True)
        loss, aux = loss.detach(), aux.detach()
        if mesh is not None:
            group = coll.axis_group(mesh, data_axis)
            n = coll.axis_size(mesh, data_axis)

            def mean(t):
                return None if t is None else coll.all_reduce(t, group) / n

            loss, aux = mean(loss), mean(aux)
            grads = [mean(g) for g in grads]
        grads = iter(grads)
        new = []
        with torch.no_grad():
            for t in leaves:
                g = next(grads) if t.requires_grad else None
                new.append(t.detach() if g is None else t - lr * g)
        return pytree.tree_unflatten(new, spec), (loss, aux)

    return step
