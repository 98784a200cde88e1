"""The minibatch-SGD step shared by the paper pipelines.

:func:`make_sgd_step` is the counterpart of the JAX package's
``repro.train.step.make_sgd_step`` (without its ``mesh=`` data-parallel
form).  It is functional like the JAX step: params in, new params out.
Gradients flow through whatever backend the model's layers select; with
the analog layers' ``backend="kernel"`` on CUDA tensors the backward of
every mesh runs the CUDA kernel B2, so training and inference share one
hot loop.
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree


def make_sgd_step(loss_fn, lr: float, freeze: tuple[str, ...] = ()):
    """Plain minibatch SGD: ``step(params, *batch) -> (params, (loss, aux))``.

    ``loss_fn(params, *batch) -> (loss, aux)``.  Top-level param groups
    named in ``freeze`` get zero gradients and keep their values exactly
    (the paper's stage-2 "deployed device" training, where the programmed
    mesh codes are held fixed).  Their gradients are not computed; the
    gradients of everything upstream still flow through them.  ``loss`` and
    ``aux`` come back as detached tensors, so a step does not wait for the
    card.
    """

    def step(params: dict, *batch):
        live = {k: pytree.tree_map(
                    lambda t: t.detach().requires_grad_(k not in freeze), v)
                for k, v in params.items()}
        leaves, spec = pytree.tree_flatten(live)
        trained = [t for t in leaves if t.requires_grad]
        with torch.enable_grad():
            loss, aux = loss_fn(live, *batch)
            grads = iter(torch.autograd.grad(loss, trained, allow_unused=True))
        new = []
        with torch.no_grad():
            for t in leaves:
                g = next(grads) if t.requires_grad else None
                new.append(t.detach() if g is None else t - lr * g)
        return pytree.tree_unflatten(new, spec), (loss.detach(), aux.detach())

    return step
