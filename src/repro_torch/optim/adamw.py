"""AdamW with bias correction, global-norm clipping and optional bf16
gradient compression: the counterpart of the JAX package's
``repro.optim.adamw``.

It is functional, like the JAX optimizer: ``update(params, grads, state)``
returns new params and a new state and changes none of its inputs.  Params
are nested dicts of tensors (any tree ``torch.utils._pytree`` flattens);
the moments live on the params' devices, in ``moment_dtype``.
:meth:`AdamW.state_specs` gives the moments the params' logical specs
(ZeRO-style inherited layouts) and the step count none.

The arithmetic is :mod:`repro_torch.kernels.adamw_fused`'s: on plain CUDA
tensors the fused CUDA update (a norm pass and one update pass a leaf,
nothing waiting for the card), on the CPU and on DTensors (the sharded
training paths, whose global norm DTensor reduces across ranks) its plain
version, the separate tensor ops the JAX package's update is made of.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

from repro_torch.kernels import adamw_fused


@dataclasses.dataclass
class OptState:
    step: torch.Tensor   # int32 0-d
    m: Any
    v: Any


# a pytree node (paths ``.step``, ``.m[...]``, ``.v[...]``), as the JAX
# package registers its OptState: checkpoints and interop flatten it
pytree.register_dataclass(OptState)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float | Callable[[torch.Tensor], torch.Tensor] = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: float = 1.0
    moment_dtype: torch.dtype = torch.float32
    grad_compression: bool = False  # bf16 grads (halves collective bytes)

    def init(self, params) -> OptState:
        def zeros(p):
            return torch.zeros(p.shape, dtype=self.moment_dtype,
                               device=p.device)
        leaf = pytree.tree_leaves(params)
        device = leaf[0].device if leaf else None
        return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                        m=pytree.tree_map(zeros, params),
                        v=pytree.tree_map(zeros, params))

    def state_specs(self, param_specs) -> OptState:
        """Moment sharding = param sharding; the step count replicated."""
        return OptState(step=(), m=param_specs, v=param_specs)

    def compress_grads(self, grads):
        if not self.grad_compression:
            return grads
        return pytree.tree_map(lambda g: g.to(torch.bfloat16), grads)

    def update(self, params, grads, state: OptState):
        """``(new_params, new_state, grad_norm)``; the norm is the global
        float32 norm before clipping (0 when clipping is off)."""
        with torch.no_grad():
            return self._update(params, grads, state)

    def _update(self, params, grads, state: OptState):
        p_leaves, spec = pytree.tree_flatten(params)
        g_leaves = pytree.tree_leaves(grads)
        m_leaves, v_leaves = (pytree.tree_leaves(state.m),
                              pytree.tree_leaves(state.v))
        if not (len(g_leaves) == len(m_leaves) == len(v_leaves)
                == len(p_leaves)):
            raise ValueError("params, grads and optimizer state differ in "
                             "structure")
        step = state.step + 1
        lr = self.lr(step) if callable(self.lr) else self.lr
        new_p, new_m, new_v, gnorm = adamw_fused.update(
            self, p_leaves, g_leaves, m_leaves, v_leaves, step, lr)
        unflat = lambda leaves: pytree.tree_unflatten(leaves, spec)  # noqa: E731
        return (unflat(new_p), OptState(step=step, m=unflat(new_m),
                                        v=unflat(new_v)), gnorm)
