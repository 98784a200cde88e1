"""AdamW with bias correction, global-norm clipping and optional bf16
gradient compression: the counterpart of the JAX package's
``repro.optim.adamw``.

It is functional, like the JAX optimizer: ``update(params, grads, state)``
returns new params and a new state and changes none of its inputs.  Params
are nested dicts of tensors (any tree ``torch.utils._pytree`` flattens);
the moments live on the params' devices, in ``moment_dtype``.
:meth:`AdamW.state_specs` gives the moments the params' logical specs
(ZeRO-style inherited layouts) and the step count none.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree


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
        g_leaves = [g.to(torch.float32) for g in pytree.tree_leaves(grads)]
        m_leaves, v_leaves = (pytree.tree_leaves(state.m),
                              pytree.tree_leaves(state.v))
        if not (len(g_leaves) == len(m_leaves) == len(v_leaves)
                == len(p_leaves)):
            raise ValueError("params, grads and optimizer state differ in "
                             "structure")
        step = state.step + 1
        if self.clip_norm > 0:
            gsq = torch.zeros((), dtype=torch.float32, device=step.device)
            for g in g_leaves:
                gsq = gsq + (g * g).sum()
            gnorm = torch.sqrt(gsq)
            scale = torch.clamp(self.clip_norm / torch.clamp_min(gnorm, 1e-9),
                                max=1.0)
            g_leaves = [g * scale for g in g_leaves]
        else:
            gnorm = torch.zeros((), dtype=torch.float32, device=step.device)

        lr = self.lr(step) if callable(self.lr) else self.lr
        b1, b2 = self.b1, self.b2
        stepf = step.to(torch.float32)
        bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                           device=step.device), stepf)
        bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                           device=step.device), stepf)
        new_p, new_m, new_v = [], [], []
        for p, g, m, v in zip(p_leaves, g_leaves, m_leaves, v_leaves):
            mf = m.to(torch.float32) * b1 + (1 - b1) * g
            vf = v.to(torch.float32) * b2 + (1 - b2) * g * g
            delta = (mf / bc1) / (torch.sqrt(vf / bc2) + self.eps)
            if self.weight_decay:
                delta = delta + self.weight_decay * p.to(torch.float32)
            new_p.append((p.to(torch.float32) - lr * delta).to(p.dtype))
            new_m.append(mf.to(self.moment_dtype))
            new_v.append(vf.to(self.moment_dtype))
        unflat = lambda leaves: pytree.tree_unflatten(leaves, spec)  # noqa: E731
        return (unflat(new_p), OptState(step=step, m=unflat(new_m),
                                        v=unflat(new_v)), gnorm)
