"""Discrete Simultaneous Perturbation Stochastic Approximation (DSPSA).

The paper's Algorithm I optimizes the *device biasing states*, integer
switch codes selecting one of the six Table-I lines per shifter, with DSPSA
(Wang & Spall 2011, ref [44]) while digital parameters use SGD.  DSPSA needs
only two loss evaluations per step regardless of dimension, which matches a
physical device where each evaluation is one hardware measurement pass.

State layout: a tree (dicts of tensors) of int32 codes plus a
float "virtual" mirror (the algorithm's continuous iterate); the device
always sees the rounded projection.  The Rademacher perturbations come from
an explicit CPU ``torch.Generator`` (:func:`draw_deltas`);
:func:`step_with_deltas` takes them as given, so a caller can feed the
draws of another generator.  Each ``loss_fn`` evaluation is one pure
forward pass, through the mesh kernel on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch.utils import _pytree as pytree


@dataclasses.dataclass
class DSPSAConfig:
    a: float = 0.6          # gain numerator
    big_a: float = 10.0     # stability constant A
    alpha: float = 0.602    # gain decay exponent (Spall's recommended value)
    n_states: int = 6       # codebook size (Table I -> 6)


@dataclasses.dataclass
class DSPSAState:
    virtual: dict           # float32 tree, the continuous iterate
    step: int = 0


def init(codes) -> DSPSAState:
    return DSPSAState(virtual=pytree.tree_map(
        lambda c: torch.as_tensor(c).to(torch.float32), codes), step=0)


def project(state: DSPSAState, cfg: DSPSAConfig):
    """Integer device codes from the virtual iterate."""
    return pytree.tree_map(lambda v: torch.clamp(torch.round(v), 0,
                                                 cfg.n_states - 1).to(torch.int32),
                           state.virtual)


def draw_deltas(generator: torch.Generator, state: DSPSAState):
    """Rademacher (+-1) perturbations shaped like the iterate, drawn on the
    CPU from ``generator`` leaf by leaf and moved to each leaf's device."""
    return pytree.tree_map(
        lambda v: (torch.randint(0, 2, v.shape, generator=generator) * 2 - 1)
        .to(torch.float32).to(v.device), state.virtual)


def step_with_deltas(state: DSPSAState, deltas,
                     loss_fn: Callable[[dict], torch.Tensor],
                     cfg: DSPSAConfig) -> tuple[DSPSAState, torch.Tensor]:
    """One DSPSA update with the perturbations ``deltas`` given.

    The two-measurement form: evaluate at pi(x) +- Delta / 2 where pi is
    the floor + 1/2 lattice midpoint, and g_hat = (y+ - y-) / 2 * Delta
    (Delta_i^2 = 1).
    """
    mid = pytree.tree_map(lambda v: torch.floor(v) + 0.5, state.virtual)

    def codes_at(sign: float):
        return pytree.tree_map(
            lambda mv, d: torch.clamp(torch.round(mv + sign * 0.5 * d), 0,
                                      cfg.n_states - 1).to(torch.int32),
            mid, deltas)

    y_plus = loss_fn(codes_at(+1.0))
    y_minus = loss_fn(codes_at(-1.0))
    gain = cfg.a / (state.step + 1 + cfg.big_a) ** cfg.alpha
    diff = (y_plus - y_minus) / 2.0
    new_virtual = pytree.tree_map(
        lambda v, d: torch.clamp(v - gain * diff * d, -0.49,
                                 cfg.n_states - 0.51),
        state.virtual, deltas)
    return (DSPSAState(virtual=new_virtual, step=state.step + 1),
            torch.minimum(torch.as_tensor(y_plus), torch.as_tensor(y_minus)))


def step(generator: torch.Generator, state: DSPSAState,
         loss_fn: Callable[[dict], torch.Tensor],
         cfg: DSPSAConfig) -> tuple[DSPSAState, torch.Tensor]:
    """One DSPSA update.  ``loss_fn`` maps integer codes -> scalar loss."""
    return step_with_deltas(state, draw_deltas(generator, state), loss_fn, cfg)


def minimize(generator: torch.Generator, codes0, loss_fn, cfg: DSPSAConfig,
             steps: int, *, measure_projection: bool = True):
    """Run DSPSA for ``steps`` iterations; returns (best codes, history).

    ``measure_projection=True`` (default) spends a third measurement per
    step evaluating the projected iterate, tracking the best codes seen.
    ``False`` is the paper-strict two-measurements-per-step budget: the
    history then records ``min(y+, y-)`` and the final projection is
    returned.
    """
    state = init(codes0)
    best_codes = project(state, cfg)
    if measure_projection:
        best_loss = float(loss_fn(best_codes))
        hist = [best_loss]
    else:
        hist = []
    for _ in range(steps):
        state, y_min = step(generator, state, loss_fn, cfg)
        if measure_projection:
            cand = project(state, cfg)
            loss = float(loss_fn(cand))
            hist.append(loss)
            if loss < best_loss:
                best_loss, best_codes = loss, cand
        else:
            hist.append(float(y_min))
    if not measure_projection:
        best_codes = project(state, cfg)
    return best_codes, hist
