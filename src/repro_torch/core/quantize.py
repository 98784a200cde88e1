"""Discrete phase-shifter quantization (paper Sec. III, Table I).

The prototype's phase shifters are two SP6T switch-selected line lengths:
each shifter realizes one of six discrete phases (Table I), so a cell has
36 states.  :class:`STEQuantize` is the straight-through estimator:
forward = nearest codebook value, backward = identity.

``uniform_codebook`` supports beyond-paper resolution studies.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.cell import TABLE_I_PHASES_RAD

PHASE_KEYS = ("theta", "phi", "alpha", "alpha_in")


def table_i_codebook(device=None) -> torch.Tensor:
    """The six measured line phases of the prototype (radians)."""
    return torch.as_tensor(TABLE_I_PHASES_RAD, dtype=torch.float32,
                           device=device)


def uniform_codebook(bits: int, lo: float = 0.0, hi: float = 2 * math.pi,
                     device=None) -> torch.Tensor:
    """2**bits uniformly spaced phases in [lo, hi), computed in float32 as
    ``lo (1 - i / k) + hi (i / k)`` (the JAX package's ``jnp.linspace``
    arithmetic, so both packages snap to the same float32 phases)."""
    k = 2**bits
    step = torch.arange(k, dtype=torch.float32) / k
    lo32, hi32 = (torch.tensor(v, dtype=torch.float32) for v in (lo, hi))
    return (lo32 * (1 - step) + hi32 * step).to(device)


def nearest_code(phase: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Index of the nearest codebook entry (circular distance on phases).

    ``torch.remainder`` (floor-mod, sign of the divisor), not ``fmod``:
    negative phase differences must wrap into [0, 2 pi).
    """
    d = phase[..., None] - codebook
    d = (torch.remainder(d + math.pi, 2 * math.pi) - math.pi).abs()
    return torch.argmin(d, dim=-1).to(torch.int32)


def codes_to_phase(codes: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    return codebook[codes.long()]


class STEQuantize(torch.autograd.Function):
    """Nearest-codebook quantization with straight-through gradients."""

    @staticmethod
    def forward(ctx, phase, codebook):
        return codes_to_phase(nearest_code(phase, codebook), codebook)

    @staticmethod
    def backward(ctx, g):
        return g, None


def ste_quantize(phase: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    return STEQuantize.apply(phase, codebook.to(phase.device))


def quantize_mesh_params(params: dict, codebook: torch.Tensor, *,
                         ste: bool = True) -> dict:
    """Quantize the phase entries (theta/phi/alpha*) of a mesh param dict."""
    def fn(p):
        if ste:
            return ste_quantize(p, codebook)
        cb = codebook.to(p.device)
        return codes_to_phase(nearest_code(p, cb), cb)

    return {k: fn(v) if k in PHASE_KEYS else v for k, v in params.items()}


def mesh_params_to_codes(params: dict, codebook: torch.Tensor) -> dict:
    """Project continuous mesh phases onto integer state codes (device view)."""
    return {k: nearest_code(v, codebook.to(v.device))
            for k, v in params.items() if k in PHASE_KEYS}


def codes_to_mesh_params(codes: dict, codebook: torch.Tensor) -> dict:
    """Device view back to phase values."""
    return {k: codes_to_phase(v, codebook.to(v.device))
            for k, v in codes.items()}
