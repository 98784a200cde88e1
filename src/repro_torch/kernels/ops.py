"""Public wrappers around the mesh kernels.

``mesh_apply`` and ``mesh_apply_cells`` build the ``[C', 8, P]``
coefficients (ideal cells, or the hardware model with optional phase
noise), apply the optional ``alpha_in``/``alpha`` phase screens as plain
PyTorch, and run the column sweep through
:func:`repro_torch.kernels.givens_mesh.mesh_forward`: the CUDA kernel on a
CUDA tensor, its plain version on a CPU tensor.

Both are differentiable with respect to the params (or ``t_all``), the
screens and ``x``: the sweep's backward is kernel B2 on a CUDA tensor and
its plain version on a CPU tensor, and autograd carries the gradient
through the coefficient build and the screens around it.

``rfnn_linear`` is the fused analog linear layer ``|scale * U D V x|``
(paper Eq. 31) over kernels B3/B4 (forward) and B5 (backward): the phase
screens fold into the gains around the kernel, and autograd carries the
gains gradient back into the attenuation and the scale.

The JAX package's ``_auto_block``/``_pad_batch`` sized batch blocks for the
TPU's VMEM; the CUDA kernel masks the ragged last tile itself, so there is
no ``block_b`` argument here.
"""

from __future__ import annotations

import torch

from repro_torch.core import hardware as hw_lib
from repro_torch.core import mesh as mesh_lib
from repro_torch.core.cell import as_complex, cell_matrix, expj
from repro_torch.kernels import givens_mesh
from repro_torch.kernels.schedule import (
    MeshSchedule,
    clements_schedule,
    pack_cells,
    parity_array,
    schedule_from_plan,
)

#: Per-entry-point invocation counts of the kernel path (proof that a
#: configuration went through ``mesh_forward``).
KERNEL_PATH_CALLS = {"mesh_apply": 0, "mesh_apply_cells": 0, "rfnn_linear": 0}


def _mesh_coefficients(sched: MeshSchedule, params: dict,
                       hardware: hw_lib.HardwareModel | None,
                       generator: torch.Generator | None) -> torch.Tensor:
    """Packed [C', 8, P] coefficients from mesh params.

    With a hardware model, cells come from ``imperfect_cell_matrix`` — the
    same function (and the same generator draws) as the reference
    ``apply_mesh_hw`` path.
    """
    theta, phi = params["theta"], params["phi"]
    if hardware is None:
        t_all = cell_matrix(theta, phi)
    else:
        t_all = hw_lib.imperfect_cell_matrix(theta, phi, hardware, generator)
    return pack_cells(sched, t_all)


def _sweep(sched: MeshSchedule, coef: torch.Tensor, x: torch.Tensor,
           alpha_in, alpha) -> torch.Tensor:
    batch_shape = x.shape[:-1]
    if x.shape[-1] != sched.n:
        raise ValueError(f"expected trailing dim {sched.n}, got {tuple(x.shape)}")
    x2 = mesh_lib.apply_screens(as_complex(x).reshape(-1, sched.n), alpha_in)
    y = givens_mesh.mesh_forward(coef, parity_array(sched, x2.device),
                                 x2.contiguous())
    y = mesh_lib.apply_screens(y, alpha)
    return y.reshape(batch_shape + (sched.n,))


def mesh_apply(params: dict, x: torch.Tensor, *, n: int,
               plan: mesh_lib.MeshPlan | None = None,
               hardware: hw_lib.HardwareModel | None = None,
               generator: torch.Generator | None = None) -> torch.Tensor:
    """Apply a mesh to ``x[..., n]`` through the kernel path.

    Semantics match ``repro_torch.core.mesh.apply_mesh`` on the given plan
    (``None`` = the Clements rectangle), including the optional phase
    screens ``alpha_in`` / ``alpha``; with ``hardware`` they match
    ``repro_torch.core.hardware.apply_mesh_hw`` (imperfect hybrids, per-cell
    insertion loss, and ``generator``-sampled phase-shifter noise).
    """
    sched = clements_schedule(n) if plan is None else schedule_from_plan(plan)
    KERNEL_PATH_CALLS["mesh_apply"] += 1
    coef = _mesh_coefficients(sched, params, hardware, generator)
    return _sweep(sched, coef, x, params.get("alpha_in"), params.get("alpha"))


def mesh_apply_cells(t_all: torch.Tensor, x: torch.Tensor, *,
                     plan: mesh_lib.MeshPlan,
                     alpha_in: torch.Tensor | None = None,
                     alpha: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel mesh apply from explicit per-cell 2x2 matrices ``[C, P, 2, 2]``.

    The cells-level entry point: callers that build transfer matrices
    directly (e.g. from noise draws made elsewhere) hit the same sweep
    without going through (theta, phi).
    """
    sched = schedule_from_plan(plan)
    KERNEL_PATH_CALLS["mesh_apply_cells"] += 1
    return _sweep(sched, pack_cells(sched, t_all), x, alpha_in, alpha)


def _gains(atten, scale, v_params: dict, u_params: dict, n: int,
           device) -> torch.Tensor:
    """The kernel's float32 ``[8, P]`` gains: g1 = atten with V's output
    screen and U's input screen folded in (rows 0-3), g2 = scale with U's
    output screen (rows 4-7); even re, even im, odd re, odd im.  All are
    diagonal, so they commute with each other."""
    g1 = torch.as_tensor(atten, device=device).to(torch.complex64)
    for alpha in (v_params.get("alpha"), u_params.get("alpha_in")):
        if alpha is not None:
            g1 = g1 * expj(alpha)
    g2 = torch.as_tensor(scale, dtype=torch.float32, device=device) \
        .expand(n).to(torch.complex64)
    if u_params.get("alpha") is not None:
        g2 = g2 * expj(u_params["alpha"])
    return torch.stack([part for g in (g1, g2) for h in (g[0::2], g[1::2])
                        for part in (h.real, h.imag)]).to(torch.float32)


def rfnn_linear(v_params: dict, atten, u_params: dict, x: torch.Tensor, *,
                n: int, scale=1.0, v_plan: mesh_lib.MeshPlan | None = None,
                u_plan: mesh_lib.MeshPlan | None = None,
                hardware: hw_lib.HardwareModel | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
    """Fused analog linear layer ``|scale * U (D (V x))|`` through the
    kernel path; the counterpart of the JAX package's ``ops.rfnn_linear``.

    ``atten``: [n] attenuation (the paper's diagonal D / sigma_max);
    ``scale``: the digital gamma.  Returns the detected magnitude
    ``[..., n]`` (float32); ``hardware.detect_magnitude`` composes on top for
    the detector's noise and floor.  ``v_plan``/``u_plan`` default to the
    Clements rectangle; Reck programs (more columns) run in the same fused
    sweep.  With ``hardware`` the cells come from the imperfection model,
    V's phase noise and then U's drawn from ``generator``.  V's input screen
    ``alpha_in`` applies before the kernel; the other screens fold into the
    gains.  Differentiable in both meshes' params, ``atten``, ``scale`` and
    ``x``.
    """
    sched_v = clements_schedule(n) if v_plan is None else schedule_from_plan(v_plan)
    sched_u = clements_schedule(n) if u_plan is None else schedule_from_plan(u_plan)
    KERNEL_PATH_CALLS["rfnn_linear"] += 1
    batch_shape = x.shape[:-1]
    if x.shape[-1] != n:
        raise ValueError(f"expected trailing dim {n}, got {tuple(x.shape)}")
    x2 = mesh_lib.apply_screens(as_complex(x).reshape(-1, n),
                                v_params.get("alpha_in"))
    coef_v = _mesh_coefficients(sched_v, v_params, hardware, generator)
    coef_u = _mesh_coefficients(sched_u, u_params, hardware, generator)
    gains = _gains(atten, scale, v_params, u_params, n, x2.device)
    out = givens_mesh.rfnn_forward(
        coef_v, parity_array(sched_v, x2.device), coef_u,
        parity_array(sched_u, x2.device), gains, x2.contiguous())
    return out.reshape(batch_shape + (n,))
