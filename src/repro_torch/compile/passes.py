"""Compiler passes over the :class:`AnalogProgram` IR (the ``synthesize``
and ``program`` subset): the counterpart of the JAX package's
``repro.compile.passes``.

* :func:`synthesize` — SVD-factor each digital weight matrix into
  ``U . D . V^H`` with the overall scale recovered digitally (Eq. 31).
* :func:`program` — fill in mesh plans/params for both unitary factors:
  analytically (:func:`repro_torch.core.decompose.reck_program`) or by the
  kernel-backed gradient fit (the paper's "stochastic optimization"
  programming, Sec. IV-B): identity probes swept through ``ops.mesh_apply``
  (kernels B1 and B2 on the card) under :class:`repro_torch.optim.AdamW`.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.compile.program import AnalogProgram, ProgramLayer
from repro_torch.core import decompose
from repro_torch.core import mesh as mesh_lib
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kernel_ops
from repro_torch.optim.adamw import AdamW


def _pad_even(k: int) -> int:
    return k + (k % 2)


def synthesize(matrices, *, n: int | None = None, device=None) -> AnalogProgram:
    """SVD-factor digital weight matrices into analog layer specs.

    ``matrices``: one ``[out, in]`` array or a sequence of them (a layer
    stack).  Every layer is zero-padded to a common even mesh size ``n``
    (default: the enclosing square of the largest layer).  The diagonal is
    normalized by the largest singular value (a passive network only
    attenuates) and the scale is recovered digitally (the paper's gamma,
    Fig. 11).  The attenuation and scale live on ``device`` (CUDA when
    None).
    """
    device = resolve_device(device)
    if not isinstance(matrices, (list, tuple)):
        matrices = [np.asarray(matrices)]
    elif matrices and np.ndim(matrices[0]) <= 1:
        matrices = [np.asarray(matrices)]   # one matrix as nested lists
    else:
        matrices = [np.asarray(m) for m in matrices]
    if not matrices:
        raise ValueError("need at least one matrix")
    if n is None:
        n = max(_pad_even(max(m.shape)) for m in matrices)
    if n < 2 or n % 2:
        raise ValueError(f"mesh size must be even and >= 2, got n={n}")
    layers = []
    for m in matrices:
        out_dim, in_dim = m.shape
        if max(out_dim, in_dim) > n:
            raise ValueError(f"matrix {m.shape} exceeds mesh size n={n}")
        mp = np.zeros((n, n), np.complex128)
        mp[:out_dim, :in_dim] = m
        u, s, vh = np.linalg.svd(mp)
        smax = float(s.max()) if s.max() > 0 else 1.0
        layers.append(ProgramLayer(
            n=n, out_dim=out_dim, in_dim=in_dim, target=m.copy(),
            target_u=u, target_vh=vh,
            attenuation=torch.as_tensor((s / smax).astype(np.float32),
                                        device=device),
            scale=torch.tensor(smax, dtype=torch.float32, device=device)))
    for prev, nxt in zip(layers, layers[1:]):
        if prev.out_dim != nxt.in_dim:
            raise ValueError(
                f"layer stack does not chain: out_dim {prev.out_dim} feeds "
                f"in_dim {nxt.in_dim} (extra channels would be dropped "
                "silently)")
    return AnalogProgram(layers=tuple(layers))


def _fit_unitary(target: np.ndarray, plan: mesh_lib.MeshPlan, *, steps: int,
                 lr: float, seed: int, device: torch.device) -> dict:
    """Kernel-backed gradient programming of one unitary onto ``plan``.

    Identity probes swept through ``ops.mesh_apply`` reconstruct the
    realized matrix column by column; AdamW minimizes the Frobenius error,
    one step per loop iteration (input phase screen on: required for the
    universality of the single-phase cell).  The initial phases come from a
    CPU generator seeded with ``seed``.
    """
    n = plan.n
    target_t = torch.as_tensor(np.asarray(target), dtype=torch.complex64,
                               device=device)
    params = mesh_lib.init_mesh_params(torch.Generator().manual_seed(seed),
                                       plan, with_sigma=True, device=device)
    params["alpha_in"] = torch.zeros(n, dtype=torch.float32, device=device)
    probes = torch.eye(n, dtype=torch.complex64, device=device)
    opt = AdamW(lr=lr, b1=0.9, b2=0.999, weight_decay=0.0, clip_norm=0.0)
    state = opt.init(params)
    for _ in range(steps):
        live = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        cols = kernel_ops.mesh_apply(live, probes, n=n, plan=plan)
        loss = ((cols.T - target_t).abs() ** 2).sum()
        grads = torch.autograd.grad(loss, list(live.values()))
        params, state, _ = opt.update(params, dict(zip(live, grads)), state)
    return params


def program(prog: AnalogProgram, method: str = "reck", *, steps: int = 1500,
            lr: float = 0.05, seed: int = 0) -> AnalogProgram:
    """Fill in mesh plans/params realizing each layer's unitary factors, on
    each layer's device.

    ``method="reck"``: exact analytic factorization (triangular layout).
    ``method="fit"``: the paper's stochastic-optimization programming on the
    rectangular Clements layout, via the kernel-backed AdamW fit.
    """
    if method not in ("reck", "fit"):
        raise ValueError(f"unknown programming method {method!r}")

    def one(i, la):
        if method == "reck":
            u_plan, u_params = decompose.reck_program(la.target_u,
                                                      device=la.device)
            v_plan, v_params = decompose.reck_program(la.target_vh,
                                                      device=la.device)
        else:
            plan = mesh_lib.clements_plan(la.n)
            u_params = _fit_unitary(la.target_u, plan, steps=steps, lr=lr,
                                    seed=seed + 2 * i, device=la.device)
            v_params = _fit_unitary(la.target_vh, plan, steps=steps, lr=lr,
                                    seed=seed + 2 * i + 1, device=la.device)
            u_plan = v_plan = plan
        return la.replace(v_plan=v_plan, v_params=v_params,
                          u_plan=u_plan, u_params=u_params)

    return AnalogProgram(layers=tuple(
        one(i, la) for i, la in enumerate(prog.layers)))


def logit(p: torch.Tensor) -> torch.Tensor:
    """Inverse sigmoid, clipped to (1e-6, 1 - 1e-6): the link function of
    attenuation logits (``AnalogLinear.init_from_matrix``)."""
    p = torch.clamp(p, 1e-6, 1.0 - 1e-6)
    return torch.log(p / (1.0 - p))


def inv_softplus(s: torch.Tensor) -> torch.Tensor:
    """Inverse softplus, guarded at 1e-6: the link function of the digital
    gamma's log-scale (``AnalogLinear.init_from_matrix``)."""
    return torch.log(torch.expm1(torch.clamp_min(s, 1e-6)))
