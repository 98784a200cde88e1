"""Programming a mesh to realize a target unitary (paper Eqs. 27-30); the
counterpart of the JAX package's ``repro.core.decompose``.

* :func:`reck_program` — exact analytic factorization.  For the paper's
  cell (phase shifter phi on the output of channel 1, Eq. 5), left
  multiplication by ``t^H`` on an adjacent channel pair can null any matrix
  element, which gives a QR-by-adjacent-Givens sweep
  ``t^H_K ... t^H_1 U = D``, so ``U = t_1 ... t_K D``: the physical cascade
  applies the diagonal phase screen D at the input, then the cells in
  reverse nulling order.  The factorization is numpy (float64), the same
  arithmetic as the JAX package's, so both give the same plan and params.
* :func:`fit_program` — gradient programming of an arbitrary layout (the
  paper's "stochastic optimization", Sec. IV-B) with
  :class:`repro_torch.optim.AdamW`, minimizing the Frobenius error of the
  realized matrix, as a Python loop of steps.

Both return params for :func:`repro_torch.core.mesh.apply_mesh`.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import mesh as mesh_lib
from repro_torch.device import resolve_device


def random_unitary(n: int, seed: int = 0) -> np.ndarray:
    """Haar-ish random unitary via QR of a complex Gaussian (numpy; the same
    matrix as the JAX package's for a seed)."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    q, r = np.linalg.qr(z)
    return (q * (np.diag(r) / np.abs(np.diag(r)))).astype(np.complex128)


def _cell_np(theta: float, phi: float) -> np.ndarray:
    half = 0.5 * theta
    s, c = np.sin(half), np.cos(half)
    glob = 1j * np.exp(-0.5j * theta)
    return glob * np.array(
        [[np.exp(-1j * phi) * s, np.exp(-1j * phi) * c], [c, -s]], np.complex128
    )


def reck_program(u: np.ndarray, atol: float = 1e-8, *, device=None):
    """Exact analytic mesh program realizing the unitary ``u``.

    Returns ``(plan, params)`` with ``mesh_matrix(plan, params) ~= u``;
    ``params`` holds ``theta``/``phi`` [C, P] and the input screen
    ``alpha_in`` [n], float32 on ``device`` (CUDA when None).
    """
    device = resolve_device(device)
    u = np.asarray(u, np.complex128)
    n = u.shape[0]
    if u.shape != (n, n) or n % 2:
        raise ValueError(f"need even square unitary, got {u.shape}")
    err = np.abs(u @ u.conj().T - np.eye(n)).max()
    if err > 1e-6:
        raise ValueError(f"input is not unitary (err={err:.2e})")

    v = u.copy()
    nulled: list[tuple[int, float, float]] = []  # t^H application order
    for col in range(n - 1):
        for q in range(n - 1, col, -1):
            p = q - 1
            vp, vq = v[p, col], v[q, col]
            if abs(vq) < atol and abs(vp) < atol:
                continue
            theta = 2.0 * np.arctan2(abs(vp), abs(vq))
            if abs(vp) > atol and abs(vq) > atol:
                phi = float(np.angle(vq) - np.angle(vp))
            else:
                phi = 0.0
            th = _cell_np(theta, phi).conj().T  # t^H
            rows = np.stack([v[p, :], v[q, :]])
            v[p, :], v[q, :] = th @ rows
            nulled.append((p, theta, phi))
    d = np.diag(v).copy()
    if np.abs(np.abs(d) - 1.0).max() > 1e-6 or np.abs(v - np.diag(d)).max() > 1e-6:
        raise AssertionError("nulling did not reach a diagonal")

    # physical order: input screen D, then cells in reverse nulling order
    plan, theta, phi = mesh_lib.pack_cells_to_columns(
        n, list(reversed(nulled)), pad_to_columns=max(1, 2 * n - 3),
        device=device)
    alpha_in = torch.as_tensor(-np.angle(d), dtype=torch.float32,
                               device=device)  # e^{-j a} = d
    return plan, {"theta": theta, "phi": phi, "alpha_in": alpha_in}


def reconstruction_error(plan: mesh_lib.MeshPlan, params: dict,
                         target: np.ndarray) -> float:
    """Largest elementwise error of the realized matrix against ``target``."""
    with torch.no_grad():
        rec = mesh_lib.mesh_matrix(plan, params).cpu().numpy()
    return float(np.abs(rec - target).max())


def fit_program(target: np.ndarray, plan: mesh_lib.MeshPlan | None = None, *,
                steps: int = 3000, lr: float = 0.05, seed: int = 0,
                with_input_screen: bool = True, device=None):
    """Gradient programming of ``target`` onto a mesh layout.

    AdamW on (theta, phi, alpha, alpha_in) minimizes the Frobenius error of
    the realized matrix (the reference column scan), one step per loop
    iteration.  The initial phases come from a CPU generator seeded with
    ``seed`` (the JAX package draws them from ``PRNGKey(seed)``: other
    numbers).  The paper's single-phase cell with an output screen only is
    not universal over U(N); the input screen restores universality and is
    on by default.  Returns ``(plan, params, final_error)``.
    """
    from repro_torch.optim.adamw import AdamW

    device = resolve_device(device)
    target_t = torch.as_tensor(np.asarray(target), dtype=torch.complex64,
                               device=device)
    n = target_t.shape[0]
    if plan is None:
        plan = mesh_lib.clements_plan(n)
    params = mesh_lib.init_mesh_params(torch.Generator().manual_seed(seed),
                                       plan, with_sigma=True, device=device)
    if with_input_screen:
        params["alpha_in"] = torch.zeros(n, dtype=torch.float32, device=device)
    opt = AdamW(lr=lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
                clip_norm=0.0)
    state = opt.init(params)
    for _ in range(steps):
        live = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        rec = mesh_lib.mesh_matrix(plan, live)
        loss = ((rec - target_t).abs() ** 2).sum()
        grads = torch.autograd.grad(loss, list(live.values()))
        params, state, _ = opt.update(params, dict(zip(live, grads)), state)
    return plan, params, reconstruction_error(plan, params, np.asarray(target))
