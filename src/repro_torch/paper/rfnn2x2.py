"""The 2x2 RFNN binary classifier (paper Sec. IV-A, Figs. 7-12).

Forward path (Eqs. 19-21):
    [z1, z2]^T = t(theta, phi) [x1, x2]^T      (the device)
    z_out = w1 |z1| + w2 |z2| + b              (post-processing)
    y_hat = sigmoid(z_out)

The device phases are the 36 discrete Table-I states; digital parameters
(w1, w2, b) train with Adam and the device biasing codes with either
exhaustive 6-state search over theta (what the trained network in Fig. 9/10
effectively selects) or DSPSA (Algorithm I).  The port of the JAX
package's ``paper/rfnn2x2.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import dspsa as dspsa_lib
from repro_torch.core.cell import TABLE_I_PHASES_RAD
from repro_torch.core.hardware import (HardwareModel, detect_magnitude,
                                       imperfect_cell_matrix, normal_like)
from repro_torch.data.toys import GAMMA
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kernel_ops
from repro_torch.paper.prototype import PROTOTYPE


@dataclasses.dataclass
class RFNN2x2:
    """The device + post-processing pipeline of Fig. 11."""

    hardware: HardwareModel = PROTOTYPE
    gamma: float = GAMMA
    #: "kernel" evaluates the cell as a 2-channel mesh through the CUDA
    #: kernel (its plain version on the CPU), for any hardware model;
    #: "reference" multiplies by the 2x2 cell matrix.  Both draw phase
    #: noise and detector noise from the generator in the same order.
    backend: str = "kernel"
    #: where the device runs: CUDA when None (raises when CUDA is absent).
    device: str | torch.device | None = None

    def device_output(self, theta_code, phi_code, x,
                      generator: torch.Generator | None = None
                      ) -> torch.Tensor:
        """Measured |V| at (P2, P3) for inputs x [N, 2] (volts, unscaled)."""
        dev = resolve_device(self.device)
        table = torch.as_tensor(TABLE_I_PHASES_RAD, dtype=torch.float32,
                                device=dev)
        theta = table[int(theta_code)]
        phi = table[int(phi_code)]
        x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        # feed V1+ = x[:,1] (y-axis), V4+ = x[:,0] (x-axis) per Fig. 9 axes
        vin = torch.stack([x[:, 1], x[:, 0]], -1).to(torch.complex64)
        vin = vin * self.gamma
        if self.backend == "kernel":
            if generator is not None:
                # the draws imperfect_cell_matrix makes on the reference path
                theta = theta + self.hardware.phase_sigma * normal_like(
                    theta, generator)
                phi = phi + self.hardware.phase_sigma * normal_like(
                    phi, generator)
            # the single cell as a 2-channel mesh: column 0 holds the cell,
            # column 1 is the (inactive) odd column of the Clements rectangle
            zero = torch.zeros(1, device=dev)
            params = {"theta": torch.stack([theta.reshape(1), zero]),
                      "phi": torch.stack([phi.reshape(1), zero])}
            vout = kernel_ops.mesh_apply(params, vin, n=2,
                                         hardware=self.hardware)
        elif self.backend == "reference":
            t = imperfect_cell_matrix(theta, phi, self.hardware, generator)
            vout = (vin[:, None, :] * t[None]).sum(-1)   # vin @ t.T
        else:
            raise ValueError(f"unknown backend {self.backend!r}")
        mag = detect_magnitude(vout, self.hardware, generator)
        return mag / self.gamma  # post scaling back (Fig. 11)

    def predict(self, params: dict, theta_code, phi_code, x,
                generator: torch.Generator | None = None) -> torch.Tensor:
        mag = self.device_output(theta_code, phi_code, x, generator)
        w = torch.as_tensor(params["w"], dtype=torch.float32, device=mag.device)
        b = torch.as_tensor(params["b"], dtype=torch.float32, device=mag.device)
        return torch.sigmoid(mag @ w + b)


def _post_loss(params: dict, mag: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy of the post-processing on detector readings."""
    yhat = torch.sigmoid(mag @ params["w"] + params["b"])
    eps = 1e-7
    return -torch.mean(y * torch.log(yhat + eps)
                       + (1 - y) * torch.log(1 - yhat + eps))


def _init_post(seed: int, device=None) -> dict:
    """The post-processing's first draw: w = 0.1 N(0, 1) (a CPU generator
    seeded ``seed``), b = 0."""
    w = 0.1 * torch.randn(2, generator=torch.Generator().manual_seed(seed))
    return {"w": w.to(device), "b": torch.zeros((), device=device)}


def _fit_post(params0: dict, mag: torch.Tensor, y, *, steps=500, lr=0.1,
              batch=32, seed=0) -> tuple[dict, float]:
    """Adam on the post-processing (w1, w2, b) over fixed detector readings
    ``mag`` — the paper's stochastic optimization with dynamic learning-rate
    bound (refs [40][41]).  Minibatch indices come from
    ``default_rng(seed).integers``, one draw per step, as in the JAX
    package.  Returns the params and the final full-data loss."""
    dev = mag.device
    y = torch.as_tensor(np.asarray(y), dtype=torch.float32).to(dev)
    rng = np.random.default_rng(seed)
    idx = torch.as_tensor(np.stack([rng.integers(0, len(mag), size=batch)
                                    for _ in range(steps)])).to(dev)
    params = {k: v.detach().clone() for k, v in params0.items()}
    m_t = {k: torch.zeros_like(v) for k, v in params.items()}
    v_t = {k: torch.zeros_like(v) for k, v in params.items()}
    b1, b2, eps = 0.9, 0.999, 1e-8
    for s in range(steps):
        live = {k: v.requires_grad_(True) for k, v in params.items()}
        loss = _post_loss(live, mag[idx[s]], y[idx[s]])
        grads = dict(zip(live, torch.autograd.grad(loss, list(live.values()))))
        t = s + 1.0
        with torch.no_grad():
            for k in params:
                m_t[k] = b1 * m_t[k] + (1 - b1) * grads[k]
                v_t[k] = b2 * v_t[k] + (1 - b2) * grads[k] * grads[k]
                params[k] = params[k].detach() - lr * (m_t[k] / (1 - b1**t)) \
                    / (torch.sqrt(v_t[k] / (1 - b2**t)) + eps)
    with torch.no_grad():
        final_loss = float(_post_loss(params, mag, y))
    return params, final_loss


def _train_post(net: RFNN2x2, theta_code, phi_code, x, y, *, steps=500,
                lr=0.1, batch=32, seed=0) -> tuple[dict, float]:
    """Measure the device once at the given codes, then fit the
    post-processing from its first draw (:func:`_init_post`)."""
    with torch.no_grad():
        mag = net.device_output(theta_code, phi_code, x)  # fixed device
    return _fit_post(_init_post(seed, mag.device), mag, y, steps=steps, lr=lr,
                     batch=batch, seed=seed)


def train_rfnn2x2(x, y, *, method: str = "search", hardware=PROTOTYPE,
                  steps=300, seed=0, backend: str = "kernel", device=None):
    """Full Algorithm-I style training.  Returns (net, params, codes, info).

    method 'search': exhaustive over the 6 theta states (phi fixed at L6 as
    in Fig. 9); 'dspsa': discrete optimization over (theta, phi) codes with
    Adam-trained post-processing per evaluation (two-measurement DSPSA,
    perturbations from a CPU generator seeded ``seed``).  Every device
    measurement pass runs through the mesh kernel on ``device`` (CUDA when
    None).
    """
    net = RFNN2x2(hardware=hardware, backend=backend, device=device)
    if method == "search":
        best = None
        for tc in range(6):
            params, _ = _train_post(net, tc, 5, x, y, steps=steps, seed=seed)
            acc = accuracy(net, params, tc, 5, x, y)
            if best is None or acc > best[0]:
                best = (acc, tc, params)
        acc, tc, params = best
        return net, params, {"theta": tc, "phi": 5}, {"train_acc": acc}
    if method != "dspsa":
        raise ValueError(f"method must be 'search' or 'dspsa', got {method!r}")

    def device_loss(codes):
        _, loss = _train_post(net, int(codes["theta"]), int(codes["phi"]),
                              x, y, steps=80, seed=seed)
        return loss

    codes0 = {"theta": torch.tensor(2, dtype=torch.int32),
              "phi": torch.tensor(2, dtype=torch.int32)}
    best_codes, hist = dspsa_lib.minimize(
        torch.Generator().manual_seed(seed), codes0, device_loss,
        dspsa_lib.DSPSAConfig(a=1.5, n_states=6), steps=12)
    tc, pc = int(best_codes["theta"]), int(best_codes["phi"])
    params, _ = _train_post(net, tc, pc, x, y, steps=steps, seed=seed)
    return net, params, {"theta": tc, "phi": pc}, {
        "train_acc": accuracy(net, params, tc, pc, x, y),
        "dspsa_history": hist}


def accuracy(net: RFNN2x2, params: dict, theta_code, phi_code, x, y) -> float:
    with torch.no_grad():
        yhat = net.predict(params, theta_code, phi_code, x)
    y = torch.as_tensor(np.asarray(y, bool), device=yhat.device)
    return float(((yhat >= 0.5) == y).float().mean())


def decision_map(net: RFNN2x2, params: dict, theta_code, phi_code,
                 lim: float = 30.0, n: int = 41):
    """y_hat over the input plane — the Fig. 9/10 maps."""
    g = np.linspace(0, lim, n)
    xx, yy = np.meshgrid(g, g)
    pts = np.stack([xx.reshape(-1), yy.reshape(-1)], axis=1).astype(np.float32)
    with torch.no_grad():
        z = net.predict(params, theta_code, phi_code, pts)
    return g, z.cpu().numpy().reshape(n, n)
