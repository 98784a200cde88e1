"""The 2x2 RFNN binary classifier (paper Sec. IV-A, Figs. 7-12).

Forward path (Eqs. 19-21):
    [z1, z2]^T = t(theta, phi) [x1, x2]^T      (the device)
    z_out = w1 |z1| + w2 |z2| + b              (post-processing)
    y_hat = sigmoid(z_out)

The device phases are the 36 discrete Table-I states.  This is the
inference side of the JAX package's ``paper/rfnn2x2.py``; training of the
post-processing and the device codes lands in a later slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

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
