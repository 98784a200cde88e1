"""The 4-layer handwriting-recognition RFNN (paper Sec. IV-B, Figs. 14-16).

    784 -> 8        digital, leaky-ReLU
    8x8 analog mesh (28 unit cells, Table-I discrete phases, hardware
                     model from the measured prototype), activation = abs
                     (magnitude detection), no bias
    8 -> 10         digital, softmax

``analog=False`` swaps the mesh for an unconstrained 8x8 dense matrix — the
paper's "digital" baseline of Fig. 15.  This is the inference side of the
JAX package's ``paper/mnist_rfnn.py``; training lands in a later slice.

Offline note: the real MNIST files are unavailable, so the procedural
digits dataset (:mod:`repro_torch.data.digits`) stands in.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.analog_linear import AnalogUnitary
from repro_torch.core.hardware import HardwareModel
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class MnistRFNN:
    analog: bool = True
    hardware: HardwareModel | None = None   # None -> noiseless mesh sim
    quantize: str | None = "table1"
    d_hidden: int = 8
    n_classes: int = 10
    #: depth of the analog section; only the paper's single mesh (1) is
    #: ported so far.
    analog_depth: int = 1
    #: "kernel" runs the mesh through the CUDA kernel (its plain version on
    #: CPU tensors); "reference" through the column scan.
    backend: str = "kernel"

    def __post_init__(self):
        if self.analog_depth != 1:
            raise NotImplementedError(
                "analog_depth > 1 runs on the deep-grid kernels (B6-B8), "
                "which are not ported yet: see ROADMAP A7")
        object.__setattr__(self, "mesh", AnalogUnitary(
            n=self.d_hidden, quantize=self.quantize, hardware=self.hardware,
            output="abs", backend=self.backend))

    def init(self, generator: torch.Generator, *, device=None) -> dict:
        """Random params from a CPU ``generator``, on ``device`` (CUDA when
        None; raises when CUDA is absent)."""
        dev = resolve_device(device)

        def normal(*shape):
            return torch.randn(shape, generator=generator,
                               dtype=torch.float32).to(dev)

        params = {
            "w1": normal(784, self.d_hidden) * 0.05,
            "b1": torch.zeros(self.d_hidden, device=dev),
            "w3": normal(self.d_hidden, self.n_classes) * 0.3,
            "b3": torch.zeros(self.n_classes, device=dev),
        }
        if self.analog:
            params["mesh"] = self.mesh.init(generator, device=dev)
        else:
            params["w2"] = normal(self.d_hidden, self.d_hidden) * 0.3
        return params

    def apply(self, params: dict, x, generator: torch.Generator | None = None
              ) -> torch.Tensor:
        """Logits ``[B, n_classes]`` on the params' device."""
        x = torch.as_tensor(x, dtype=torch.float32, device=params["w1"].device)
        h1 = F.leaky_relu(x @ params["w1"] + params["b1"], 0.01)
        if self.analog:
            h2 = self.mesh.apply(params["mesh"], h1, generator=generator)
        else:
            h2 = (h1 @ params["w2"]).abs()  # same activation, free matrix
        return h2 @ params["w3"] + params["b3"]  # logits (softmax in loss)

    def loss(self, params: dict, x, y, generator: torch.Generator | None = None):
        """(mean negative log-likelihood, accuracy) as 0-d tensors."""
        logits = self.apply(params, x, generator)
        y = torch.as_tensor(y, dtype=torch.long, device=logits.device)
        logp = F.log_softmax(logits, dim=-1)
        nll = -logp.gather(1, y[:, None]).mean()
        acc = (logits.argmax(-1) == y).float().mean()
        return nll, acc


def _eval(model: MnistRFNN, params: dict, x, y) -> torch.Tensor:
    """Accuracy of ``model`` on ``(x, y)``, without gradients."""
    with torch.no_grad():
        return model.loss(params, x, y)[1]


def confusion_matrix(model: MnistRFNN, params: dict, x, y,
                     n_classes: int = 10) -> np.ndarray:
    with torch.no_grad():
        pred = model.apply(params, x).argmax(-1).cpu().numpy()
    cm = np.zeros((n_classes, n_classes), np.int64)
    for t, p in zip(np.asarray(y), pred):
        cm[t, p] += 1
    return cm
