"""The 4-layer handwriting-recognition RFNN (paper Sec. IV-B, Figs. 14-16).

    784 -> 8        digital, leaky-ReLU
    8x8 analog mesh (28 unit cells, Table-I discrete phases, hardware
                     model from the measured prototype), activation = abs
                     (magnitude detection), no bias
    8 -> 10         digital, softmax

Trained with minibatch SGD (batch 10, lr 0.005) exactly as the paper; the
mesh phases train through the straight-through estimator over the Table-I
codebook, or by the paper's two-stage Algorithm I (:func:`train_mnist`).
``analog=False`` swaps the mesh for an unconstrained 8x8 dense matrix — the
paper's "digital" baseline of Fig. 15.  The port of the JAX package's
``paper/mnist_rfnn.py`` for the single mesh (``analog_depth=1``).

Offline note: the real MNIST files are unavailable, so the procedural
digits dataset (:mod:`repro_torch.data.digits`) stands in.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import dspsa as dspsa_lib
from repro_torch.core import quantize as q_lib
from repro_torch.core.analog_linear import AnalogUnitary
from repro_torch.core.hardware import HardwareModel
from repro_torch.device import resolve_device
from repro_torch.paper.prototype import PROTOTYPE
from repro_torch.train.step import make_sgd_step


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


def train_mnist(x_tr, y_tr, x_te, y_te, *, analog=True, hardware=PROTOTYPE,
                quantize="table1", epochs=100, batch=10, lr=0.005, seed=0,
                log_every=20, noisy_train=False, schedule="algorithm1",
                backend="kernel", analog_depth=1, device=None):
    """Paper hyperparameters: minibatch 10, lr 0.005, 100 epochs, shuffled.

    schedule:
      'ste'        — straight-through quantized phases from the start;
      'algorithm1' — the paper's two-stage physics-aware flow: train the
                     mesh phases continuously against the hardware model,
                     then program the nearest Table-I codes onto the device
                     and let the digital layers adapt to the deployed
                     discrete mesh, alternating with DSPSA bursts on the
                     device codes.

    Runs on ``device`` (CUDA when None; raises when CUDA is absent).
    ``analog_depth > 1`` raises until the deep-grid kernels are ported.
    """
    if analog and quantize and schedule == "algorithm1":
        # stage 1: continuous phases, hardware-in-the-loop
        stage1 = train_mnist(x_tr, y_tr, x_te, y_te, analog=True,
                             hardware=hardware, quantize=None,
                             epochs=max(1, epochs * 2 // 3), batch=batch,
                             lr=lr, seed=seed, log_every=log_every,
                             noisy_train=noisy_train, schedule="ste",
                             backend=backend, analog_depth=analog_depth,
                             device=device)
        # stage 2: freeze the mesh at its nearest discrete codes; the
        # digital layers adapt, alternating with DSPSA bursts on the device
        # codes (Algorithm I: "DSPSA -> dV; SGD optimizer -> dW").
        model = MnistRFNN(analog=True, hardware=hardware, quantize=quantize,
                          backend=backend)
        params = dict(stage1["params"])
        stage2_epochs = max(1, epochs // 3)
        rounds = 3
        hist = list(stage1["history"])
        for r in range(rounds):
            res = _train_loop(model, params, x_tr, y_tr, x_te, y_te,
                              epochs=max(1, stage2_epochs // rounds),
                              batch=batch, lr=lr, seed=seed + 1 + r,
                              log_every=log_every, noisy_train=noisy_train,
                              freeze=("mesh",))
            params = res["params"]
            hist += res["history"]
            if r < rounds - 1:
                params = _dspsa_refine(model, params, x_tr, y_tr,
                                       steps=25, seed=seed + 100 + r)
        res["params"] = params
        res["history"] = hist
        res["train_acc"] = float(_eval(model, params, x_tr, y_tr))
        res["test_acc"] = float(_eval(model, params, x_te, y_te))
        return res

    model = MnistRFNN(analog=analog, hardware=hardware if analog else None,
                      quantize=quantize, backend=backend,
                      analog_depth=analog_depth)
    params = model.init(torch.Generator().manual_seed(seed), device=device)
    return _train_loop(model, params, x_tr, y_tr, x_te, y_te, epochs=epochs,
                       batch=batch, lr=lr, seed=seed, log_every=log_every,
                       noisy_train=noisy_train)


def _train_loop(model: MnistRFNN, params: dict, x_tr, y_tr, x_te, y_te, *,
                epochs, batch, lr, seed, log_every, noisy_train, freeze=()):
    """SGD epochs over minibatches shuffled by ``default_rng(seed)``.

    Each epoch's shuffled data moves to the params' device once; the host
    reads the losses back only on logged epochs.  With ``noisy_train`` the
    hardware noise of epoch ``ep`` comes from a generator seeded ``ep``.
    """
    dev = params["w1"].device
    sgd_step = make_sgd_step(model.loss, lr=lr, freeze=freeze)
    n = len(x_tr)
    n_batches = n // batch
    rng = np.random.default_rng(seed)
    history = []
    for ep in range(epochs):
        perm = rng.permutation(n)[: n_batches * batch]
        xb = torch.as_tensor(np.asarray(x_tr)[perm].reshape(n_batches, batch, -1),
                             dtype=torch.float32).to(dev)
        yb = torch.as_tensor(np.asarray(y_tr)[perm].reshape(n_batches, batch),
                             dtype=torch.long).to(dev)
        gen = torch.Generator().manual_seed(ep) if noisy_train else None
        losses, accs = [], []
        for i in range(n_batches):
            params, (loss, acc) = sgd_step(params, xb[i], yb[i], gen)
            losses.append(loss)
            accs.append(acc)
        if (ep + 1) % log_every == 0 or ep == 0:
            history.append({"epoch": ep + 1,
                            "loss": float(torch.stack(losses).mean()),
                            "train_acc": float(torch.stack(accs).mean())})
    return {"model": model, "params": params,
            "train_acc": float(_eval(model, params, x_tr, y_tr)),
            "test_acc": float(_eval(model, params, x_te, y_te)),
            "history": history}


def _dspsa_refine(model: MnistRFNN, params: dict, x, y, *, steps=25, seed=0,
                  sample=512) -> dict:
    """DSPSA on the 56 device phase codes (theta, phi of the 28 cells).

    Each loss evaluation is one 'hardware measurement pass' (a forward
    pass) over a fixed calibration minibatch: the two-measurement form of
    Algorithm I, plus the projected iterate's measurement.
    """
    dev = params["w1"].device
    cb = q_lib.table_i_codebook(dev)
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(x))[:sample]
    xs = torch.as_tensor(np.asarray(x)[idx], dtype=torch.float32).to(dev)
    ys = torch.as_tensor(np.asarray(y)[idx], dtype=torch.long).to(dev)
    mesh0 = params["mesh"]
    codes0 = {"theta": q_lib.nearest_code(mesh0["theta"], cb),
              "phi": q_lib.nearest_code(mesh0["phi"], cb)}

    def with_codes(codes) -> dict:
        mesh = dict(mesh0)
        mesh["theta"] = q_lib.codes_to_phase(codes["theta"], cb)
        mesh["phi"] = q_lib.codes_to_phase(codes["phi"], cb)
        return {**params, "mesh": mesh}

    def loss_of(codes):
        with torch.no_grad():
            return model.loss(with_codes(codes), xs, ys)[0]

    best, _hist = dspsa_lib.minimize(
        torch.Generator().manual_seed(seed), codes0, loss_of,
        dspsa_lib.DSPSAConfig(a=0.8, n_states=6), steps=steps)
    return with_codes(best)


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
