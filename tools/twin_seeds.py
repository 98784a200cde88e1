#!/usr/bin/env python3
"""The digital twin that ``digital_to_analog_transfer`` starts from, on the
card, on the CPU and in a float64 witness, at several seeds.

    python3 tools/twin_seeds.py [--seeds 0 1 2 3 4] [--devices cuda cpu]
                                [--epochs 40] [--label NAME]

For each seed ``s`` the procedural digits are chip_smoke phase 22's
(``load_digits(n_train=1000, n_test=500, seed=s)``) and the twin is the
transfer's own: ``train_mnist(analog=False, analog_depth=4, quantize=None,
schedule="ste", epochs, lr=0.02, seed=s)`` on each of ``--devices``.  The
witness runs the same SGD (the same initial params from
``MnistRFNN.init``, the same minibatch order) in float64 on the CPU, with
the digital forward of ``MnistRFNN.apply`` written out here.  Prints each
run's train and test accuracy and its final params' largest relative
difference from the witness's; writes them to
``chiprun_out/twin_seeds_<label>.json``.  Runs without a card when
``--devices cpu``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.data.digits import load_digits  # noqa: E402
from repro_torch.paper.mnist_rfnn import MnistRFNN, train_mnist  # noqa: E402

DEPTH, LR, BATCH = 4, 0.02, 10


def witness(x_tr, y_tr, x_te, y_te, *, seed, epochs):
    """The twin's SGD in float64 on the CPU: ``train_mnist``'s loop with
    the digital forward of ``MnistRFNN.apply``."""
    model = MnistRFNN(analog=False, hardware=None, quantize=None,
                      analog_depth=DEPTH)
    params = {k: v.double() for k, v in model.init(
        torch.Generator().manual_seed(seed), device="cpu").items()}

    def logits(p, x):
        h = F.leaky_relu(x @ p["w1"] + p["b1"], 0.01)
        for w2 in p["w2"]:
            h = (h @ w2).abs()
        return h @ p["w3"] + p["b3"]

    x_tr64 = torch.as_tensor(np.asarray(x_tr), dtype=torch.float64)
    y_tr64 = torch.as_tensor(np.asarray(y_tr), dtype=torch.long)
    n = len(x_tr)
    nb = n // BATCH
    rng = np.random.default_rng(seed)
    for _ in range(epochs):
        perm = torch.as_tensor(rng.permutation(n)[: nb * BATCH])
        xb = x_tr64[perm].reshape(nb, BATCH, -1)
        yb = y_tr64[perm].reshape(nb, BATCH)
        for i in range(nb):
            live = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            nll = -F.log_softmax(logits(live, xb[i]), -1).gather(
                1, yb[i][:, None]).mean()
            grads = torch.autograd.grad(nll, list(live.values()))
            params = {k: (v - LR * g).detach()
                      for (k, v), g in zip(live.items(), grads)}

    def acc(x, y):
        with torch.no_grad():
            pred = logits(params, torch.as_tensor(np.asarray(x),
                                                  dtype=torch.float64))
        return float((pred.argmax(-1).numpy() == np.asarray(y)).mean())

    return params, acc(x_tr, y_tr), acc(x_te, y_te)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--devices", nargs="+", default=["cuda", "cpu"])
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--label", default="run")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    card = None
    if "cuda" in args.devices:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
        print(card, flush=True)
    rows = []
    for s in args.seeds:
        data = load_digits(n_train=1000, n_test=500, seed=s)
        t0 = time.perf_counter()
        wp, w_tr, w_te = witness(*data, seed=s, epochs=args.epochs)
        row = {"seed": s, "float64_cpu": {"train_acc": w_tr, "test_acc": w_te,
                                          "seconds": time.perf_counter() - t0}}
        for d in args.devices:
            t0 = time.perf_counter()
            res = train_mnist(*data, analog=False, analog_depth=DEPTH,
                              quantize=None, schedule="ste",
                              epochs=args.epochs, batch=BATCH, lr=LR, seed=s,
                              device=d)
            rel = max(float((res["params"][k].cpu().double() - wp[k]).abs().max()
                            / wp[k].abs().max()) for k in wp)
            row[f"float32_{d}"] = {"train_acc": res["train_acc"],
                                   "test_acc": res["test_acc"],
                                   "params_rel_to_float64": rel,
                                   "seconds": time.perf_counter() - t0}
        print(json.dumps(row), flush=True)
        rows.append(row)
    out = ROOT / "chiprun_out" / f"twin_seeds_{args.label}.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps({"card": card, "epochs": args.epochs,
                               "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
