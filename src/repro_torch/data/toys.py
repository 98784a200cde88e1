"""The paper's 2x2 binary-classification toy datasets (Fig. 12).

Four cases over the input space [0, 30]^2 (scaled by gamma=1/100 before
feeding the device, exactly as in the paper):
  a) 'corner'    — label 1 concentrated in the upper-right corner (~94%)
  b) 'diag_up'   — two diagonal bands toward the upper-right       (~98%)
  c) 'diag_down' — bands toward the lower-right                    (~96%)
  d) 'ring'      — label 1 surrounded by label 0 (hard for 2 cuts, ~74%)
"""

from __future__ import annotations

import numpy as np

GAMMA = 1.0 / 100.0  # the paper's pre-scaling factor


def make_toy_dataset(case: str, n: int = 400, seed: int = 0):
    """Returns (x [N,2] in [0,30]^2, y [N] in {0,1})."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 30, size=(n, 2))
    if case == "corner":
        y = ((x[:, 0] > 18) & (x[:, 1] > 18)).astype(np.int32)
    elif case == "diag_up":
        # two bands along the up-right diagonal, slight overlap (Fig. 12b)
        d = x[:, 1] - x[:, 0]
        y = (d + rng.normal(0, 0.8, n) > 0).astype(np.int32)
    elif case == "diag_down":
        d = x[:, 1] + x[:, 0] - 30
        y = (d + rng.normal(0, 0.8, n) > 0).astype(np.int32)
    elif case == "ring":
        r = np.linalg.norm(x - 15.0, axis=1)
        y = (r < 8.0).astype(np.int32)
    else:
        raise ValueError(f"unknown case {case!r}")
    return x.astype(np.float32), y


def train_test_split(x, y, frac=0.75, seed=0):
    n = len(x)
    perm = np.random.default_rng(seed).permutation(n)
    k = int(n * frac)
    tr, te = perm[:k], perm[k:]
    return x[tr], y[tr], x[te], y[te]
