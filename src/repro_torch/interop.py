"""Carry parameters between numpy trees and the port's tensor dicts.

``params_from_numpy`` turns a tree of numpy arrays (nested dicts, tuples
and lists; for example the JAX package's params after
``jax.tree.map(np.asarray, ...)``) into the port's params: the same keys,
containers and shapes, float32 and complex64 kept as they are.
``params_to_numpy`` is the reverse.  ``MnistRFNN`` params (``w1, b1, w3,
b3, mesh{theta, phi, alpha}``), the 2x2 RFNN's (``w, b``),
``AnalogSequence``'s (``{"layers": (dict, ...)}``) and
``TiledAnalogLinear``'s stacked ``[To, Ti, ...]`` leaves and the LM's
``Model.init`` trees (float32 leaves stacked over the super-blocks, nested
dicts) round-trip exactly.
"""

from __future__ import annotations

import numpy as np
import torch

_KEEP = (np.float32, np.complex64, np.int32, np.int64, np.bool_)


def params_from_numpy(tree, device=None):
    """Tree of numpy arrays -> the same tree of tensors on ``device``.

    float32, complex64, int32, int64 and bool keep their dtype; other
    floating types become float32 and other complex types complex64.
    """
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    a = np.asarray(tree)
    if a.dtype.type not in _KEEP:
        if np.iscomplexobj(a):
            a = a.astype(np.complex64)
        elif np.issubdtype(a.dtype, np.floating):
            a = a.astype(np.float32)
        else:
            raise TypeError(f"unsupported parameter dtype {a.dtype}")
    return torch.from_numpy(np.array(a, order="C")).to(device)


def params_to_numpy(tree):
    """Tree of tensors -> the same tree of numpy arrays (host copies)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(params_to_numpy(v) for v in tree)
    return tree.detach().cpu().numpy()
