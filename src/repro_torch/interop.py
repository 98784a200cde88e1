"""Carry parameters between numpy trees and the port's tensor dicts.

``params_from_numpy`` turns a tree of numpy arrays (nested dicts, tuples
and lists; for example the JAX package's params after
``jax.tree.map(np.asarray, ...)``) into the port's params: the same keys,
containers and shapes, float32 and complex64 kept as they are.
``params_to_numpy`` is the reverse.  ``MnistRFNN`` params (``w1, b1, w3,
b3, mesh{theta, phi, alpha}``), the 2x2 RFNN's (``w, b``),
``AnalogSequence``'s (``{"layers": (dict, ...)}``) and
``TiledAnalogLinear``'s stacked ``[To, Ti, ...]`` leaves and the LM's
``Model.init`` trees of every family (float32 leaves stacked over the
super-blocks, nested dicts: MoE routers and experts, SSM layers, the
hybrid's unstacked ``shared_attn``, the encoder-decoder's ``enc_blocks``
and ``dec_blocks``) round-trip exactly.  ``program_layer_from_numpy`` and
``tiled_program_from_numpy`` carry a compiler program's fields (the JAX
package's, read as numpy) into the port's ``ProgramLayer`` and
``TiledAnalogProgram``.  ``train_state_from_numpy`` and
``train_state_to_numpy`` carry an LM train state (params, AdamW's ``m``,
``v`` and ``step``) between the JAX package's ``TrainState`` read as numpy
and the port's.
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


def _plan(plan):
    from repro_torch.core.mesh import MeshPlan

    return MeshPlan(int(plan.n), *(np.asarray(getattr(plan, k)) for k in
                                   ("top", "active", "slot", "role")))


def _hardware(hw):
    import dataclasses

    from repro_torch.core.hardware import HardwareModel

    if hw is None:
        return None
    return HardwareModel(**{f.name: float(getattr(hw, f.name))
                            for f in dataclasses.fields(HardwareModel)})


def program_layer_from_numpy(la, device=None, draws=None):
    """A ``ProgramLayer`` of another package (the JAX package's, any object
    with the same field names and array-like values) -> the port's, on
    ``device``.

    Carries the targets, attenuation, scale, plans, params, codebook, quant
    mode, codes and hardware model.  A noise binding held as PRNG keys does
    not carry: pass the draws the keys stand for as ``draws`` (a
    ``(draws_v, draws_u)`` pair of ``{"theta": z, "phi": z}`` arrays).
    """
    from repro_torch.compile.program import ProgramLayer

    def opt(value, fn):
        return None if value is None else fn(value)

    dv, du = (None, None) if draws is None else draws
    return ProgramLayer(
        n=int(la.n), out_dim=int(la.out_dim), in_dim=int(la.in_dim),
        target=np.asarray(la.target), target_u=np.asarray(la.target_u),
        target_vh=np.asarray(la.target_vh),
        attenuation=params_from_numpy(np.asarray(la.attenuation, np.float32),
                                      device),
        scale=params_from_numpy(np.asarray(la.scale, np.float32), device),
        v_plan=opt(la.v_plan, _plan), u_plan=opt(la.u_plan, _plan),
        v_params=opt(la.v_params, lambda p: params_from_numpy(
            {k: np.asarray(v) for k, v in p.items()}, device)),
        u_params=opt(la.u_params, lambda p: params_from_numpy(
            {k: np.asarray(v) for k, v in p.items()}, device)),
        codebook=opt(la.codebook, lambda c: params_from_numpy(
            np.asarray(c, np.float32), device)),
        quant_mode=la.quant_mode,
        v_codes=opt(la.v_codes, lambda c: params_from_numpy(
            {k: np.asarray(v) for k, v in c.items()}, device)),
        u_codes=opt(la.u_codes, lambda c: params_from_numpy(
            {k: np.asarray(v) for k, v in c.items()}, device)),
        hardware=_hardware(la.hardware),
        draws_v=opt(dv, lambda d: params_from_numpy(d, device)),
        draws_u=opt(du, lambda d: params_from_numpy(d, device)))


def tiled_program_from_numpy(tp, device=None, draws=None):
    """A ``TiledAnalogProgram`` of another package -> the port's: every
    tile through :func:`program_layer_from_numpy` (``draws``: a ``[To][Ti]``
    nesting of pairs by physical position, or None) and the placement's
    permutations."""
    from repro_torch.compile.placement import TilePlacement
    from repro_torch.compile.program import TiledAnalogProgram

    pl = tp.placement
    return TiledAnalogProgram(
        out_dim=int(tp.out_dim), in_dim=int(tp.in_dim), tile=int(tp.tile),
        grid=tuple(tuple(program_layer_from_numpy(
            la, device, None if draws is None else draws[o][i])
            for i, la in enumerate(row)) for o, row in enumerate(tp.grid)),
        placement=None if pl is None else TilePlacement(
            tuple(int(v) for v in pl.row_perm),
            tuple(int(v) for v in pl.col_perm)))


def _moment_from_numpy(tree, device):
    """A moment tree; bfloat16 leaves (``ml_dtypes``' numpy bfloat16) kept
    bfloat16 through their 16-bit pattern."""
    if isinstance(tree, dict):
        return {k: _moment_from_numpy(v, device) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(a.view(np.int16), order="C"))
        return bits.view(torch.bfloat16).to(device)
    return params_from_numpy(a, device)


def train_state_from_numpy(state, device=None):
    """A train state of another package (any object with ``.params`` and
    ``.opt.step``, ``.opt.m``, ``.opt.v`` holding array-like leaves, e.g. the
    JAX package's ``TrainState`` after ``jax.tree.map(np.asarray, ...)``)
    -> the port's ``TrainState`` on ``device``: params as
    :func:`params_from_numpy`, the moments in their dtype (float32 or
    bfloat16), ``step`` an int32 0-d tensor."""
    from repro_torch.optim.adamw import OptState
    from repro_torch.train.step import TrainState

    opt = state.opt
    return TrainState(
        params=params_from_numpy(state.params, device),
        opt=OptState(step=torch.tensor(int(np.asarray(opt.step)),
                                       dtype=torch.int32, device=device),
                     m=_moment_from_numpy(opt.m, device),
                     v=_moment_from_numpy(opt.v, device)))


def train_state_to_numpy(state):
    """The port's ``TrainState`` -> the same ``TrainState`` with numpy
    leaves (host copies; bfloat16 moments widened to float32, exactly)."""
    from torch.utils import _pytree as pytree

    def host(t):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy().copy()

    return pytree.tree_map(host, state)
