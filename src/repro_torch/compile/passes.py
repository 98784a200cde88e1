"""Compiler passes over the :class:`AnalogProgram` IR: the counterpart of
the JAX package's ``repro.compile.passes``.  The pipeline mirrors the
paper's digital->analog transfer (Fig. 11):

    synthesize -> program -> [quantize] -> [calibrate] -> lower

* :func:`synthesize` — SVD-factor each digital weight matrix into
  ``U . D . V^H`` with the overall scale recovered digitally (Eq. 31).
* :func:`program` — fill in mesh plans/params for both unitary factors:
  analytically (:func:`repro_torch.core.decompose.reck_program`) or by the
  kernel-backed gradient fit (the paper's "stochastic optimization"
  programming, Sec. IV-B): identity probes swept through ``ops.mesh_apply``
  (kernels B1 and B2 on the card) under :class:`repro_torch.optim.AdamW`.
* :func:`quantize` — snap phases onto a discrete codebook (Table I or
  ``uniform<bits>``), at once (``nearest``) or keeping continuous masters
  for later quantization-aware fits (``ste``); records the integer device
  state codes either way.
* :func:`calibrate` — hardware-in-the-loop residual fit: re-fit phases
  (through the codebook's straight-through estimator when quantized) and
  the digital gains against the *imperfect* device, probed through
  ``ops.mesh_apply(hardware=...)`` (B1/B2) with the device's frozen noise
  draws (:func:`repro_torch.core.hardware.frozen_draws`), which the
  compiled program then serves against.
* :func:`lower` — emit the deep-grid kernel's inputs (an L x 1 x 1
  ``DeepGridSchedule`` and stacked ``[L, 1, 1, C, 8, P]`` coefficients)
  through ``ops.pack_network``'s pack cache and return a
  :class:`CompiledProgram` whose ``apply`` is one B6 launch.
  :func:`lower_tiled` and :func:`lower_deep` do the same for a tile grid
  and for a chain of tile grids.

The tiled passes (``synthesize_tiled`` ... ``calibrate_tiled``) map the
single-layer pipeline over every tile of a (To x Ti) grid.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.compile.program import (
    AnalogProgram,
    CompiledDeepProgram,
    CompiledProgram,
    CompiledTiledProgram,
    ProgramLayer,
    TiledAnalogProgram,
)
from repro_torch.core import decompose
from repro_torch.core import hardware as hw_lib
from repro_torch.core import mesh as mesh_lib
from repro_torch.core import quantize as q_lib
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kernel_ops
from repro_torch.optim.adamw import AdamW
from repro_torch.parallel import collectives as coll


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


# ---------------------------------------------------------------------------
# quantize
# ---------------------------------------------------------------------------

def resolve_codebook(codebook, device=None) -> torch.Tensor:
    """``"table1"`` | ``"uniform<bits>"`` | explicit phase array, as a
    float32 tensor on ``device`` (CUDA when None)."""
    device = resolve_device(device)
    if isinstance(codebook, str):
        if codebook == "table1":
            return q_lib.table_i_codebook(device)
        if codebook.startswith("uniform"):
            return q_lib.uniform_codebook(int(codebook[len("uniform"):]),
                                          device=device)
        raise ValueError(f"unknown codebook {codebook!r}")
    return torch.as_tensor(np.asarray(codebook), dtype=torch.float32,
                           device=device)


def quantize(prog: AnalogProgram, codebook="table1", *,
             mode: str = "nearest") -> AnalogProgram:
    """Snap mesh phases onto the discrete device codebook (Table I).

    ``mode="nearest"`` stores the snapped phases directly; ``mode="ste"``
    keeps the continuous masters (snapping happens at the device boundary,
    in ``lower`` and ``layer_matrix``, and later gradient fits see the
    codebook through the straight-through estimator).  Both record the
    integer device state codes.
    """
    if mode not in ("nearest", "ste"):
        raise ValueError(f"unknown quantize mode {mode!r}")

    def one(la: ProgramLayer) -> ProgramLayer:
        if not la.programmed:
            raise ValueError("quantize needs a programmed layer — run the "
                             "`program` pass first")
        cb = resolve_codebook(codebook, la.device)
        vp, up = la.v_params, la.u_params
        if mode == "nearest":
            vp = q_lib.quantize_mesh_params(vp, cb, ste=False)
            up = q_lib.quantize_mesh_params(up, cb, ste=False)
        return la.replace(
            v_params=vp, u_params=up, codebook=cb, quant_mode=mode,
            v_codes=q_lib.mesh_params_to_codes(vp, cb),
            u_codes=q_lib.mesh_params_to_codes(up, cb))

    return prog.map_layers(one)


# ---------------------------------------------------------------------------
# calibrate
# ---------------------------------------------------------------------------

def _calibration_run(train, base_v, base_u, atten0, scale0, probes, target,
                     codebook, draws_v, draws_u, *, v_plan, u_plan, hardware,
                     opt, steps, fit_gains):
    """The calibration step loop.

    Keeps the best-seen iterate: STE steps can hop phases across code
    boundaries non-monotonically, and the start point (the uncalibrated
    program) is evaluated first, so calibration never returns something
    worse than its input.  Each step's loss counts for the iterate it was
    taken at; the final iterate is compared after the last step.  The
    choice is made on the device (``torch.where``): no host sync per step.
    """
    n = v_plan.n

    def realize(tr):
        vp = tr.get("v", base_v)
        up = tr.get("u", base_u)
        if codebook is not None:
            vp = q_lib.quantize_mesh_params(vp, codebook, ste=True)
            up = q_lib.quantize_mesh_params(up, codebook, ste=True)
        atten = torch.sigmoid(tr["atten_logit"]) if fit_gains else atten0
        scale = (torch.nn.functional.softplus(tr["log_scale"]) if fit_gains
                 else scale0)
        h = kernel_ops.mesh_apply(vp, probes, n=n, plan=v_plan,
                                  hardware=hardware, draws=draws_v)
        h = h * atten.to(torch.complex64)
        h = kernel_ops.mesh_apply(up, h, n=n, plan=u_plan,
                                  hardware=hardware, draws=draws_u)
        return (scale.to(torch.complex64) * h).T

    def loss_fn(tr):
        return ((realize(tr) - target).abs() ** 2).sum()

    def pick(cond, if_true, if_false):
        a, spec = pytree.tree_flatten(if_true)
        b = pytree.tree_leaves(if_false)
        return pytree.tree_unflatten(
            [torch.where(cond, x, y) for x, y in zip(a, b)], spec)

    state = opt.init(train)
    best_tr = train
    best_loss = torch.tensor(float("inf"), device=target.device)
    for _ in range(steps):
        leaves, spec = pytree.tree_flatten(train)
        live = [t.detach().requires_grad_(True) for t in leaves]
        loss = loss_fn(pytree.tree_unflatten(live, spec))
        grads = torch.autograd.grad(loss, live)
        loss = loss.detach()
        better = loss < best_loss
        best_tr = pick(better, train, best_tr)
        best_loss = torch.minimum(loss, best_loss)
        train, state, _ = opt.update(
            train, pytree.tree_unflatten(list(grads), spec), state)
    with torch.no_grad():
        final_loss = loss_fn(train)
    return pick(final_loss < best_loss, train, best_tr)


def calibrate(prog: AnalogProgram,
              hardware: hw_lib.HardwareModel | None = None, *,
              key: int | None = None, draws=None, steps: int = 200,
              lr: float = 0.02, fit_phases: bool = True,
              fit_gains: bool = True) -> AnalogProgram:
    """Hardware-in-the-loop residual fit of each layer against its target.

    Probes the *imperfect* device (``ops.mesh_apply`` with ``hardware``,
    kernels B1/B2 on the card) under each layer's frozen phase-noise draws
    and re-fits the mesh phases and the digital gains (attenuation and
    gamma) to minimize the Frobenius error of the realized matrix.  The
    draws of layer ``i`` are :func:`repro_torch.core.hardware.frozen_draws`
    of ``(key, layer=i)``, or ``draws[i]`` (a ``(draws_v, draws_u)`` pair)
    when given; without either the device is noise-free.  Quantized layers
    fit their continuous masters through the codebook's straight-through
    estimator and keep updated device codes (``quant_mode`` becomes
    ``"ste"``).

    ``hardware=None`` calibrates against ideal cells (trims pure
    quantization error; no draws are bound).  Returns a program with the
    hardware model and the draws *bound*, so ``lower`` serves the
    calibrated device; its tensors carry no autograd history.
    """
    if key is not None and draws is not None:
        raise ValueError("pass key= or draws=, not both")

    def one(i, la: ProgramLayer) -> ProgramLayer:
        if not la.programmed:
            raise ValueError("calibrate needs a programmed layer — run the "
                             "`program` pass first")
        dv = du = None
        if hardware is not None and draws is not None:
            dv, du = draws[i]
        elif hardware is not None and key is not None:
            dv, du = hw_lib.frozen_draws(key, (la.v_params, la.u_params),
                                         layer=i)
        dev = la.device
        target = torch.as_tensor(la.padded_target(), dtype=torch.complex64,
                                 device=dev)
        probes = torch.eye(la.n, dtype=torch.complex64, device=dev)

        train = {}
        if fit_phases:
            train["v"] = dict(la.v_params)
            train["u"] = dict(la.u_params)
        if fit_gains:
            train["atten_logit"] = logit(la.attenuation)
            train["log_scale"] = inv_softplus(la.scale.to(torch.float32))

        opt = AdamW(lr=lr, b1=0.9, b2=0.999, weight_decay=0.0,
                    clip_norm=0.0)
        ran = bool(train) and steps > 0
        if ran:
            train = _calibration_run(
                train, la.v_params, la.u_params, la.attenuation, la.scale,
                probes, target, la.codebook, dv, du, v_plan=la.v_plan,
                u_plan=la.u_plan, hardware=hardware, opt=opt, steps=steps,
                fit_gains=fit_gains)
        # steps=0 binds the device without trimming: parameters (and the
        # gains' logit/softplus round trip) stay bit-identical
        vp = dict(train["v"]) if fit_phases and ran else la.v_params
        up = dict(train["u"]) if fit_phases and ran else la.u_params
        new = dict(v_params=vp, u_params=up, hardware=hardware, draws_v=dv,
                   draws_u=du)
        if fit_gains and ran:
            with torch.no_grad():
                new["attenuation"] = torch.sigmoid(train["atten_logit"])
                new["scale"] = torch.nn.functional.softplus(
                    train["log_scale"])
        if la.codebook is not None and ran:
            new["quant_mode"] = "ste"
            new["v_codes"] = q_lib.mesh_params_to_codes(vp, la.codebook)
            new["u_codes"] = q_lib.mesh_params_to_codes(up, la.codebook)
        return la.replace(**new)

    return AnalogProgram(layers=tuple(
        one(i, la) for i, la in enumerate(prog.layers)))


# ---------------------------------------------------------------------------
# lower
# ---------------------------------------------------------------------------

def _tile_kernel_args(la: ProgramLayer, hardware) -> dict:
    """The kernel argument dict of one programmed tile (shared by the
    network / tile-grid / deep-grid lowerings)."""
    args = {
        "v": la.device_params("v"),
        "u": la.device_params("u"),
        "atten": la.attenuation,
        "scale": la.scale,
    }
    if hardware is not None and la.draws_v is not None:
        args["draws_v"], args["draws_u"] = la.draws_v, la.draws_u
    return args


def _one_hardware(layers):
    hardwares = {la.hardware for la in layers}
    if len(hardwares) > 1:
        raise ValueError("all layers and tiles must share one hardware "
                         f"binding, got {hardwares}")
    return next(iter(hardwares))


def lower(prog: AnalogProgram) -> CompiledProgram:
    """Emit the deep-grid kernel's inputs and return a servable
    :class:`CompiledProgram`.

    Builds the per-layer kernel argument dicts (device-snapped phases,
    attenuation, digital gamma, bound noise draws), then emits the
    L x 1 x 1 :class:`~repro_torch.kernels.schedule.DeepGridSchedule` and
    the stacked ``[L, 1, 1, C, 8, P]`` tensors through
    ``ops.pack_network``: the tensors are packed exactly once, here.
    """
    if not prog.programmed:
        raise ValueError("lower needs a fully programmed AnalogProgram — "
                         "run the `program` pass first")
    hardware = _one_hardware(prog.layers)
    layer_args = tuple(_tile_kernel_args(la, hardware) for la in prog.layers)
    plans = tuple((la.v_plan, la.u_plan) for la in prog.layers)
    net, packed = kernel_ops.pack_network(layer_args, n=prog.n, plans=plans,
                                          hardware=hardware)
    return CompiledProgram(
        n=prog.n, in_dim=prog.in_dim, out_dim=prog.out_dim,
        depth=prog.depth, plans=plans, layer_args=layer_args,
        hardware=hardware, net=net, packed=packed, source=prog)


# ---------------------------------------------------------------------------
# Tiled pipeline: per-tile-SVD programs for matrices larger than one mesh
# ---------------------------------------------------------------------------
#
# Split the matrix into a (To x Ti) grid of tile-sized blocks, run the
# per-layer pipeline on every block independently (each tile is its own
# physical processor with its own codebook snap and hardware trim) and
# lower the grid onto one deep-grid launch; row outputs combine coherently
# in the kernel and the readout detects after combination.


def synthesize_tiled(matrix, tile: int, *, device=None) -> TiledAnalogProgram:
    """SVD-factor a large matrix into a (To x Ti) grid of tile programs.

    The ``[out, in]`` matrix is zero-padded up to multiples of ``tile``
    (even, >= 2) and each ``tile x tile`` block becomes a single-layer
    :class:`ProgramLayer` spec via :func:`synthesize`, on ``device`` (CUDA
    when None).  Row sums of the realized tiles reconstruct the full
    matmul; ``apply`` later truncates the padding back to ``out``.
    """
    m = np.asarray(matrix)
    if m.ndim != 2:
        raise ValueError(f"need one [out, in] matrix, got shape {m.shape}")
    if tile < 2 or tile % 2:
        raise ValueError(f"tile size must be even and >= 2, got {tile}")
    out_dim, in_dim = m.shape
    to = -(-out_dim // tile)
    ti = -(-in_dim // tile)
    mp = np.zeros((to * tile, ti * tile), m.dtype)
    mp[:out_dim, :in_dim] = m
    grid = tuple(
        tuple(synthesize(mp[o * tile:(o + 1) * tile, i * tile:(i + 1) * tile],
                         n=tile, device=device).layers[0]
              for i in range(ti))
        for o in range(to))
    return TiledAnalogProgram(out_dim=out_dim, in_dim=in_dim, tile=tile,
                              grid=grid)


def program_tiled(tp: TiledAnalogProgram, method: str = "reck",
                  **kw) -> TiledAnalogProgram:
    """:func:`program` mapped over every tile (independent meshes)."""
    return tp.map_tiles(lambda o, i, la: program(
        AnalogProgram((la,)), method, **kw).layers[0])


def quantize_tiled(tp: TiledAnalogProgram, codebook="table1", *,
                   mode: str = "nearest") -> TiledAnalogProgram:
    """:func:`quantize` mapped over every tile (per-device codebooks)."""
    return tp.map_tiles(lambda o, i, la: quantize(
        AnalogProgram((la,)), codebook, mode=mode).layers[0])


def calibrate_tiled(tp: TiledAnalogProgram,
                    hardware: hw_lib.HardwareModel | None = None, *,
                    key: int | None = None, draws=None, only=None,
                    **kw) -> TiledAnalogProgram:
    """:func:`calibrate` mapped over every tile.

    Each tile is its own physical device: its draws are
    :func:`repro_torch.core.hardware.frozen_draws` of ``(key, position =
    o * Ti + i, layer 0)``, by *physical* grid position, or ``draws[o][i]``
    (a ``(draws_v, draws_u)`` pair) when given.  On a placed grid
    (``compile/placement.py``) each tile is therefore bound to the draw of
    the position it occupies.

    ``only``: optional iterable of ``(o, i)`` physical positions; every
    other tile passes through untouched, its binding bit-identical.  The
    degraded-grid recovery re-trims exactly the tiles the remap moved.
    """
    if key is not None and draws is not None:
        raise ValueError("pass key= or draws=, not both")
    only_set = None if only is None else {tuple(p) for p in only}

    def one(o, i, la):
        if only_set is not None and (o, i) not in only_set:
            return la
        pair = None
        if hardware is not None and draws is not None:
            pair = draws[o][i]
        elif hardware is not None and key is not None:
            pair = hw_lib.frozen_draws(key, (la.v_params, la.u_params),
                                       layer=0, position=o * tp.ti + i)
        return calibrate(AnalogProgram((la,)), hardware,
                         draws=None if pair is None else (pair,),
                         **kw).layers[0]

    return tp.map_tiles(one)


def lower_tiled(tp: TiledAnalogProgram, *, mesh=None, row_axis: str = "rows",
                data_axis: str = "data") -> CompiledTiledProgram:
    """Emit the tile grid's kernel inputs; returns a servable
    :class:`CompiledTiledProgram` whose ``apply`` is one deep-grid launch
    over the whole (To x Ti) grid.

    Tensors are emitted through ``ops.pack_tile_grid``'s pack cache, packed
    exactly once, here, and handed back on every ``apply``.  A placement on
    ``tp`` is carried onto the compiled program (its ``apply`` undoes it
    digitally).  ``mesh`` (a ``DeviceMesh`` naming ``row_axis`` and
    ``data_axis``) makes every ``apply`` shard over tile rows and batch
    through ``ops.tiled_apply(mesh=)``.
    """
    if mesh is not None:
        coll.require_axes(mesh, row_axis, data_axis)
    if not tp.programmed:
        raise ValueError("lower_tiled needs a fully programmed tile grid — "
                         "run the `program_tiled` pass first")
    hardware = _one_hardware([la for row in tp.grid for la in row])
    tile_args = tuple(tuple(_tile_kernel_args(la, hardware) for la in row)
                      for row in tp.grid)
    plans = tuple(tuple((la.v_plan, la.u_plan) for la in row)
                  for row in tp.grid)
    grid, packed = kernel_ops.pack_tile_grid(tile_args, n=tp.tile,
                                             plans=plans, hardware=hardware)
    return CompiledTiledProgram(
        out_dim=tp.out_dim, in_dim=tp.in_dim, tile=tp.tile,
        to=tp.to, ti=tp.ti, plans=plans, tile_args=tile_args,
        hardware=hardware, grid=grid, packed=packed,
        placement=tp.placement, mesh=mesh, row_axis=row_axis,
        data_axis=data_axis, source=tp)


# ---------------------------------------------------------------------------
# Deep pipeline: a multi-layer cascade of tile grids on one launch
# ---------------------------------------------------------------------------

def lower_deep(progs, *, mesh=None, row_axis: str = "rows",
               data_axis: str = "data") -> CompiledDeepProgram:
    """Lower a cascade of programmed tile grids onto one deep-grid pack.

    ``progs`` is a sequence of :class:`TiledAnalogProgram`: layer ``l``'s
    ``To`` tile rows feed layer ``l+1``'s ``Ti`` input tiles, so adjacent
    layers must chain (``prev.to == next.ti``, ``prev.out_dim ==
    next.in_dim``) and every tile shares one tile size and one hardware
    binding.  The result's ``apply`` is one deep-grid launch over the whole
    ``L x To x Ti`` cascade: combined row outputs are power-detected and
    re-injected into the next layer's tiles inside the kernel, with no
    digital truncation or masking between layers.

    Placements fold into the launch: the first layer's column permutation
    becomes the input gather, the last layer's row permutation the output
    gather, and every *interior* boundary is resolved at pack time by
    re-ordering the next layer's packed tile columns into the previous
    layer's physical row order (each tile keeps its own calibration draw).
    ``mesh``/``row_axis``/``data_axis`` as for :func:`lower_tiled`: every
    ``apply`` then runs ``ops.deep_apply(mesh=)``, a chain of single-layer
    sharded launches.
    """
    if mesh is not None:
        coll.require_axes(mesh, row_axis, data_axis)
    progs = tuple(progs)
    if not progs:
        raise ValueError("lower_deep needs at least one tiled layer program")
    tile = progs[0].tile
    for l, tp in enumerate(progs):
        if not tp.programmed:
            raise ValueError(f"lower_deep: layer {l} is not fully programmed "
                             "— run the `program_tiled` pass first")
        if tp.tile != tile:
            raise ValueError("all layers must share one tile size, got "
                             f"{[t.tile for t in progs]}")
    for l in range(len(progs) - 1):
        prev, nxt = progs[l], progs[l + 1]
        if prev.to != nxt.ti:
            raise ValueError(
                f"deep program does not chain: layer {l} emits To={prev.to} "
                f"tile rows but layer {l + 1} expects Ti={nxt.ti} input tiles")
        if prev.out_dim != nxt.in_dim:
            raise ValueError(
                f"deep program does not chain: layer {l} out_dim "
                f"{prev.out_dim} feeds layer {l + 1} in_dim {nxt.in_dim}")
    hardware = _one_hardware(
        [la for tp in progs for row in tp.grid for la in row])

    layer_args, layer_plans = [], []
    prev_rows = None  # logical tile row carried by incoming physical block j
    for l, tp in enumerate(progs):
        pl = tp.placement
        if l == 0:
            order = list(range(tp.ti))
        else:
            # incoming physical block j carries the previous layer's logical
            # row prev_rows[j]; the tile consuming that logical column sits
            # at this layer's physical column inv_col_perm[prev_rows[j]]
            src = prev_rows if prev_rows is not None else list(range(tp.ti))
            inv_col = (list(pl.inv_col_perm) if pl is not None
                       else list(range(tp.ti)))
            order = [inv_col[c] for c in src]
        grid_args, grid_plans = [], []
        for row in tp.grid:
            grid_args.append(tuple(
                _tile_kernel_args(row[j], hardware) for j in order))
            grid_plans.append(tuple(
                (row[j].v_plan, row[j].u_plan) for j in order))
        layer_args.append(tuple(grid_args))
        layer_plans.append(tuple(grid_plans))
        prev_rows = list(pl.row_perm) if pl is not None else None
    layer_args = tuple(layer_args)
    layer_plans = tuple(layer_plans)
    deep, packed = kernel_ops.pack_deep_grid(layer_args, n=tile,
                                             plans=layer_plans,
                                             hardware=hardware)
    return CompiledDeepProgram(
        out_dim=progs[-1].out_dim, in_dim=progs[0].in_dim, tile=tile,
        depth=len(progs), to=progs[-1].to, ti=progs[0].ti,
        plans=layer_plans, layer_args=layer_args, hardware=hardware,
        deep=deep, packed=packed, in_placement=progs[0].placement,
        out_placement=progs[-1].placement, mesh=mesh, row_axis=row_axis,
        data_axis=data_axis, sources=progs)
