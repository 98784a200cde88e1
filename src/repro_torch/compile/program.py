"""The ``AnalogProgram`` IR: digital weights compiled onto the RF processor.
The counterpart of the JAX package's ``repro.compile.program``.

* :class:`ProgramLayer` — one analog layer ``y = |gamma . U (D (V x))|``:
  the SVD targets, the diagonal attenuation and digital gamma, the mesh
  plans/params filled in by the ``program`` pass, the quantization state
  (codebook and integer device codes) and the hardware binding (model and
  frozen phase-noise draws) from ``calibrate``.
* :class:`AnalogProgram` — an L-layer stack of those (one entry for a
  single matrix).
* :class:`CompiledProgram` — the ``lower`` pass output: a static
  L x 1 x 1 :class:`~repro_torch.kernels.schedule.DeepGridSchedule` and the
  stacked ``[L, 1, 1, C, 8, P]`` coefficients, packed once at lower time,
  so ``apply`` is one deep-grid forward (kernel B6 on the card) with no
  packing work.
* :class:`TiledAnalogProgram` — a (To x Ti) grid of per-tile-SVD
  :class:`ProgramLayer`\\ s realizing one large matrix as block sums (the
  paper's Sec. V scale-up).
* :class:`CompiledTiledProgram` — the ``lower_tiled`` output on the
  1 x To x Ti grid, one B6 launch per apply.
* :class:`CompiledDeepProgram` — the ``lower_deep`` output: an L-layer
  cascade of tile grids on one ``[L, To, Ti, C, 8, P]`` pack, one B6 launch
  per apply, placements folded into the launch.

The IR is host-side (frozen dataclasses); the attenuation, scale, mesh
params and draws are tensors on the device the program was synthesized
for.  The JAX package's ``block_b``/``interpret`` have no counterpart (see
``kernels/ops.py``).  Lowered with ``mesh=`` (a ``DeviceMesh``), the tiled
and deep programs shard every ``apply`` over tile rows and batch, one
launch a layer on each rank's row slab.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core import hardware as hw_lib
from repro_torch.core import mesh as mesh_lib
from repro_torch.core import quantize as q_lib
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.schedule import DeepGridSchedule
from repro_torch.runtime import trace


@dataclasses.dataclass(frozen=True)
class ProgramLayer:
    """One analog layer of the IR; passes fill in the optional fields."""

    n: int                      # padded square mesh size (even)
    out_dim: int
    in_dim: int
    target: np.ndarray          # [out_dim, in_dim] digital weight matrix
    target_u: np.ndarray        # [n, n] unitary (SVD left factor)
    target_vh: np.ndarray       # [n, n] unitary (SVD right factor, V^H)
    attenuation: torch.Tensor   # [n] diagonal D / sigma_max, in [0, 1]
    scale: torch.Tensor         # digital gamma (sigma_max), 0-d float32
    # filled by the ``program`` pass
    v_plan: mesh_lib.MeshPlan | None = None
    v_params: dict | None = None
    u_plan: mesh_lib.MeshPlan | None = None
    u_params: dict | None = None
    # filled by the ``quantize`` pass
    codebook: torch.Tensor | None = None
    quant_mode: str | None = None        # "nearest" | "ste"
    v_codes: dict | None = None          # integer device state codes
    u_codes: dict | None = None
    # filled by the ``calibrate`` pass: the hardware model and the device's
    # frozen phase-noise draws, {"theta": z, "phi": z} per mesh
    hardware: hw_lib.HardwareModel | None = None
    draws_v: dict | None = None
    draws_u: dict | None = None

    @property
    def programmed(self) -> bool:
        return self.v_params is not None and self.u_params is not None

    @property
    def device(self) -> torch.device:
        return self.attenuation.device

    def replace(self, **kw) -> "ProgramLayer":
        return dataclasses.replace(self, **kw)

    def device_params(self, which: str) -> dict:
        """The phases the device realizes: codebook-snapped when quantized.

        ``quant_mode="nearest"`` layers store snapped params already (the
        snap is then idempotent); ``"ste"`` layers keep continuous masters
        and snap here, at the device boundary.
        """
        params = self.v_params if which == "v" else self.u_params
        if params is None:
            raise ValueError(f"layer has no programmed {which!r} mesh — "
                             "run the `program` pass first")
        if self.codebook is None:
            return params
        return q_lib.quantize_mesh_params(params, self.codebook, ste=False)

    def padded_target(self) -> np.ndarray:
        """The [n, n] zero-padded complex target matrix."""
        t = np.zeros((self.n, self.n), np.complex128)
        t[: self.out_dim, : self.in_dim] = self.target
        return t


@dataclasses.dataclass(frozen=True)
class AnalogProgram:
    """An L-layer analog program (L == 1 for a single matrix)."""

    layers: tuple[ProgramLayer, ...]

    def __post_init__(self):
        if not self.layers:
            raise ValueError("an AnalogProgram needs at least one layer")
        n = self.layers[0].n
        if any(la.n != n for la in self.layers):
            raise ValueError(
                f"all layers must share the padded mesh size, got "
                f"{[la.n for la in self.layers]}")

    @property
    def n(self) -> int:
        return self.layers[0].n

    @property
    def depth(self) -> int:
        return len(self.layers)

    @property
    def in_dim(self) -> int:
        return self.layers[0].in_dim

    @property
    def out_dim(self) -> int:
        return self.layers[-1].out_dim

    @property
    def programmed(self) -> bool:
        return all(la.programmed for la in self.layers)

    def map_layers(self, fn) -> "AnalogProgram":
        return AnalogProgram(layers=tuple(fn(la) for la in self.layers))

    def n_cells(self) -> int:
        return sum(la.v_plan.n_cells + la.u_plan.n_cells
                   for la in self.layers if la.programmed)


def layer_matrix(layer: ProgramLayer, *, device: bool = True,
                 with_hardware: bool = True) -> np.ndarray:
    """The complex [out_dim, in_dim] matrix a programmed layer realizes.

    Runs the kernel path (two ``ops.mesh_apply`` probes over the identity
    batch, kernel B1 on the card) on the layer's device.  ``device=True``
    uses the codebook-snapped phases (what the hardware holds);
    ``with_hardware=True`` includes the layer's hardware binding and its
    frozen noise draws, so the result is the as-fabricated matrix the
    ``calibrate`` pass fitted against.
    """
    if not layer.programmed:
        raise ValueError("layer is not programmed")
    vp = layer.device_params("v") if device else layer.v_params
    up = layer.device_params("u") if device else layer.u_params
    hw = layer.hardware if with_hardware else None
    dv = layer.draws_v if with_hardware else None
    du = layer.draws_u if with_hardware else None
    probes = torch.eye(layer.n, dtype=torch.complex64, device=layer.device)
    with torch.no_grad():
        h = kernel_ops.mesh_apply(vp, probes, n=layer.n, plan=layer.v_plan,
                                  hardware=hw, draws=dv)
        h = h * layer.attenuation.to(torch.complex64)
        h = kernel_ops.mesh_apply(up, h, n=layer.n, plan=layer.u_plan,
                                  hardware=hw, draws=du)
        rec = layer.scale.to(torch.complex64) * h
    return rec.cpu().numpy().T[: layer.out_dim, : layer.in_dim]


def program_error(prog: AnalogProgram, *, device: bool = True,
                  with_hardware: bool = True) -> float:
    """Worst-case elementwise synthesis error across the program's layers."""
    return max(
        float(np.abs(layer_matrix(la, device=device,
                                  with_hardware=with_hardware)
                     - la.target).max())
        for la in prog.layers)


@dataclasses.dataclass(frozen=True)
class TiledAnalogProgram:
    """A (To x Ti) grid of single-layer analog programs for one matrix.

    Each grid entry is a :class:`ProgramLayer` (n = tile, depth 1) whose
    target is the corresponding tile-sized block of the (zero-padded)
    ``[out_dim, in_dim]`` matrix; row sums of the realized tile matrices
    reconstruct the full matmul.  The tiled passes map the per-layer
    pipeline over the grid, so quantization and hardware calibration run
    per tile, device by device.
    """

    out_dim: int
    in_dim: int
    tile: int
    grid: tuple[tuple[ProgramLayer, ...], ...]
    # logical -> physical grid permutation from the yield-aware placement
    # pass (compile/placement.py); None = grid is in logical order
    placement: "object | None" = None

    def __post_init__(self):
        if not self.grid or not self.grid[0]:
            raise ValueError("a TiledAnalogProgram needs at least one tile")
        ti = len(self.grid[0])
        if any(len(row) != ti for row in self.grid):
            raise ValueError("tile grid must be rectangular")
        if any(la.n != self.tile for row in self.grid for la in row):
            raise ValueError("every tile must have n == tile "
                             f"({self.tile}), got "
                             f"{sorted({la.n for row in self.grid for la in row})}")

    @property
    def to(self) -> int:
        return len(self.grid)

    @property
    def ti(self) -> int:
        return len(self.grid[0])

    @property
    def programmed(self) -> bool:
        return all(la.programmed for row in self.grid for la in row)

    def map_tiles(self, fn) -> "TiledAnalogProgram":
        """New program with ``fn(o, i, layer)`` applied to every tile."""
        return dataclasses.replace(self, grid=tuple(
            tuple(fn(o, i, la) for i, la in enumerate(row))
            for o, row in enumerate(self.grid)))

    def realized_matrix(self, *, device: bool = True,
                        with_hardware: bool = True) -> np.ndarray:
        """The full complex matrix the programmed grid realizes (block
        sums of :func:`layer_matrix` per tile), truncated to
        ``[out_dim, in_dim]``.  A placed grid reports the *logical*
        matrix: physical position ``(po, pi)`` holds logical block
        ``(row_perm[po], col_perm[pi])``."""
        t = self.tile
        m = np.zeros((self.to * t, self.ti * t), np.complex128)
        pl = self.placement
        for po, row in enumerate(self.grid):
            for pi, la in enumerate(row):
                o = pl.row_perm[po] if pl is not None else po
                i = pl.col_perm[pi] if pl is not None else pi
                m[o * t:(o + 1) * t, i * t:(i + 1) * t] = layer_matrix(
                    la, device=device, with_hardware=with_hardware)
        return m[: self.out_dim, : self.in_dim]

    def n_cells(self) -> int:
        return sum(la.v_plan.n_cells + la.u_plan.n_cells
                   for row in self.grid for la in row if la.programmed)


def _prep_input(x, in_dim: int, padded_dim: int,
                device: torch.device) -> torch.Tensor:
    """Shared compiled-apply preamble: trailing-dim check, complex64 cast on
    the program's device, zero-pad up to the mesh/grid width."""
    x = torch.as_tensor(x, device=device)
    if x.shape[-1] != in_dim:
        raise ValueError(f"expected trailing dim {in_dim}, got "
                         f"{tuple(x.shape)}")
    xc = (x.to(torch.complex64) if x.is_complex()
          else x.to(torch.float32).to(torch.complex64))
    pad = padded_dim - in_dim
    if pad:
        xc = torch.cat([xc, xc.new_zeros(xc.shape[:-1] + (pad,))], dim=-1)
    return xc


def _gather_tiles(x: torch.Tensor, idx: torch.Tensor,
                  tile: int) -> torch.Tensor:
    """Tile ``j`` of the result is tile ``idx[j]`` of ``x``'s last axis."""
    xt = x.reshape(x.shape[:-1] + (len(idx), tile))
    return xt.index_select(-2, idx).reshape(x.shape)


def _perm_indices(device: torch.device, *perms):
    """Each permutation as a long tensor on ``device`` (None stays None):
    made once per program, so an apply copies nothing from the host."""
    return tuple(None if p is None else torch.as_tensor(
        p, dtype=torch.long, device=device) for p in perms)


@dataclasses.dataclass(frozen=True)
class CompiledProgram:
    """The ``lower`` pass output: the deep-grid kernel's inputs, ready to
    serve.

    ``net``/``packed`` are the ``ops.pack_network`` result emitted at lower
    time; every ``apply`` hands them straight back to
    :func:`repro_torch.kernels.ops.rfnn_network` (``packed=``), so serving
    does no packing work, first tick included.  ``layer_args`` is kept as
    the program's kernel-level parameter view.
    """

    n: int
    in_dim: int
    out_dim: int
    depth: int
    plans: tuple
    layer_args: tuple
    hardware: hw_lib.HardwareModel | None
    net: DeepGridSchedule        # L x 1 x 1 deep-grid schedule
    packed: tuple                # (coef_v [L,1,1,C,8,P], coef_u, gains)
    # the AnalogProgram this was lowered from (introspection); not part of
    # the kernel contract
    source: "AnalogProgram | None" = dataclasses.field(
        default=None, repr=False, compare=False)

    # -- ServableProgram surface (repro_torch.serving.servable) ---------
    @property
    def n_in(self) -> int:
        return self.in_dim

    @property
    def n_out(self) -> int:
        return self.out_dim

    @property
    def placement(self):
        return None              # a single mesh has no tile placement

    def recover(self, dead_tiles, **kw) -> "CompiledProgram":
        raise ValueError(
            "CompiledProgram has no tile grid to remap around dead tiles; "
            "tile_down recovery needs a CompiledTiledProgram or "
            "CompiledDeepProgram")

    def apply(self, x) -> torch.Tensor:
        """``x[..., in_dim]`` -> detected magnitudes ``[..., out_dim]``.

        One deep-grid forward: per layer ``|gamma_l . U_l (D_l (V_l .))|``
        with the detected magnitude feeding the next layer.
        """
        xc = _prep_input(x, self.in_dim, self.n, self.packed[0].device)
        y = kernel_ops.rfnn_network(None, xc, n=self.n,
                                    packed=(self.net, self.packed))
        return y[..., : self.out_dim]

    def n_cells(self) -> int:
        return sum(vp.n_cells + up.n_cells for vp, up in self.plans)


def _recovery_plan(tp: TiledAnalogProgram, dead_tiles,
                   max_dropped_mass: float):
    """The viable :class:`~repro_torch.runtime.elastic.TileRecoveryPlan` of
    ``tp`` around its dead physical positions; raises when none is."""
    from repro_torch.compile import placement as place_lib
    from repro_torch.runtime.elastic import plan_tile_recovery

    pl = tp.placement
    plan = plan_tile_recovery(
        place_lib.tile_sensitivities(place_lib.undo_placement(tp)),
        sorted({(int(o), int(i)) for o, i in dead_tiles}),
        row_perm=pl.row_perm if pl is not None else None,
        col_perm=pl.col_perm if pl is not None else None,
        max_dropped_mass=max_dropped_mass)
    if not plan.viable:
        raise ValueError(f"tile recovery is not viable: {plan.reason}")
    return plan


@dataclasses.dataclass(frozen=True)
class CompiledTiledProgram:
    """The ``lower_tiled`` pass output: the 1 x To x Ti grid's kernel
    inputs, servable.

    ``grid``/``packed`` are the ``ops.pack_tile_grid`` result emitted at
    lower time and handed back on every ``apply`` (``packed=``): serving
    packs nothing.  A placement is undone in ``apply`` by two gathers on
    the digital tile streams.
    """

    out_dim: int
    in_dim: int
    tile: int
    to: int
    ti: int
    plans: tuple                 # [To][Ti] of (v_plan, u_plan)
    tile_args: tuple             # [To][Ti] of kernel argument dicts
    hardware: hw_lib.HardwareModel | None
    grid: DeepGridSchedule       # 1 x To x Ti schedule (static)
    packed: tuple                # (coef_v [1,To,Ti,C,8,P], coef_u, gains)
    # yield-aware placement (compile/placement.py): the kernel runs the
    # physically permuted grid; apply() permutes the digital tile streams
    placement: "object | None" = None
    # optional (tile-row x batch) scale-out: with a DeviceMesh every apply
    # shards through kernels/ops.tiled_apply(mesh=)
    mesh: "object | None" = None
    row_axis: str = "rows"
    data_axis: str = "data"
    # the TiledAnalogProgram this was lowered from: the recovery path
    # re-places and re-lowers it around dead tiles; not part of the kernel
    # contract
    source: "TiledAnalogProgram | None" = dataclasses.field(
        default=None, repr=False, compare=False)

    # -- ServableProgram surface (repro_torch.serving.servable) ---------
    @property
    def n_in(self) -> int:
        return self.in_dim

    @property
    def n_out(self) -> int:
        return self.out_dim

    def recover(self, dead_tiles, hardware: hw_lib.HardwareModel | None
                = None, *, key: int | None = None, draws=None,
                steps: int = 0, max_dropped_mass: float = 0.05,
                **calibrate_kw) -> "CompiledTiledProgram":
        """Recompile this program around dead physical tile positions.

        Plans a remap that parks the least-sensitive logical tiles on the
        dead positions (:func:`repro_torch.runtime.elastic.plan_tile_recovery`),
        then re-places, blanks, re-trims and re-lowers
        (:func:`repro_torch.compile.recover_tiled`).  ``steps`` is the
        re-calibration budget for moved tiles (0 = re-bind only, the
        serving engine's mid-stream default).  Without ``key`` (or
        ``draws``) the moved tiles are re-bound to ``hardware`` with no
        noise draws, as in the JAX package (ROADMAP C-ref8).  Raises when
        the remap would drop more than ``max_dropped_mass`` of the
        sensitivity mass, or when the program carries no ``source``.
        """
        if self.source is None:
            raise ValueError(
                "this CompiledTiledProgram carries no source "
                "TiledAnalogProgram to re-place; re-lower it with "
                "repro_torch.compile.lower_tiled or pass recovery= to the "
                "serving engine")
        from repro_torch.compile import placement as place_lib

        plan = _recovery_plan(self.source, dead_tiles, max_dropped_mass)
        out = place_lib.recover_tiled(
            self.source, plan, self.hardware if hardware is None else hardware,
            key=key, draws=draws, lower=True, steps=steps, **calibrate_kw)
        return dataclasses.replace(out, mesh=self.mesh,
                                   row_axis=self.row_axis,
                                   data_axis=self.data_axis)

    @functools.cached_property
    def _gathers(self):
        """The placement's input and output gathers on the program's
        device, or (None, None) when there is none to undo."""
        pl = self.placement
        if pl is None or pl.is_identity:
            return None, None
        return _perm_indices(self.packed[0].device, pl.col_perm,
                             pl.inv_row_perm)

    def apply(self, x) -> torch.Tensor:
        """``x[..., in_dim]`` -> detected magnitudes ``[..., out_dim]``.

        One tile-grid forward: every input tile sweeps through its row's
        meshes, rows combine coherently, and the detector reads the
        combined magnitude.  A placed program feeds physical column ``pi``
        logical input tile ``col_perm[pi]`` and reads logical output row
        ``r`` from physical row ``inv_row_perm[r]``: two index gathers on
        the digital tile streams, no kernel change.
        """
        xc = _prep_input(x, self.in_dim, self.ti * self.tile,
                         self.packed[0].device)
        cols, rows = self._gathers
        if cols is not None:
            xc = _gather_tiles(xc, cols, self.tile)
        y = kernel_ops.tiled_apply(None, xc, n=self.tile,
                                   packed=(self.grid, self.packed),
                                   mesh=self.mesh, row_axis=self.row_axis,
                                   data_axis=self.data_axis)
        if rows is not None:
            y = _gather_tiles(y, rows, self.tile)
        return y.abs()[..., : self.out_dim]

    def n_cells(self) -> int:
        return sum(vp.n_cells + up.n_cells
                   for row in self.plans for vp, up in row)


@dataclasses.dataclass(frozen=True)
class CompiledDeepProgram:
    """The ``lower_deep`` pass output: a whole multi-layer tiled network,
    one deep-grid launch per apply.

    ``deep``/``packed`` are the ``ops.pack_deep_grid`` result emitted at
    lower time and handed back on every ``apply`` (``packed=``).
    Inter-layer activations stay in the kernel: it re-detects each layer's
    combined row magnitudes and feeds them to the next layer's tiles.

    Placements fold into the packed tensors: layer 0's column placement is
    undone by a digital input gather and the last layer's row placement by
    a digital output gather (as in :class:`CompiledTiledProgram`), while
    every *interior* boundary was resolved at pack time: each layer ``l >=
    1`` packs its tile columns in the physical row order of layer ``l -
    1``'s outputs, so the in-kernel handoff needs no permutation.
    """

    out_dim: int
    in_dim: int
    tile: int
    depth: int
    to: int
    ti: int
    plans: tuple                 # [L][To][Ti] of (v_plan, u_plan)
    layer_args: tuple            # [L][To][Ti] of kernel argument dicts
    hardware: hw_lib.HardwareModel | None
    deep: DeepGridSchedule       # static
    packed: tuple                # (coef_v [L,To,Ti,C,8,P], coef_u, gains)
    # layer 0's placement (input gather) and the last layer's placement
    # (output gather); interior placements are already folded into packed
    in_placement: "object | None" = None
    out_placement: "object | None" = None
    # optional (tile-row x batch) scale-out through deep_apply(mesh=)
    # (depth runs as a chain of single-layer launches)
    mesh: "object | None" = None
    row_axis: str = "rows"
    data_axis: str = "data"
    # the per-layer TiledAnalogPrograms this was lowered from (logical
    # column order, placements attached): the recovery path re-places one
    # layer and re-lowers the cascade; not part of the kernel contract
    sources: "tuple[TiledAnalogProgram, ...] | None" = dataclasses.field(
        default=None, repr=False, compare=False)

    # -- ServableProgram surface (repro_torch.serving.servable) ---------
    @property
    def n_in(self) -> int:
        return self.in_dim

    @property
    def n_out(self) -> int:
        return self.out_dim

    @property
    def placement(self):
        return self.out_placement

    def recover(self, dead_tiles, hardware: hw_lib.HardwareModel | None
                = None, *, layer: int = 0, key: int | None = None,
                draws=None, steps: int = 0, max_dropped_mass: float = 0.05,
                **calibrate_kw) -> "CompiledDeepProgram":
        """Recompile the cascade around dead tiles in one layer's grid.

        ``dead_tiles`` are physical ``(o, i)`` positions in layer
        ``layer``'s grid.  The damaged layer is re-placed, blanked and
        re-trimmed as in :meth:`CompiledTiledProgram.recover`, then the
        whole cascade is re-lowered through ``lower_deep`` so the interior
        placement folding stays consistent.  Needs the program's
        ``sources``.
        """
        if self.sources is None:
            raise ValueError(
                "this CompiledDeepProgram carries no source layer programs "
                "to re-place; re-lower it with repro_torch.compile.lower_deep "
                "or pass recovery= to the serving engine")
        if not 0 <= layer < len(self.sources):
            raise ValueError(f"layer {layer} outside depth "
                             f"{len(self.sources)} cascade")
        from repro_torch.compile import passes as passes_lib
        from repro_torch.compile import placement as place_lib

        tp = self.sources[layer]
        plan = _recovery_plan(tp, dead_tiles, max_dropped_mass)
        recovered = place_lib.recover_tiled(
            tp, plan, self.hardware if hardware is None else hardware,
            key=key, draws=draws, lower=False, steps=steps, **calibrate_kw)
        srcs = (self.sources[:layer] + (recovered,)
                + self.sources[layer + 1:])
        return passes_lib.lower_deep(srcs, mesh=self.mesh,
                                     row_axis=self.row_axis,
                                     data_axis=self.data_axis)

    @functools.cached_property
    def _gathers(self):
        """Layer 0's input gather and the last layer's output gather on the
        program's device (None where that placement is the identity)."""
        pin, pout = self.in_placement, self.out_placement
        return _perm_indices(
            self.packed[0].device,
            None if pin is None or pin.is_identity else pin.col_perm,
            None if pout is None or pout.is_identity else pout.inv_row_perm)

    def apply(self, x) -> torch.Tensor:
        """``x[..., in_dim]`` -> detected magnitudes ``[..., out_dim]``.

        One deep-grid forward: every layer's tiles sweep, rows combine
        coherently, the detector reads each layer's rows and feeds the
        next.
        """
        with trace.span("analog.apply"):
            with trace.span("analog.prep"):
                xc = _prep_input(x, self.in_dim, self.ti * self.tile,
                                 self.packed[0].device)
                cols, rows = self._gathers
                if cols is not None:
                    xc = _gather_tiles(xc, cols, self.tile)
            with trace.span("analog.grid"):
                y = kernel_ops.deep_apply(None, xc, n=self.tile,
                                          packed=(self.deep, self.packed),
                                          readout="magnitude",
                                          mesh=self.mesh,
                                          row_axis=self.row_axis,
                                          data_axis=self.data_axis)
            with trace.span("analog.readout"):
                if rows is not None:
                    y = _gather_tiles(y, rows, self.tile)
                return y[..., : self.out_dim]

    def n_cells(self) -> int:
        return sum(vp.n_cells + up.n_cells
                   for grid in self.plans for row in grid
                   for vp, up in row)
