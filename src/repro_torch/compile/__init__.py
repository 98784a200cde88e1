"""Analog program compiler: digital weights -> servable mesh programs (the
counterpart of the JAX package's ``repro.compile``).

The paper's digital->analog transfer (Sec. IV-B, Fig. 11) as a pass
pipeline over a small IR:

    prog = synthesize([w1, w2, ...])       # SVD factorization (Eq. 31)
    prog = program(prog, method="reck")    # or the kernel-backed "fit"
    prog = quantize(prog, "table1")        # Table-I phase snapping
    prog = calibrate(prog, PROTOTYPE, key=7)   # hardware-in-the-loop trim
    compiled = lower(prog)                 # deep-grid tensors, pre-packed
    y = compiled.apply(x)                  # one B6 launch

Matrices larger than one mesh take the tiled pipeline (Sec. V scale-up):
a (To x Ti) grid of tile-sized processors, every pass running per tile:

    tp = synthesize_tiled(w64, tile=16)    # 64x64 -> 4x4 grid of 16x16
    tp = program_tiled(tp, method="reck")
    tp = quantize_tiled(tp, "table1")
    tp = calibrate_tiled(tp, PROTOTYPE, key=7)
    compiled = lower_tiled(tp)
    y = compiled.apply(x)                  # one B6 launch

A cascade of tile grids lowers onto one deep-grid pack:
``lower_deep([tp1, tp2, ...]).apply(x)`` is one B6 launch for the whole
network.  Yield-aware placement and tile recovery:

    scores = position_yield_scores(tp.to, tp.ti, PROTOTYPE, key=7, tile=16)
    tp = apply_placement(tp, plan_placement(tile_sensitivities(tp), scores))
    tp = calibrate_tiled(tp, PROTOTYPE, key=7)  # binds per-position draws
    compiled = lower_tiled(tp)                  # apply() undoes the perm
    compiled = compiled.recover(dead_tiles)     # remap around dead tiles

Every pass runs on the device its program was synthesized for
(``device=`` of ``synthesize``; CUDA when None, ``"cpu"`` for the plain
versions of the kernels).
"""

from repro_torch.compile.passes import (
    calibrate,
    calibrate_tiled,
    inv_softplus,
    logit,
    lower,
    lower_deep,
    lower_tiled,
    program,
    program_tiled,
    quantize,
    quantize_tiled,
    resolve_codebook,
    synthesize,
    synthesize_tiled,
)
from repro_torch.compile.placement import (
    TilePlacement,
    apply_placement,
    blank_tile,
    plan_placement,
    position_yield_scores,
    recover_tiled,
    tile_sensitivities,
    undo_placement,
)
from repro_torch.compile.program import (
    AnalogProgram,
    CompiledDeepProgram,
    CompiledProgram,
    CompiledTiledProgram,
    ProgramLayer,
    TiledAnalogProgram,
    layer_matrix,
    program_error,
)

__all__ = [
    "AnalogProgram", "CompiledDeepProgram", "CompiledProgram",
    "CompiledTiledProgram",
    "ProgramLayer", "TiledAnalogProgram", "TilePlacement",
    "apply_placement", "blank_tile", "calibrate", "calibrate_tiled",
    "inv_softplus", "layer_matrix", "logit", "lower", "lower_deep",
    "lower_tiled", "plan_placement",
    "position_yield_scores", "program", "program_tiled", "program_error",
    "quantize", "quantize_tiled", "recover_tiled", "resolve_codebook",
    "synthesize", "synthesize_tiled", "tile_sensitivities",
    "undo_placement",
]
