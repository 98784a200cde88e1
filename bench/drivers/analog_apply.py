"""Offline inference through a compiled multi-layer analog program.

Set-up compiles the program from the seeded targets through the port's
passes (``synthesize_tiled`` -> ``program_tiled`` -> placement ->
``calibrate_tiled(steps=0)`` -> ``lower_deep``) and fills a pool of input
blocks on the device.  The window applies blocks of ``rows`` rows, cycled
from the pool, in a closed loop with ``in_flight`` applies dispatched
ahead.  Afterwards a sample of the window's outputs, drawn from the seed
(one apply in ``keep_every``, and the last), is held against the plain
reference.

Records for the metric readers: ``setup_s``, ``rows``, ``applies``,
``window_s``, ``apply_flops``, ``apply_host_s`` (mean host seconds an
apply's enqueue takes), ``b6_bound_s`` (a launch's) and, with a trace,
``trace``.
"""

from __future__ import annotations

import collections

from bench import roofline
from bench.harness import Check, Outcome
from bench.reference import analog_deep as ref

def build_program(cfg: dict, inputs: dict, device):
    """The compiled cascade, through the port's compiler passes."""
    from repro_torch import compile as C
    from repro_torch.core.hardware import HardwareModel

    hw = HardwareModel(**ref.hardware(cfg))
    tile, grid = cfg["tile"], cfg["width"] // cfg["tile"]
    progs = []
    for l, (w, key, perm) in enumerate(zip(inputs["targets"], inputs["keys"],
                                           inputs["perms"])):
        tp = C.program_tiled(C.synthesize_tiled(w, tile, device=device),
                             method=cfg["method"])
        kind = cfg["placement"][l]
        placement = None
        if kind == "yield":
            scores = C.position_yield_scores(grid, grid, hw, key=key,
                                             tile=tile, device=device)
            placement = C.plan_placement(C.tile_sensitivities(tp), scores)
        elif kind == "seeded":
            placement = C.TilePlacement(*perm)
        if placement is not None and not placement.is_identity:
            tp = C.apply_placement(tp, placement)
        progs.append(C.calibrate_tiled(tp, hw, key=key,
                                       steps=cfg["calibrate_steps"]))
    return C.lower_deep(progs)


def make_pool(cfg: dict, traffic: dict, ctx):
    """The window's input blocks, drawn on the device from the seed."""
    torch = ctx.torch
    gen = torch.Generator(device=ctx.device).manual_seed(ctx.sub_seed(3))
    return torch.randn((traffic["pool"], traffic["rows"], cfg["width"]),
                       generator=gen, device=ctx.device)


def control(cfg: dict, traffic: dict, cell: dict, ctx) -> dict:
    """The compared number of the reference put in the program's place
    and computed in TF32 (the precision below float32 with TF32 off), on
    every block of the pool."""
    mats = ref.layer_matrices(cfg, ref.make_inputs(cfg, ctx.seed))
    pool = make_pool(cfg, traffic, ctx)
    return {"rel_err": max(ref.relative_error(ref.forward(mats, x, "tf32"),
                                              ref.forward(mats, x))
                           for x in pool)}


def run(cfg: dict, traffic: dict, cell: dict, ctx) -> Outcome:
    rows, width = traffic["rows"], cfg["width"]
    inputs = ref.make_inputs(cfg, ctx.seed)
    ctx.log("inputs drawn")
    prog = build_program(cfg, inputs, ctx.device)
    ctx.log("program compiled")
    pool = make_pool(cfg, traffic, ctx)
    for j in range(2):                       # warm the cell's one shape
        prog.apply(pool[j % len(pool)])
    ctx.log("pool made, apply warmed")
    keep_every = traffic["keep_every"]
    offset = ctx.sub_seed(4) % keep_every
    spans, kept = [], {}

    def window(n_applies=None):
        """Applies until the window's seconds (or ``n_applies``) are up;
        returns the applies made and the seconds they took."""
        marks = collections.deque()
        k, t0 = 0, ctx.now()
        while (k < n_applies if n_applies is not None
               else ctx.now() - t0 < ctx.seconds):
            if len(marks) == traffic["in_flight"]:
                ctx.wait(marks.popleft())
            h0 = ctx.now()
            y = prog.apply(pool[k % len(pool)])
            spans.append(ctx.now() - h0)
            marks.append(ctx.mark())
            if n_applies is None and (k % keep_every == offset):
                kept[k] = y
            k += 1
        ctx.sync()
        if n_applies is None:
            kept[k - 1] = y
        return k, ctx.now() - t0

    ctx.window_starts()
    applies, window_s = window()
    records = {"setup_s": ctx.setup_s, "rows": applies * rows,
               "window_s": window_s, "applies": applies}
    flops, nbytes = roofline.deep_grid_fwd(rows, cfg["layers"],
                                           width // cfg["tile"],
                                           width // cfg["tile"], cfg["tile"])
    records["apply_flops"] = flops
    records["b6_bound_s"] = roofline.bound_s(flops, nbytes,
                                             roofline.FP32_FLOP_PER_S)
    records["apply_host_s"] = sum(spans) / len(spans)
    if ctx.trace:
        records["trace"] = ctx.profile(lambda: window(traffic["traced"]))
    peak = ctx.peak_bytes()
    del prog

    # the reference, after the window: every kept output against |M x|
    mats = ref.layer_matrices(cfg, inputs)
    err = 0.0
    for k, y in kept.items():
        want = ref.forward(mats, pool[k % len(pool)])
        err = max(err, ref.relative_error(y, want))
    checks = [Check("rel_err", err, cell["limits"]["rel_err"])]
    records["compared"] = len(kept)
    return Outcome(records=records, checks=checks, attempted=applies,
                   failed=0, memory_peak_bytes=peak)
