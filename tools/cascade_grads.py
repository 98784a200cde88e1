#!/usr/bin/env python3
"""chip_smoke.py phase 13's card-against-CPU check of the 4-layer 64x64
cascade's gradients, at several grid seeds, for this checkout's ``src/``
or another tree's.

    python3 tools/cascade_grads.py [--src DIR] [--label NAME]

For each seed ``s`` in 0..4, the grid is chip_smoke's ``--seed s`` cascade
(``build_deep_grid(..., 40 + s, reck="all")``); ``x`` (complex normal) and
the loss weights ``w`` (normal) at B = 1024 are drawn from seed ``s``.  The
gradients of ``sum(w * ops.deep_apply(...))`` in every tile param and ``x``
are taken on the card (B7, B8) and on the CPU (their plain versions), and
each leaf's max |card - CPU| / max |CPU| is printed beside phase 13's
bound (1e-5 x 16), with the leaf that reads it.  Where the tree's plain
version runs in float64 (``ref.split_channels`` keeps complex128's
precision), three gradients are held against the float64 witness
(chip_smoke's ``cascade_grads(plain_dtype=torch.float64)``): the card's,
the CPU's, and autograd's through the plain forward in float32 (no
rebuild of a column's input from its output), each as the largest leaf's
max |a - b| / max |witness| and as phase 13's reading in units of 2^-24
M_leaf (``chip_smoke.witness_reading``; the card's and the CPU's must stay
at or below ``chip_smoke.WITNESS_C``, and the tool exits 1 where one does
not).  With ``--chain`` the same gradients are also taken through
``ops.deep_apply(mesh=)`` on a 1 x 1 mesh of a one-rank gloo group (chip_smoke
phase 25's per-layer chain of B7 and B8 launches) and held against the
card's fused path, as the largest relative error over the array leaves and
over the tiles' 0-d scales, and against the float64 witness.  Writes the
readings to ``chiprun_out/cascade_grads_<label>.json``.  Needs a CUDA card
and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

BOUND = 1e-5 * 16     # phase 13's: 1e-5 * n of each leaf's largest magnitude
SEEDS = (0, 1, 2, 3, 4)


def leaf_names(tree, prefix=""):
    """Paths of ``tree``'s leaves in ``chip_smoke.tree_map``'s order."""
    if isinstance(tree, dict):
        return [q for k, v in tree.items()
                for q in leaf_names(v, f"{prefix}.{k}")]
    if isinstance(tree, (tuple, list)):
        return [q for i, v in enumerate(tree)
                for q in leaf_names(v, f"{prefix}[{i}]")]
    return [prefix]


def worst(got, want, names):
    """(largest per-leaf relative error, its leaf's name)."""
    errs = [chip_smoke.leaf_rel([a], [b]) for a, b in zip(got, want)]
    k = max(range(len(errs)), key=errs.__getitem__)
    return errs[k], names[k]


def split_worst(got, want):
    """The largest per-leaf relative error over the array leaves and over
    the 0-d leaves (the tiles' scales)."""
    errs = [(chip_smoke.leaf_rel([a], [b]), b.dim() == 0)
            for a, b in zip(got, want)]
    return (max(e for e, scalar in errs if not scalar),
            max(e for e, scalar in errs if scalar))


def one_rank_mesh(work: str):
    """A 1 x 1 ("rows", "data") mesh on a one-rank gloo group."""
    import datetime

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group(chip_smoke.SHARDED_BACKEND,
                            store=dist.FileStore(f"{work}/store", 1), rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    return init_device_mesh("cuda", (1, 1), mesh_dim_names=("rows", "data"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--chain", action="store_true",
                    help="also the per-layer chain of deep_apply(mesh=)")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("cascade_grads: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    import repro_torch.core  # noqa: F401  (first: the kernels import it)
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    card = chip_smoke.card_line()
    if args.chain:
        import tempfile

        work = tempfile.TemporaryDirectory()
        torch.cuda.set_device(0)
        mesh = one_rank_mesh(work.name)
    has_witness = ref.split_channels(torch.zeros(
        1, 2, dtype=torch.complex128))[0].dtype == torch.float64
    rows, failed = [], False
    for s in SEEDS:
        layers, plans, _ = chip_smoke.build_deep_grid(dev, 16, 4, 4, 4, 40 + s,
                                                      reck="all")
        rng = np.random.default_rng(s)
        x = torch.from_numpy((rng.normal(size=(1024, 64))
                              + 1j * rng.normal(size=(1024, 64)))
                             .astype(np.complex64))
        w = torch.from_numpy(rng.normal(size=(1024, 64)).astype(np.float32))
        names = leaf_names(layers) + ["x"]
        grads = {side: chip_smoke.cascade_grads(side, layers, plans, x, w)
                 for side in (dev, "cpu")}
        (y_card, g_card), (y_cpu, g_cpu) = grads[dev], grads["cpu"]
        row = {"label": args.label, "card": card, "seed": s,
               "output_card_vs_cpu": chip_smoke.leaf_rel([y_card], [y_cpu])}
        row["card_vs_cpu"], row["card_vs_cpu_leaf"] = worst(g_card, g_cpu,
                                                            names)
        line = (f"[{args.label}] {card} | seed {s}: output "
                f"{row['output_card_vs_cpu']:.3e}, gradients card vs CPU "
                f"{row['card_vs_cpu']:.3e} at {row['card_vs_cpu_leaf']} "
                f"(bound {BOUND:.1e}: "
                f"{'within' if row['card_vs_cpu'] <= BOUND else 'OVER'}; "
                f"arrays %.3e, 0-d scales %.3e)" % split_worst(g_card, g_cpu))
        if args.chain:
            g_chain = chip_smoke.cascade_grads(dev, layers, plans, x, w,
                                               mesh=mesh)[1]
            row["chain_vs_card_arrays"], row["chain_vs_card_scales"] = \
                split_worst(g_chain, g_card)
            line += (f"; the 1 x 1 chain against the card's fused path: "
                     f"arrays {row['chain_vs_card_arrays']:.3e}, 0-d scales "
                     f"{row['chain_vs_card_scales']:.3e}")
        if has_witness:
            g_wit, g_auto = (chip_smoke.cascade_grads(
                "cpu", layers, plans, x, w, plain_dtype=dt)[1]
                for dt in (torch.float64, torch.float32))
            mags = chip_smoke.witness_magnitudes(layers, plans, x, w)
            line += "; against the float64 witness"
            sides = [("card", g_card), ("cpu", g_cpu),
                     ("cpu_autograd", g_auto)]
            if args.chain:
                sides.append(("chain", g_chain))
            for side, g in sides:
                err, leaf = worst(g, g_wit, names)
                row[f"{side}_vs_float64"] = err
                row[f"{side}_vs_float64_leaf"] = leaf
                per_leaf = [chip_smoke.witness_reading([a], [b], [m])
                            for a, b, m in zip(g, g_wit, mags)]
                k = max(range(len(per_leaf)), key=per_leaf.__getitem__)
                reading = per_leaf[k]
                row[f"{side}_vs_float64_in_u_m"] = reading
                row[f"{side}_vs_float64_in_u_m_leaf"] = names[k]
                line += (f" {side} {err:.3e} at {leaf} ({reading:.1f} x "
                         f"2^-24 M_leaf at {names[k]})")
                if side != "cpu_autograd" and reading > chip_smoke.WITNESS_C:
                    failed = True
            line += f" (bound {chip_smoke.WITNESS_C:.1f} x 2^-24 M_leaf)"
        rows.append(row)
        print(line, flush=True)
    if args.chain:
        torch.distributed.destroy_process_group()
        work.cleanup()
    out = ROOT / "chiprun_out" / f"cascade_grads_{args.label}.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(rows, indent=1))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
