"""LM training through the port's ``make_train_step`` and AdamW on the
``TokenStream`` feed.

Set-up makes the weights from the seed, builds the one train state and
drives it through its first three steps, the window's own call on the
stream's batches 0-2 (the warm-up), reading each step's loss, the first
step's gradient as the optimizer took it (its first moment over
``1 - b1``) and the parameters' change after the three.  The same state
then trains through the window, batch after batch.  Afterwards the plain
float32 reference follows the first three steps from the same weights and
batches.

Records for the metric readers: ``setup_s``, ``tokens``, ``steps``,
``window_s``, ``step_flops``, ``window_peak_bytes`` and, with a trace,
``trace`` and ``traced_steps``.
"""

from __future__ import annotations

from torch.utils import _pytree as pytree

from bench import roofline
from bench.drivers import lm_common
from bench.harness import Check, Outcome
from bench.reference import dense_lm as ref

def _norms(torch, tree) -> dict:
    with torch.no_grad():
        return {k: float(t.float().norm()) for k, t in
                ref.slices(tree).items()}


def make_feed(cfg: dict, traffic: dict, ctx):
    """``feed(i)``: batch ``i`` of the seed's token stream on the device,
    copied from pinned memory without waiting for the card."""
    from repro_torch.data import TokenStream

    stream = TokenStream(vocab_size=cfg["vocab_size"], seq_len=traffic["seq"],
                         global_batch=traffic["batch"], seed=ctx.sub_seed(6))

    def feed(i):
        out = {}
        for k, v in stream.batch(i).items():
            t = ctx.torch.from_numpy(v)
            out[k] = (t.pin_memory().to(ctx.device, non_blocking=True)
                      if ctx.cuda else t)
        return out

    return feed


def reference_readings(cfg: dict, traffic: dict, ctx, batches, *,
                       mm=None) -> tuple:
    """The reference's three steps from the seed's weights: (losses, the
    first step's clipped gradient norms, the change norms after three)."""
    torch = ctx.torch
    rp = ref.make_params(cfg, ctx.sub_seed(5), ctx.device)
    losses, g1 = ref.train_steps(rp, cfg, batches, traffic["adamw"],
                                 mm=mm or torch.matmul)
    with torch.no_grad():
        change = _norms(torch, pytree.tree_map(
            torch.sub, rp, ref.make_params(cfg, ctx.sub_seed(5),
                                           ctx.device)))
    return losses, g1, change


def compare(got: tuple, want: tuple) -> dict:
    """The three numbers compared: the worst step's relative loss gap and
    the worst leaf's gaps of the first gradient's and of the change's
    norms; a leaf whose reference gradient is under a thousandth of the
    median leaf's moves by round-off alone and is left out of the
    change."""
    (losses, g1, change), (r_losses, r_g1, r_change) = got, want
    median = sorted(r_g1.values())[len(r_g1) // 2]
    still = [k for k, v in r_g1.items() if v < 1e-3 * median]
    grad_gap, grad_leaf = lm_common.norm_gap(g1, r_g1)
    change_gap, change_leaf = lm_common.norm_gap(change, r_change, still)
    return {"loss_gap": max(abs(a - b) / abs(b)
                            for a, b in zip(losses, r_losses)),
            "grad_gap": grad_gap, "change_gap": change_gap,
            "grad_leaf": grad_leaf, "change_leaf": change_leaf,
            "left_out": still}


def control(cfg: dict, traffic: dict, cell: dict, ctx) -> dict:
    """The compared numbers of the reference put in the program's place
    and computed in fp8 (every matmul's operands in float8 e4m3, forward
    and backward), and of the fault that leaves half of each batch out
    (the mean over the rest), each against the float32 reference."""
    feed = make_feed(cfg, traffic, ctx)
    batches = [feed(j) for j in range(3)]
    want = reference_readings(cfg, traffic, ctx, batches)
    fp8 = reference_readings(cfg, traffic, ctx, batches, mm=ref.fp8_matmul)
    half = reference_readings(
        cfg, traffic, ctx, [{k: v[: v.shape[0] // 2] for k, v in b.items()}
                            for b in batches])
    return {"fp8": compare(fp8, want), "half_batch": compare(half, want)}


def run(cfg: dict, traffic: dict, cell: dict, ctx) -> Outcome:
    torch = ctx.torch
    from repro_torch.models import Model
    from repro_torch.optim import AdamW
    from repro_torch.train import TrainState, make_train_step

    ctx.log("program imported")
    hp = traffic["adamw"]
    batch, seq = traffic["batch"], traffic["seq"]
    model = Model(lm_common.model_config(cfg, traffic))
    opt = AdamW(lr=hp["lr"], b1=hp["b1"], b2=hp["b2"], eps=hp["eps"],
                weight_decay=hp["weight_decay"], clip_norm=hp["clip_norm"])
    step = make_train_step(model, opt)
    feed = make_feed(cfg, traffic, ctx)

    params0 = ref.make_params(cfg, ctx.sub_seed(5), ctx.device)
    ctx.log("weights made")
    state = TrainState(params=params0, opt=opt.init(params0))
    losses = []
    for i in range(3):
        state, metrics = step(state, feed(i))
        losses.append(float(metrics["loss"]))
        if i == 0:
            g1 = {k: v / (1 - hp["b1"])
                  for k, v in _norms(torch, state.opt.m).items()}
    with torch.no_grad():
        change = _norms(torch, pytree.tree_map(torch.sub, state.params,
                                               params0))
    del params0, metrics
    ctx.log("three steps read")

    ctx.window_starts()
    t0, i = ctx.now(), 3
    while ctx.now() - t0 < ctx.seconds:
        state, _ = step(state, feed(i))
        i += 1
    ctx.sync()
    window_s = ctx.now() - t0
    steps = i - 3
    records = {"setup_s": ctx.setup_s, "tokens": steps * batch * seq,
               "window_s": window_s, "steps": steps,
               "step_flops": roofline.train_step_flops(cfg, batch, seq),
               "window_peak_bytes": ctx.window_peak_bytes()}
    if ctx.trace:
        def traced():
            nonlocal state, i
            for _ in range(traffic["traced"]):
                with torch.profiler.record_function("bench.feed"):
                    b = feed(i)
                state, _ = step(state, b)
                i += 1

        records["trace"] = ctx.profile(traced)
        records["traced_steps"] = traffic["traced"]
    peak = ctx.peak_bytes()
    del state
    if ctx.cuda:
        torch.cuda.empty_cache()

    # the reference: the same weights and batches, three float32 steps
    want = reference_readings(cfg, traffic, ctx, [feed(j) for j in range(3)])
    got = compare((losses, g1, change), want)
    ctx.log(f"losses {losses} against {want[0]}; worst gradient leaf "
            f"{got['grad_leaf']}, worst change leaf {got['change_leaf']}; "
            f"left out of the change: {got['left_out']}")
    checks = [Check(k, got[k], cell["limits"][k])
              for k in ("loss_gap", "grad_gap", "change_gap")]
    return Outcome(records=records, checks=checks, attempted=steps + 3,
                   failed=0, memory_peak_bytes=peak)
