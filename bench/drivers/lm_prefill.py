"""Offline long-prompt scoring through the port's ``Model.prefill``: one
greedy token a request.

Set-up makes the weights from the seed and warms each prompt length of the
mix once.  The window sends batches of ``batch`` prompts of one length,
the lengths in the mix's cycle and the token ids from the seed, in a
closed loop: a batch is due when the one before it has its tokens on the
host, and each of its requests' time to first token runs from then until
its token is on the host.  Afterwards a sample of the finished requests
drawn from the seed, with one of the longest, is run through the plain
float32 reference: the served token's logit below the reference's best,
and the last-position logits against the reference's.

Records for the metric readers: ``setup_s``, ``prompt_tokens``,
``window_s``, ``ttft_s`` (one a request), ``flops`` and, with a trace,
``trace`` and ``b9_bound_s`` (one cycle's).
"""

from __future__ import annotations

import numpy as np

from bench import roofline
from bench.drivers import lm_common
from bench.harness import Check, Outcome
from bench.reference import dense_lm as ref

def sample(finished: list, lengths: list, rng: np.random.Generator,
           n_batches: int, per_batch: int) -> list:
    """``(batch, row)`` pairs: ``n_batches`` finished batches, one of them
    of the longest length, and ``per_batch`` rows of each."""
    longest = [k for k, n in enumerate(lengths) if n == max(lengths)]
    first = int(rng.choice(longest))
    rest = [k for k in range(len(finished)) if k != first]
    picked = [first] + [int(k) for k in rng.choice(
        rest, size=min(n_batches - 1, len(rest)), replace=False)]
    rows = finished[0].shape[0]
    return [(k, int(r)) for k in picked
            for r in rng.choice(rows, size=min(per_batch, rows),
                                replace=False)]


def compare(cfg: dict, ctx, requests, mm=None) -> dict:
    """Each request ``(prompt, logits, served token)`` against the
    float32 reference over its prompt: the widest gap by which a served
    token's logit lies below the reference's best, and the largest logit
    error over the reference's largest logit.  ``mm`` (a matmul) puts the
    reference in that precision in the program's place: its logits and its
    first token stand for the program's."""
    torch = ctx.torch
    rp = ref.make_params(cfg, ctx.sub_seed(5), ctx.device)
    gap = err = 0.0
    with torch.no_grad():
        for prompt, logits, token in requests:
            want = ref.forward(rp, cfg, prompt[None], last_only=True)[0]
            if mm is not None:
                logits = ref.forward(rp, cfg, prompt[None], mm=mm,
                                     last_only=True)[0]
                token = int(logits.argmax())
            gap = max(gap, float(want.max() - want[token]))
            err = max(err, float((logits.float() - want).abs().max()
                                 / want.abs().max()))
    return {"served_gap": gap, "logit_err": err}


def control(cfg: dict, traffic: dict, cell: dict, ctx) -> dict:
    """The compared numbers of the reference put in the program's place
    and computed in fp8 (every matmul's operands in float8 e4m3), over
    prompts drawn as the window draws them, as many as a run compares, one
    of them of the longest length."""
    torch = ctx.torch
    batch, cycle = traffic["batch"], traffic["lengths"]
    gen = torch.Generator(device=ctx.device).manual_seed(ctx.sub_seed(7))
    tokens = [torch.randint(0, cfg["vocab_size"], (batch, n), generator=gen,
                            device=ctx.device) for n in cycle]
    rng = np.random.default_rng(ctx.sub_seed(8))
    picks = sample(tokens, list(cycle), rng, traffic["sample_batches"],
                   traffic["sample_rows"])
    return compare(cfg, ctx, [(tokens[kb][row], None, None)
                              for kb, row in picks], mm=ref.fp8_matmul)


def run(cfg: dict, traffic: dict, cell: dict, ctx) -> Outcome:
    torch = ctx.torch
    from repro_torch.models import Model

    ctx.log("program imported")
    batch, cycle = traffic["batch"], traffic["lengths"]
    vocab = cfg["vocab_size"]
    model = Model(lm_common.model_config(cfg, traffic))
    params = ref.make_params(cfg, ctx.sub_seed(5), ctx.device)
    ctx.log("weights made")
    warm = torch.Generator(device=ctx.device).manual_seed(0)
    with torch.no_grad():
        for n in sorted(set(cycle)):
            tok = torch.randint(0, vocab, (batch, n), generator=warm,
                                device=ctx.device)
            model.prefill(params, {"tokens": tok})[0].argmax(-1).cpu()
    ctx.log("prompt lengths warmed")
    gen = torch.Generator(device=ctx.device).manual_seed(ctx.sub_seed(7))
    tokens, logits, served, ttft, lengths = [], [], [], [], []

    def one(k, keep):
        n = cycle[k % len(cycle)]
        due = ctx.now()
        tok = torch.randint(0, vocab, (batch, n), generator=gen,
                            device=ctx.device)
        with torch.no_grad():
            out, _ = model.prefill(params, {"tokens": tok})
            first = out.argmax(-1).cpu()
        done = ctx.now()
        if keep:
            tokens.append(tok)
            logits.append(out)
            served.append(first)
            ttft.extend([done - due] * batch)
            lengths.append(n)

    ctx.window_starts()
    t0, k = ctx.now(), 0
    while ctx.now() - t0 < ctx.seconds:
        one(k, True)
        k += 1
    window_s = ctx.now() - t0
    records = {"setup_s": ctx.setup_s, "prompt_tokens": batch * sum(lengths),
               "window_s": window_s, "ttft_s": ttft,
               "flops": sum(roofline.prefill_flops(cfg, batch, n)
                            for n in lengths)}
    if ctx.trace:
        def traced():
            for j in range(len(cycle)):
                one(j, False)

        records["trace"] = ctx.profile(traced)
        h, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
        hd = cfg["hidden_size"] // h
        bounds = [roofline.bound_s(*roofline.flash_fwd(
            batch, h, kv, n, n, hd, True), roofline.BF16_FLOP_PER_S)
            for n in cycle]
        records["b9_bound_s"] = cfg["num_hidden_layers"] * sum(bounds)
    peak = ctx.peak_bytes()
    del params
    if ctx.cuda:
        torch.cuda.empty_cache()

    # the reference over a sample of the finished requests
    rng = np.random.default_rng(ctx.sub_seed(8))
    picks = sample(tokens, lengths, rng, traffic["sample_batches"],
                   traffic["sample_rows"])
    got = compare(cfg, ctx, [(tokens[kb][row], logits[kb][row],
                              int(served[kb][row])) for kb, row in picks])
    checks = [Check(k, got[k], cell["limits"][k])
              for k in ("served_gap", "logit_err")]
    records["compared"] = len(picks)
    return Outcome(records=records, checks=checks,
                   attempted=batch * len(lengths), failed=0,
                   memory_peak_bytes=peak)
