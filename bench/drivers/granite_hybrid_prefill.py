"""Long-document prefill of a Granite 4.0 hybrid (Mamba-2 and attention
layers, each followed by a dropless mixture of experts) through the port's
``Model.prefill``: one greedy token a request.

Set-up makes the weights from the seed and warms each (batch, length) of
the mix once.  The window sends the mix's batches in turn (``batches``:
``[rows, length]`` pairs, every batch the same number of tokens), the
token ids from the seed, in a closed loop: a batch is due when the one
before it has its tokens on the host, and each of its requests' time to
first token runs from then until its token is on the host.  The program
counts its expert choices through its tracing (``repro_torch.runtime.
trace``, counters alone, no spans) over the window: the choices it dropped
are a compared number.  Afterwards a sample of the finished requests
drawn from the seed, with a batch of the longest prompts, is run through
the plain float32 reference: the served token's logit below the
reference's best, the last-position logits against the reference's, and
the state the prefill leaves for decoding (each mamba layer's SSD state
and conv rows, the attention layer's keys and values; each sampled batch
prefilled once more, after the window, for its cache) against the
reference's.

Records for the metric readers: ``setup_s``, ``prompt_tokens``,
``window_s``, ``ttft_s`` (one a request), ``flops``, ``moe_kept`` (choices
a held expert over the window) and, with a trace, ``trace``,
``ssd_bound_s`` and ``b9_bound_s`` (one cycle's).
"""

from __future__ import annotations

import numpy as np

from bench import granite_counts
from bench.harness import Check, Outcome
from bench.reference import granite_hybrid_lm as ref


def model_config(cfg: dict, traffic: dict):
    """The port's ``PatternConfig`` of a ``granitemoehybrid``
    configuration: one super-block of all the layers kept, the held
    experts, the traffic's attention path."""
    from repro_torch.models.config import PatternConfig

    if cfg["hidden_act"] != "silu" or cfg["attention_bias"] \
            or cfg["mamba_proj_bias"]:
        raise ValueError("no path for this activation or projection bias")
    k = ref.dims(cfg)
    return PatternConfig(
        name=cfg["name"], family="hybrid", n_layers=k["layers"],
        d_model=k["d"], n_heads=k["h"], n_kv_heads=k["kv"], head_dim=k["hd"],
        d_ff=cfg["shared_intermediate_size"], vocab_size=k["vocab"],
        norm_eps=cfg["rms_norm_eps"],
        tie_embeddings=cfg["tie_word_embeddings"],
        n_experts=k["e"], top_k=k["top"], d_ff_expert=k["fe"],
        n_shared_experts=1, d_ff_shared=k["fs"], router_aux_weight=0.0,
        ssm_state=k["n"], ssm_headdim=k["hp"],
        ssm_expand=cfg["mamba_expand"], ssm_chunk=cfg["mamba_chunk_size"],
        ssm_conv=k["k"],
        layer_pattern="".join("M" if t == "mamba" else "A"
                              for t in k["types"]),
        embedding_multiplier=cfg["embedding_multiplier"],
        residual_multiplier=cfg["residual_multiplier"],
        logits_scaling=cfg["logits_scaling"],
        attention_multiplier=cfg["attention_multiplier"],
        nope=cfg["position_embedding_type"] == "nope",
        ssm_conv_bias=cfg["mamba_conv_bias"], moe_dropless=True,
        experts_held=k["held"], experts_first=k["first"],
        dtype=cfg["torch_dtype"], attn_impl=traffic["attn_impl"])


def sample(batches: list, rng: np.random.Generator, n_batches: int,
           per_batch: int) -> list:
    """``(batch, row)`` pairs: ``n_batches`` of the finished ``batches``
    (token tensors), one of them of the longest prompts, and up to
    ``per_batch`` rows of each."""
    longest = max(t.shape[1] for t in batches)
    first = int(rng.choice([k for k, t in enumerate(batches)
                            if t.shape[1] == longest]))
    rest = [k for k in range(len(batches)) if k != first]
    picked = [first] + [int(k) for k in rng.choice(
        rest, size=min(n_batches - 1, len(rest)), replace=False)]
    out = []
    for k in picked:
        rows = batches[k].shape[0]
        out += [(k, int(r)) for r in rng.choice(
            rows, size=min(per_batch, rows), replace=False)]
    return out


def _rel(got, want) -> float:
    return float((got.float() - want).abs().max() / want.abs().max())


def cache_rows(cache: dict, rows, length: int) -> list:
    """The program's prefill cache of each of ``rows``: per layer key, its
    leaves without the super-block and batch axes, keys and values cut to
    the prompt's ``length`` (copies, so that the batch's cache can go)."""
    return [{key: {leaf: (t[0, row, :length] if leaf in ("k", "v")
                          else t[0, row]).clone()
                   for leaf, t in layer.items()}
             for key, layer in cache.items()} for row in rows]


def compare(cfg: dict, ctx, params: dict, requests, mm=None) -> dict:
    """Each request ``(prompt, logits, served token, cache)`` against the
    float32 reference over its prompt (its SSD in the chunked form on the
    card, step by step elsewhere): the widest gap by which a served token's
    logit lies below the reference's best, the largest logit error over
    the reference's largest logit, and the largest error of a leaf of the
    prefill's cache (:func:`cache_rows`) over that leaf's largest
    magnitude.  ``mm`` (a matmul) puts the reference in that precision in
    the program's place: its logits, its first token and its cache stand
    for the program's."""
    torch = ctx.torch
    gap = err = state = 0.0
    with torch.no_grad():
        for prompt, logits, token, states in requests:
            want_states: dict = {}
            want = ref.forward(params, cfg, prompt[None], last_only=True,
                               chunked=ctx.cuda, cache=want_states)[0]
            if mm is not None:
                states = {}
                logits = ref.forward(params, cfg, prompt[None], mm=mm,
                                     last_only=True, chunked=ctx.cuda,
                                     cache=states)[0]
                token = int(logits.argmax())
                states = {key: {leaf: t[0] for leaf, t in layer.items()}
                          for key, layer in states.items()}
            gap = max(gap, float(want.max() - want[token]))
            err = max(err, _rel(logits, want))
            state = max([state] + [
                _rel(states[key][leaf], t[0])
                for key, layer in want_states.items()
                for leaf, t in layer.items()])
            del want_states, states
    return {"served_gap": gap, "logit_err": err, "state_err": state}


def _tokens(ctx, gen, vocab: int, shape):
    return ctx.torch.randint(0, vocab, shape, generator=gen,
                             device=ctx.device)


def control(cfg: dict, traffic: dict, cell: dict, ctx) -> dict:
    """The compared numbers of the reference put in the program's place
    and computed in fp8 (every matmul's operands in float8 e4m3), over
    prompts drawn as the window draws them, as many as a run compares, one
    batch of them of the longest prompts."""
    torch = ctx.torch
    gen = torch.Generator(device=ctx.device).manual_seed(ctx.sub_seed(7))
    batches = [_tokens(ctx, gen, cfg["vocab_size"], tuple(shape))
               for shape in traffic["batches"]]
    rng = np.random.default_rng(ctx.sub_seed(8))
    picks = sample(batches, rng, traffic["sample_batches"],
                   traffic["sample_rows"])
    params = ref.make_params(cfg, ctx.sub_seed(5), ctx.device)
    got = compare(cfg, ctx, params, [(batches[kb][row], None, None, None)
                                     for kb, row in picks],
                  mm=ref.fp8_matmul)
    return {**got, "dropped_choices": 0.0}


def run(cfg: dict, traffic: dict, cell: dict, ctx) -> Outcome:
    torch = ctx.torch
    from repro_torch.models import Model
    from repro_torch.runtime import trace

    ctx.log("program imported")
    cycle = [tuple(shape) for shape in traffic["batches"]]
    vocab = cfg["vocab_size"]
    model = Model(model_config(cfg, traffic))
    params = ref.make_params(cfg, ctx.sub_seed(5), ctx.device)
    ctx.log("weights made")
    warm = torch.Generator(device=ctx.device).manual_seed(0)
    with torch.no_grad():
        for shape in sorted(set(cycle)):
            tok = _tokens(ctx, warm, vocab, shape)
            model.prefill(params, {"tokens": tok})[0].argmax(-1).cpu()
    ctx.log("prompt shapes warmed")
    gen = torch.Generator(device=ctx.device).manual_seed(ctx.sub_seed(7))
    tokens, logits, served, ttft = [], [], [], []

    def one(k, keep):
        shape = cycle[k % len(cycle)]
        due = ctx.now()
        tok = _tokens(ctx, gen, vocab, shape)
        with torch.no_grad():
            out, _ = model.prefill(params, {"tokens": tok})
            first = out.argmax(-1).cpu()
        done = ctx.now()
        if keep:
            tokens.append(tok)
            logits.append(out)
            served.append(first)
            ttft.extend([done - due] * shape[0])

    trace.drain()
    trace.enable(spans=False)
    ctx.window_starts()
    t0, k = ctx.now(), 0
    while ctx.now() - t0 < ctx.seconds:
        one(k, True)
        k += 1
    window_s = ctx.now() - t0
    trace.disable()
    counts = trace.drain().counters
    dropped = counts.get("moe.dropped")
    kept = counts.get("moe.kept")
    records = {"setup_s": ctx.setup_s,
               "prompt_tokens": sum(t.numel() for t in tokens),
               "window_s": window_s, "ttft_s": ttft,
               "flops": sum(granite_counts.prefill_flops(cfg, *t.shape)
                            for t in tokens),
               "moe_kept": None if kept is None else kept.tolist()}
    if ctx.trace:
        def traced():
            for j in range(len(cycle)):
                one(j, False)

        records["trace"] = ctx.profile(traced)
        records["ssd_bound_s"] = sum(granite_counts.ssd_bound_s(cfg, *shape)
                                     for shape in cycle)
        records["b9_bound_s"] = sum(granite_counts.b9_bound_s(cfg, *shape)
                                    for shape in cycle)
    peak = ctx.peak_bytes()
    if ctx.cuda:
        torch.cuda.empty_cache()

    # the reference over a sample of the finished requests; each sampled
    # batch prefilled once more for the cache that the window let go
    rng = np.random.default_rng(ctx.sub_seed(8))
    picks = sample(tokens, rng, traffic["sample_batches"],
                   traffic["sample_rows"])
    states = {}
    for kb in dict.fromkeys(kb for kb, _ in picks):
        rows = [row for b, row in picks if b == kb]
        with torch.no_grad():
            _, cache = model.prefill(params, {"tokens": tokens[kb]})
        states.update(zip([(kb, row) for row in rows],
                          cache_rows(cache, rows, tokens[kb].shape[1])))
        del cache
    got = compare(cfg, ctx, params, [(tokens[kb][row], logits[kb][row],
                                      int(served[kb][row]), states[kb, row])
                                     for kb, row in picks])
    # no count from the program is a failed check, not a zero
    got["dropped_choices"] = (float("nan") if dropped is None
                              else float(dropped))
    checks = [Check(k, got[k], cell["limits"][k])
              for k in ("served_gap", "logit_err", "state_err",
                        "dropped_choices")]
    records["compared"] = len(picks)
    return Outcome(records=records, checks=checks,
                   attempted=sum(t.shape[0] for t in tokens), failed=0,
                   memory_peak_bytes=peak)
