"""Serving entry point: prefill + batched decode with a KV cache.

The JAX package's ``launch/serve.py`` on torch: random prompts (with random
patch embeddings for a vlm and random encoder frames for an encdec model),
prefill to build the cache, a greedy (or temperature) decode loop and
per-step latency stats.  The model's weights are random, drawn on the device from ``--seed``;
prompts and sampling draw from their own generators.  Runs on the card
unless ``--device cpu``.

Example:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
        --batch 8 --prompt-len 1024 --gen 32
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.models import Model
from repro_torch.models.config import ModelConfig


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(cfg: ModelConfig, *, batch: int = 4, prompt_len: int = 32,
          gen: int = 32, temperature: float = 0.0, seed: int = 0,
          device=None) -> dict:
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens, then decode
    ``gen`` tokens, with ``Model(cfg).init``'s weights from ``seed`` on
    ``device`` (CUDA when None).

    Returns ``{"tokens": int64 [batch, gen + 1] (the prefill's token, then
    one per decode step), "prefill_s": float, "decode_s": [gen floats],
    "logits_finite": bool (every logit of the prefill and of each step)}``.
    Times are host clock around work that ends in a device synchronize.
    """
    dev = resolve_device(device)
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(seed),
                        device=dev)
    b, s = batch, prompt_len
    data = torch.Generator(device=dev).manual_seed(seed + 1)
    pick = torch.Generator(device=dev).manual_seed(seed + 2)
    inputs = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                      generator=data, device=dev)}
    vis = cfg.n_vis_tokens if cfg.family == "vlm" else 0
    if vis:
        inputs["vis_embed"] = 0.02 * torch.randn(
            (b, vis, cfg.d_model), generator=data, device=dev)
    if cfg.family == "encdec":
        inputs["frames"] = 0.02 * torch.randn(
            (b, cfg.enc_seq, cfg.d_model), generator=data, device=dev)
    max_len = s + vis + gen + 1

    def sample(logits):
        if temperature <= 0:
            return torch.argmax(logits, -1)
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=pick)[:, 0]

    with torch.no_grad():
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, inputs, max_len=max_len)
        _sync(dev)
        prefill_s = time.perf_counter() - t0
        finite = torch.isfinite(logits).all()
        tok = sample(logits)
        out = [tok]
        lat = []
        for i in range(gen):
            t0 = time.perf_counter()
            logits, cache = model.decode_step(params, tok, cache, s + vis + i)
            _sync(dev)
            lat.append(time.perf_counter() - t0)
            finite = finite & torch.isfinite(logits).all()
            tok = sample(logits)
            out.append(tok)
    return {"tokens": torch.stack(out, 1).cpu(), "prefill_s": prefill_s,
            "decode_s": lat, "logits_finite": bool(finite)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = (configs.get_reduced(args.arch) if args.reduced
           else configs.get_config(args.arch))
    res = serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                gen=args.gen, temperature=args.temperature, seed=args.seed,
                device=args.device)
    print(f"prefill[{args.batch}x{args.prompt_len}] "
          f"{res['prefill_s'] * 1e3:.1f} ms")
    lat_ms = np.asarray(res["decode_s"]) * 1e3
    if len(lat_ms):
        print(f"decode: {len(lat_ms)} steps, median {np.median(lat_ms):.2f} "
              f"ms/tok, p99 {np.percentile(lat_ms, 99):.2f} ms")
    gen = res["tokens"].numpy()
    print(f"generated[{gen.shape[0]}x{gen.shape[1]}]: row0 = {gen[0][:16]}...")
    if not (np.isfinite(lat_ms).all() and (gen >= 0).all()
            and res["logits_finite"]):
        raise RuntimeError("non-finite latency or logits, or negative token")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
