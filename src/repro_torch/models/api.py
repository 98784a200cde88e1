"""Unified model facade: one object per architecture config.

The JAX package's ``models/api.py`` on torch, for the decoder-LM stack:

    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    loss, metrics = model.loss(params, batch)
    logits, cache = model.prefill(params, batch)
    logits, cache = model.decode_step(params, token, cache, pos)

``pos`` is an int (every row at that position) or an int tensor [B] (each
row at its own position, as the serving engine's slots are).

``batch`` keys: tokens [B,S] int; labels [B,S] int (-1 = masked, already
shifted by the data pipeline); vis_embed [B,n_vis,D] (vlm).  Params live on
the generator's device (CUDA unless the caller gives a CPU generator with
``device="cpu"``).  The encoder-decoder family raises.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device
from repro_torch.models import lm as lm_lib
from repro_torch.models.config import ModelConfig


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked next-token CE in f32.  labels == -1 are masked."""
    mask = labels >= 0
    lab = torch.clamp(labels, min=0).long()
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lab[..., None])[..., 0]
    nll = (lse - gold) * mask
    denom = torch.clamp(mask.sum(), min=1)
    loss = nll.sum() / denom
    acc = ((torch.argmax(logits, -1) == lab) * mask).sum() / denom
    return loss, acc


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def __post_init__(self):
        if self.cfg.family == "encdec":
            raise NotImplementedError(
                "the encoder-decoder family is not ported yet: see ROADMAP A10")
        lm_lib.superblock_layout(self.cfg)  # raises for moe / ssm / hybrid

    # ---------------- init ----------------
    def init(self, generator: torch.Generator, *, device=None) -> dict:
        """Random params drawn from ``generator``, which must live on
        ``device`` (CUDA when None; raises when CUDA is absent): a 1.1B
        model is drawn on the card, never through the host."""
        dev = resolve_device(device)
        if generator.device.type != dev.type:
            raise ValueError(f"the generator lives on {generator.device}, the "
                             f"params go to {dev}: pass a generator there")
        return lm_lib.init_lm(generator, self.cfg)

    # ---------------- evaluation ----------------
    def forward(self, params, batch) -> tuple[torch.Tensor, torch.Tensor]:
        return lm_lib.forward(params, self.cfg, batch["tokens"],
                              batch.get("vis_embed"))

    def loss(self, params, batch) -> tuple[torch.Tensor, dict]:
        logits, aux = self.forward(params, batch)
        if self.cfg.family == "vlm":
            logits = logits[:, self.cfg.n_vis_tokens:]
        ce, acc = cross_entropy(logits, batch["labels"])
        total = ce + self.cfg.router_aux_weight * aux
        return total, {"ce": ce, "acc": acc, "moe_aux": aux}

    # ---------------- serve ----------------
    def prefill(self, params, batch, max_len: int | None = None):
        return lm_lib.prefill(params, self.cfg, batch["tokens"],
                              batch.get("vis_embed"), max_len)

    def decode_step(self, params, token, cache, pos):
        return lm_lib.decode_step(params, self.cfg, token, cache, pos)

    def bind_decode(self, params):
        """The serving engine's decode closure:
        ``step(tokens, cache, pos) -> (logits, cache)``, without autograd;
        ``pos`` an int or an int tensor [B] of per-row positions.

        ``torch.no_grad`` rather than ``inference_mode``: the analog
        projections' pack cache keys on tensor versions, which inference
        tensors do not keep.
        """
        def run(tokens, cache, pos):
            with torch.no_grad():
                return self.decode_step(params, tokens, cache, pos)

        return run

    def init_cache(self, batch: int, max_len: int, *, device=None) -> dict:
        """A zero KV cache on ``device`` (CUDA when None)."""
        return lm_lib.init_lm_cache(self.cfg, batch, max_len,
                                    device=resolve_device(device))

    # ---------------- info ----------------
    def param_count(self) -> int:
        return self.cfg.param_count()

    def active_param_count(self) -> int:
        return self.cfg.active_param_count()
