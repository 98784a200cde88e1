"""Unified model facade: one object per architecture config.

The JAX package's ``models/api.py`` on torch: dispatches to the decoder-LM
stack (dense, moe, ssm, hybrid, vlm) or the encoder-decoder stack (encdec)
and owns the loss, so serve steps are family-agnostic:

    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    loss, metrics = model.loss(params, batch)
    logits, cache = model.prefill(params, batch)
    logits, cache = model.decode_step(params, token, cache, pos)

``pos`` is an int (every row at that position) or an int tensor [B] (each
row at its own position, as the serving engine's slots are).

``batch`` keys: tokens [B,S] int; labels [B,S] int (-1 = masked, already
shifted by the data pipeline); vis_embed [B,n_vis,D] (vlm); frames
[B,enc_seq,D] (encdec).  Params live on the generator's device (CUDA unless
the caller gives a CPU generator with ``device="cpu"``).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device
from repro_torch.models import encdec as encdec_lib
from repro_torch.models import lm as lm_lib
from repro_torch.models.config import ModelConfig
from repro_torch.parallel.sharding import constrain, local_call, replicated


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked next-token CE in f32.  labels == -1 are masked.  Under a mesh
    the vocab axis is gathered first and each rank reads its rows' gold
    logits (DTensor's masked gather over a split vocab cannot reduce after
    the label's axis is dropped)."""
    mask = labels >= 0
    lab = torch.clamp(labels, min=0).long()
    if logits.dim() == 3:
        logits = constrain(logits, "batch", "seq", None)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    if hasattr(logits, "placements"):
        lab = replicated(logits.device_mesh, lab).redistribute(
            logits.device_mesh, logits.placements)
    gold = local_call(
        lambda l, i: torch.gather(l, -1, i[..., None])[..., 0],
        (logits, lab), getattr(logits, "placements", None))
    nll = (lse - gold) * mask
    denom = torch.clamp(mask.sum(), min=1)
    loss = nll.sum() / denom
    acc = ((torch.argmax(logits, -1) == lab) * mask).sum() / denom
    return loss, acc


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def __post_init__(self):
        if self.cfg.family != "encdec":
            lm_lib.superblock_layout(self.cfg)  # raises for a bad layout

    @property
    def _encdec(self) -> bool:
        return self.cfg.family == "encdec"

    # ---------------- init ----------------
    def init(self, generator: torch.Generator, *, device=None) -> dict:
        """Random params drawn from ``generator``, which must live on
        ``device`` (CUDA when None; raises when CUDA is absent): a 1.1B
        model is drawn on the card, never through the host."""
        dev = resolve_device(device)
        if generator.device.type != dev.type:
            raise ValueError(f"the generator lives on {generator.device}, the "
                             f"params go to {dev}: pass a generator there")
        if self._encdec:
            return encdec_lib.init_encdec(generator, self.cfg)
        return lm_lib.init_lm(generator, self.cfg)

    def param_specs(self) -> dict:
        """``init``'s tree with a tuple of logical axis names a leaf."""
        if self._encdec:
            return encdec_lib.spec_encdec(self.cfg)
        return lm_lib.spec_lm(self.cfg)

    # ---------------- evaluation ----------------
    def forward(self, params, batch) -> tuple[torch.Tensor, torch.Tensor]:
        if self._encdec:
            return encdec_lib.forward(params, self.cfg, batch["tokens"],
                                      batch["frames"])
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
        if self._encdec:
            return encdec_lib.prefill(params, self.cfg, batch["tokens"],
                                      batch["frames"], max_len)
        return lm_lib.prefill(params, self.cfg, batch["tokens"],
                              batch.get("vis_embed"), max_len)

    def prefill_len(self, n: int) -> int:
        """How many of a prompt head's ``n`` tokens the serving engine's
        batch-1 ``prefill`` takes; it feeds the rest by decode steps, with
        the same result as a decode step per token:

        * vlm and encdec: none (their prefill needs patch embeddings or
          encoder frames, which a request does not carry; an encdec request
          is decoded against an empty cross cache, as the JAX engine does);
        * a capacity MoE layer: none, as the JAX engine admits every
          prompt, since a prefill can drop expert choices that
          token-by-token decode keeps (the dropless MoE keeps them all);
        * an SSM mixer: ``n`` up to ``ssm_chunk``, above it the largest
          multiple of the chunk (``ssm_block`` takes no ragged last chunk);
        * else all ``n``.
        """
        if self.cfg.family in ("vlm", "encdec"):
            return 0
        kinds = [lm_lib.LAYER_KINDS[k]
                 for k in lm_lib.superblock_layout(self.cfg)[1]]
        if not self.cfg.moe_dropless and any(f == "moe" for _, f in kinds):
            return 0
        if any(m == "ssm" for m, _ in kinds) and n > self.cfg.ssm_chunk:
            return n - n % self.cfg.ssm_chunk
        return n

    def decode_step(self, params, token, cache, pos):
        if self._encdec:
            return encdec_lib.decode_step(params, self.cfg, token, cache, pos)
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
        """A zero decode cache on ``device`` (CUDA when None)."""
        dev = resolve_device(device)
        if self._encdec:
            return encdec_lib.init_dec_cache(self.cfg, batch, max_len,
                                             device=dev)
        return lm_lib.init_lm_cache(self.cfg, batch, max_len, device=dev)

    def cache_specs(self) -> dict:
        """``init_cache``'s tree with a tuple of logical axis names a
        leaf."""
        if self._encdec:
            return encdec_lib.spec_dec_cache(self.cfg)
        return lm_lib.spec_lm_cache(self.cfg)

    # ---------------- info ----------------
    def param_count(self) -> int:
        return self.cfg.param_count()

    def active_param_count(self) -> int:
        return self.cfg.active_param_count()
