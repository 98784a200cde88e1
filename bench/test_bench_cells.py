"""Each cell's run, its timed path and reference check included, on the CPU
at a reduced size: sound, it comes out correct; with the timed path broken
underneath (each fault the cell can have), ``correct`` comes out false.
The look for a card is skipped: the run is driven from ``run_cell``."""

import time

import pytest
import torch

from bench import harness

# float32 compute at the reduced size: the cells' limits are set for bf16
# at the published widths, whose errors average over wider sums
SMALL_LM = {"num_hidden_layers": 2, "hidden_size": 64,
            "num_attention_heads": 4, "num_key_value_heads": 2,
            "intermediate_size": 128, "vocab_size": 512,
            "torch_dtype": "float32"}
SMALL = {
    "rfnn64-infer-64k": ({"width": 16, "tile": 4},
                         {"rows": 256, "pool": 2, "keep_every": 2}),
    "granite-train-8x512": (SMALL_LM, {"batch": 2, "seq": 32}),
    "granite-prefill-mix": (SMALL_LM, {"batch": 2,
                                       "lengths": [32, 64, 32, 96],
                                       "sample_batches": 2,
                                       "sample_rows": 2}),
}


def run_small(cell: str, seconds: float = 0.2) -> harness.Outcome:
    spec = harness.cell_spec(cell)
    cfg, traffic = SMALL[cell]
    spec["config"].update(cfg)
    spec["traffic"].update(traffic)
    ctx = harness.RunContext("cpu", 2**31 + 11, seconds, False,
                             time.perf_counter())
    return harness.run_cell(spec, ctx)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_sound_run_is_correct(cell):
    out = run_small(cell)
    assert out.correct, out.checks
    assert out.attempted > 0 and out.failed == 0


def _analog_half_rows(monkeypatch):
    from repro_torch.compile.program import CompiledDeepProgram

    orig = CompiledDeepProgram.apply

    def apply(self, x):
        half = x.shape[0] // 2
        y = orig(self, x[:half])
        return torch.cat([y, torch.zeros_like(y)])

    monkeypatch.setattr(CompiledDeepProgram, "apply", apply)


def _analog_altered_answer(monkeypatch):
    from repro_torch.compile.program import CompiledDeepProgram

    orig = CompiledDeepProgram.apply

    def apply(self, x):
        y = orig(self, x)
        y[0] = y[1]
        return y

    monkeypatch.setattr(CompiledDeepProgram, "apply", apply)


def _prefill_half_batch(monkeypatch):
    from repro_torch.models import Model

    orig = Model.prefill

    def prefill(self, params, batch, max_len=None):
        tok = batch["tokens"]
        logits, cache = orig(self, params, {"tokens": tok[: len(tok) // 2]})
        return torch.cat([logits, logits]), cache

    monkeypatch.setattr(Model, "prefill", prefill)


def _prefill_altered_token(monkeypatch):
    from repro_torch.models import Model

    orig = Model.prefill

    def prefill(self, params, batch, max_len=None):
        logits, cache = orig(self, params, batch, max_len)
        logits[:, 7] += 100.0
        return logits, cache

    monkeypatch.setattr(Model, "prefill", prefill)


def _train_state_unchanged(monkeypatch):
    from repro_torch.optim import AdamW

    def update(self, params, grads, state):
        zero = torch.zeros((), device=state.step.device)
        return params, type(state)(step=state.step + 1, m=state.m,
                                   v=state.v), zero

    monkeypatch.setattr(AdamW, "update", update)


def _train_half_batch(monkeypatch):
    from repro_torch.models import Model

    orig = Model.loss

    def loss(self, params, batch):
        half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        return orig(self, params, half)

    monkeypatch.setattr(Model, "loss", loss)


FAULTS = {
    "analog-half-rows": ("rfnn64-infer-64k", _analog_half_rows),
    "analog-altered-answer": ("rfnn64-infer-64k", _analog_altered_answer),
    "prefill-half-batch": ("granite-prefill-mix", _prefill_half_batch),
    "prefill-altered-token": ("granite-prefill-mix", _prefill_altered_token),
    "train-state-unchanged": ("granite-train-8x512", _train_state_unchanged),
    "train-half-batch": ("granite-train-8x512", _train_half_batch),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    cell, plant = FAULTS[fault]
    plant(monkeypatch)
    out = run_small(cell)
    assert not out.correct, out.checks
