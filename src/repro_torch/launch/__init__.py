"""Entry points: ``serve`` (prefill + batched decode of an LM)."""
