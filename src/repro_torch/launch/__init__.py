"""Entry points: ``serve`` (prefill + batched decode of an LM), ``train``
(the LM training driver) and ``mesh`` (the production mesh factory)."""
