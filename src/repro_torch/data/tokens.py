"""Deterministic synthetic LM token stream.

numpy only: a copy of the JAX package's ``data/tokens.py``, so that batch
``i`` of this stream is that stream's batch ``i``, bit for bit.

Design goals for production parity:
  * **stateless addressing**: batch ``i`` is a pure function of (seed, i),
    so restart-from-checkpoint is exact: resume at ``step`` and the stream
    continues as if never interrupted;
  * **host sharding**: each host materializes only its slice of the global
    batch (``host_id``/``num_hosts``);
  * **structured, learnable content**: a tiny hidden Markov generator (not
    iid noise), so a few hundred training steps show a real loss curve.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.runtime import trace


@dataclasses.dataclass
class TokenStream:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_id: int = 0
    num_hosts: int = 1
    n_states: int = 8

    def __post_init__(self):
        if self.global_batch % self.num_hosts:
            raise ValueError("global_batch must divide evenly across hosts")
        rng = np.random.default_rng(self.seed)
        v, k = self.vocab_size, self.n_states
        # sticky-state HMM over vocab blocks: learnable bigram structure
        self.trans = 0.85 * np.eye(k) + 0.15 / k
        self.trans /= self.trans.sum(1, keepdims=True)
        block = max(1, v // k)
        self.state_lo = np.arange(k) * block % v
        self.state_hi = np.minimum(self.state_lo + block, v)
        self.cum_trans = np.cumsum(self.trans, axis=1)

    @property
    def local_batch(self) -> int:
        return self.global_batch // self.num_hosts

    def _gen_row(self, rng: np.random.Generator) -> np.ndarray:
        s = int(rng.integers(self.n_states))
        out = np.empty(self.seq_len + 1, np.int32)
        u = rng.random(self.seq_len + 1)
        pick = rng.random(self.seq_len + 1)
        for t in range(self.seq_len + 1):
            s = int(np.searchsorted(self.cum_trans[s], u[t]))
            lo, hi = self.state_lo[s], self.state_hi[s]
            out[t] = lo + int(pick[t] * (hi - lo))
        return out

    def batch(self, step: int) -> dict:
        """The local shard of global batch ``step`` (tokens + shifted labels)."""
        with trace.span("data.batch"):
            rows = []
            base = step * self.global_batch + self.host_id * self.local_batch
            for r in range(self.local_batch):
                rng = np.random.default_rng((self.seed, base + r))
                rows.append(self._gen_row(rng))
            arr = np.stack(rows)
            return {"tokens": arr[:, :-1].astype(np.int32),
                    "labels": arr[:, 1:].astype(np.int32)}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1
