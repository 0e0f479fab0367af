"""Synthetic LM token pipeline — deterministic, seeded, shard-friendly.

Produces an endless stream of [global_batch, seq] int32 token batches with a
Zipf-ish marginal over the vocab (so the CE loss has realistic structure)
plus a simple Markov backbone (so the loss can actually go down in the
end-to-end training example).  Entirely on host (numpy).  A copy of the JAX
package's ``repro/data/lm.py``: the same seed gives the same tokens.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np


class TokenStream:
    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0,
                 n_states: int = 64):
        self.vocab = vocab
        self.batch = batch
        self.seq = seq
        self.rng = np.random.default_rng(seed)
        self.step = 0
        # Markov chain over n_states hidden states, each emitting a Zipf slice
        self.n_states = n_states
        self.trans = self.rng.dirichlet(np.ones(n_states) * 0.3, size=n_states)
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        zipf = 1.0 / ranks
        self.emit_base = zipf / zipf.sum()

    def __iter__(self) -> Iterator[np.ndarray]:
        return self

    def __next__(self) -> np.ndarray:
        rng = np.random.default_rng((self.step * 2654435761) & 0x7FFFFFFF)
        self.step += 1
        out = np.empty((self.batch, self.seq), dtype=np.int32)
        state = rng.integers(0, self.n_states, size=self.batch)
        # vectorized over batch, sequential over seq (host-cheap)
        for t in range(self.seq):
            shift = state * 37 % self.vocab
            u = rng.random(self.batch)
            # inverse-CDF sample from the Zipf marginal (shared CDF)
            if t == 0:
                self._cdf = np.cumsum(self.emit_base)
            tok = np.searchsorted(self._cdf, u)
            out[:, t] = (tok + shift) % self.vocab
            nxt = rng.random(self.batch)
            cum = np.cumsum(self.trans[state], axis=1)
            state = (cum < nxt[:, None]).sum(axis=1).clip(0, self.n_states - 1)
        return out


def token_batch(vocab: int, batch: int, seq: int, seed: int = 0) -> np.ndarray:
    """One deterministic batch (for tests/smokes)."""
    return next(TokenStream(vocab, batch, seq, seed))
