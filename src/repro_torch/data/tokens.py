"""Deterministic synthetic token pipeline (LM training substrate).

Markov-chain corpus with a power-law unigram distribution — enough structure
that the loss demonstrably falls during the example runs, fully deterministic
per (seed, step) so restarts resume mid-epoch exactly (the iterator is
stateless: batch i is a pure function of (seed, i), the fault-tolerance
property a production data pipeline needs).

A verbatim NumPy copy of repro/data/tokens.py; tests/test_torch_host.py
holds its batches bit for bit to the reference's.
"""

from __future__ import annotations

import numpy as np


class SyntheticTokens:
    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, order_states: int = 512):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        rng = np.random.default_rng(seed)
        # hidden Markov transition over a reduced state space, projected to
        # the vocab with a power-law emission
        self.n_states = min(order_states, vocab_size)
        self.trans = rng.dirichlet(
            np.full(self.n_states, 0.1), size=self.n_states
        ).astype(np.float32)
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        zipf = 1.0 / ranks ** 1.1
        self.emit_base = (zipf / zipf.sum()).astype(np.float64)

    def batch(self, step: int) -> dict:
        """Batch `step` as {tokens: [B, S] int32} — pure function of inputs."""
        rng = np.random.default_rng((self.seed, step))
        b, s = self.global_batch, self.seq_len
        states = rng.integers(0, self.n_states, size=b)
        out = np.empty((b, s), dtype=np.int32)
        # vectorised over batch: one transition draw per position
        for t in range(s):
            u = rng.random(b)
            cdf = np.cumsum(self.trans[states], axis=1)
            states = (u[:, None] < cdf).argmax(axis=1)
            # emission: state biases a contiguous vocab bucket
            bucket = (states * (self.vocab_size // self.n_states)) % self.vocab_size
            offset = rng.choice(
                min(self.vocab_size, 1024), size=b, p=None
            )
            out[:, t] = (bucket + offset) % self.vocab_size
        return {"tokens": out}
