"""Synthetic LM training data: a deterministic Markov-ish token stream with
learnable structure (so tiny-model training loss visibly drops), packed into
the micro-batched [M, mbg, T] layout the train step consumes.

A copy of ``repro.data.tokens``: the port keeps its own so that it imports
nothing of the JAX package."""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


class SyntheticLM:
    """Order-1 Markov chain over the vocab with a few strong transitions —
    enough signal for loss to fall fast, fully reproducible."""

    def __init__(self, vocab: int, seed: int = 0, concentration: float = 20.0):
        rng = np.random.default_rng(seed)
        self.vocab = vocab
        # sparse-ish rows: each token strongly prefers ~4 successors
        self.next_tokens = rng.integers(0, vocab, size=(vocab, 4))
        self.rng = rng

    def sample(self, n: int) -> np.ndarray:
        out = np.empty(n, np.int32)
        t = int(self.rng.integers(0, self.vocab))
        for i in range(n):
            out[i] = t
            if self.rng.random() < 0.85:
                t = int(self.next_tokens[t, self.rng.integers(0, 4)])
            else:
                t = int(self.rng.integers(0, self.vocab))
        return out


def batches(vocab: int, M: int, mbg: int, T: int, *, seed: int = 0
            ) -> Iterator[Dict[str, np.ndarray]]:
    gen = SyntheticLM(vocab, seed)
    while True:
        flat = gen.sample(M * mbg * (T + 1)).reshape(M, mbg, T + 1)
        yield {"tokens": flat[..., :-1].astype(np.int32),
               "labels": flat[..., 1:].astype(np.int32)}
