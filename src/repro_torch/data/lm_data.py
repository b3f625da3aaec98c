"""Synthetic-but-learnable token source (port of ``repro/data/lm_data.py``).

Sequences are drawn from a fixed random first-order Markov chain over the
vocabulary, with the same numpy draws as the JAX package, so a prompt
sampled here equals the JAX package's token for token. Only ``MarkovLM``
is ported; ``batch_iterator`` waits for training (ROADMAP.md A13).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class MarkovLM:
    vocab_size: int
    branch: int = 16          # out-degree per state -> entropy ~ ln(branch)
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.next_tokens = rng.integers(
            0, self.vocab_size, size=(self.vocab_size, self.branch),
            dtype=np.int32)

    def sample(self, rng: np.random.Generator, batch: int,
               seq_len: int) -> np.ndarray:
        toks = np.empty((batch, seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab_size, size=batch)
        choices = rng.integers(0, self.branch, size=(batch, seq_len))
        for t in range(seq_len):
            toks[:, t + 1] = self.next_tokens[toks[:, t], choices[:, t]]
        return toks

    def entropy_floor(self) -> float:
        return float(np.log(self.branch))
