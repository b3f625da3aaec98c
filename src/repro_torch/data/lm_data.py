"""Synthetic-but-learnable token source (port of ``repro/data/lm_data.py``).

Sequences are drawn from a fixed random first-order Markov chain over the
vocabulary, with the same numpy draws as the JAX package, so a prompt
sampled here, and every batch of ``batch_iterator``, equals the JAX
package's token for token. Placing batches on a mesh and the frontends'
encoder embeddings are not ported (ROADMAP.md A13).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

from ..device import resolve_device


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


def batch_iterator(cfg, *, global_batch: int, seq_len: int,
                   num_workers: Optional[int] = None, seed: int = 1,
                   heterogeneous: bool = False, mesh=None,
                   batch_sharding=None, device=None) -> Iterator[dict]:
    """Yields {"tokens", "labels"} batches of int64 tensors on ``device``
    (``None``: CUDA).

    num_workers given -> worker-chunked layout (M, B/M, L) (scan strategy);
    otherwise flat (B, L). heterogeneous -> each worker samples its OWN
    Markov chain with a different branching factor (non-IID federated
    data; worker 0 has the lowest-entropy source). Requires num_workers.
    The draws are the JAX package's, so the tokens are too."""
    if mesh is not None or batch_sharding is not None:
        raise NotImplementedError("batch_iterator: placing batches on a "
                                  "mesh is not ported yet (ROADMAP.md A13)")
    if cfg.frontend:
        raise NotImplementedError(f"batch_iterator: the {cfg.frontend} "
                                  "frontend's enc_embeddings are not ported "
                                  "yet (ROADMAP.md A13)")
    if heterogeneous and not num_workers:
        raise ValueError("heterogeneous data needs worker chunking "
                         "(num_workers)")
    dev = resolve_device(device)
    if heterogeneous:
        lms = [MarkovLM(cfg.vocab_size, branch=2 ** (1 + i % 5),
                        seed=seed + 100 + i) for i in range(num_workers)]
    else:
        lm = MarkovLM(cfg.vocab_size, seed=seed)
    rng = np.random.default_rng(seed + 1)
    while True:
        if heterogeneous:
            m = num_workers
            per = global_batch // m
            raw = np.stack([lms[i].sample(rng, per, seq_len)
                            for i in range(m)])        # (M, per, L+1)
            tokens, labels = raw[..., :-1], raw[..., 1:]
        else:
            raw = lm.sample(rng, global_batch, seq_len)
            tokens, labels = raw[:, :-1], raw[:, 1:]
            if num_workers:
                m = num_workers
                tokens = tokens.reshape(m, global_batch // m, seq_len)
                labels = labels.reshape(m, global_batch // m, seq_len)
        yield {"tokens": torch.from_numpy(tokens.astype(np.int64)).to(dev),
               "labels": torch.from_numpy(labels.astype(np.int64)).to(dev)}
