"""Synthetic token data pipeline: deterministic, shardable, epoch-aware.

Generates language-model batches (tokens, labels, positions) with a mixture
of repeated n-gram structure so a small model shows a real, decreasing loss
(pure-uniform tokens would pin the loss at log V).  numpy only, a copy of
the reference's ``training/data.py``: its batches are bit-identical to the
reference's for every ``(seed, step)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np

from repro_torch.models.config import ModelConfig


@dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    ngram_order: int = 3
    n_patterns: int = 2048

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # latent markov chain over a restricted token subset
        self.table = rng.integers(0, self.vocab_size,
                                  (self.n_patterns,), dtype=np.int64)
        self.trans = rng.integers(0, self.n_patterns,
                                  (self.n_patterns, 4), dtype=np.int64)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(self.seed * 100003 + step)
        B, S = self.batch_size, self.seq_len
        state = rng.integers(0, self.n_patterns, (B,))
        toks = np.empty((B, S + 1), np.int64)
        for t in range(S + 1):
            toks[:, t] = self.table[state]
            branch = rng.integers(0, 4, (B,))
            state = self.trans[state, branch]
        positions = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32),
                "positions": positions}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def make_pipeline(cfg: ModelConfig, seq_len: int, batch_size: int,
                  seed: int = 0) -> SyntheticLM:
    return SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq_len,
                       batch_size=batch_size, seed=seed)
