"""Deterministic synthetic LM token pipeline (seekable, shardable).

This package's own numpy copy of the JAX package's ``data/tokens.py``: the
same (seed, step, shard) gives the same batch, bit for bit, in both.

  - *deterministic & seekable*: batch(step) is a pure function of
    (seed, step, shard) — resume after preemption replays the exact stream
    (no data loss / duplication), the property distributed trainers need;
  - *shardable*: each data-parallel rank materializes only its slice;
  - *learnable*: tokens follow a sparse first-order Markov chain (Zipf
    marginals, high-probability successor table), so a real model's loss
    drops well below uniform.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class MarkovLM:
    vocab: int
    seed: int = 0
    branch: int = 4          # successors per token
    temp: float = 0.3        # lower = more deterministic transitions

    def _tables(self):
        rng = np.random.default_rng(self.seed)
        succ = rng.integers(0, self.vocab, size=(self.vocab, self.branch))
        logits = rng.standard_normal((self.vocab, self.branch)) / self.temp
        probs = np.exp(logits - logits.max(axis=1, keepdims=True))
        probs /= probs.sum(axis=1, keepdims=True)
        return succ, probs

    def batch(self, step: int, batch_size: int, seq_len: int,
              shard: int = 0, n_shards: int = 1):
        """Returns {"tokens" [b, S] i32, "labels" [b, S] i32} for this shard."""
        if batch_size % n_shards:
            raise ValueError(f"batch_size {batch_size} does not split "
                             f"into {n_shards} shards")
        b_local = batch_size // n_shards
        succ, probs = self._tables()
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 4096 + shard)
        tok = np.empty((b_local, seq_len + 1), np.int32)
        tok[:, 0] = rng.integers(0, self.vocab, size=b_local)
        u = rng.random((b_local, seq_len))
        pick = rng.random((b_local, seq_len))
        for t in range(seq_len):
            cur = tok[:, t]
            # with prob .9 follow the chain, else uniform resample
            cum = np.cumsum(probs[cur], axis=1)
            j = (pick[:, t][:, None] > cum).sum(axis=1).clip(0, self.branch - 1)
            nxt = succ[cur, j]
            rand = rng.integers(0, self.vocab, size=b_local)
            tok[:, t + 1] = np.where(u[:, t] < 0.9, nxt, rand)
        return {"tokens": tok[:, :-1], "labels": tok[:, 1:].copy()}


def random_batch(step: int, batch_size: int, seq_len: int, vocab: int,
                 seed: int = 0):
    """Plain uniform tokens (for lowering / smoke tests)."""
    rng = np.random.default_rng(seed * 7_919 + step)
    tok = rng.integers(0, vocab, size=(batch_size, seq_len + 1)).astype(np.int32)
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:].copy()}
