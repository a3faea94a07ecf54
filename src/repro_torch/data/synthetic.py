"""Deterministic, resumable synthetic token pipeline.

Production framing: every batch is a pure function of (seed, step, shard),
so a restarted/rescaled job regenerates exactly the stream it would have
seen — no state files, no skip-ahead replay cost.  A real corpus loader
would persist its cursor in the checkpoint ``extra`` field instead; the
trainer already round-trips that.

The generator models a Zipf unigram distribution with Markov locality so
losses move (unlike uniform noise) and MoE routers see realistic skew.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_alpha: float = 1.1
    locality: float = 0.7           # P(next token near previous token)
    shard_index: int = 0            # this host's shard
    num_shards: int = 1


class SyntheticTokens:
    """batch(step) -> {'tokens': [b, S], 'labels': [b, S]} for this shard."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        if cfg.global_batch % cfg.num_shards:
            raise ValueError("global_batch must divide evenly across shards")
        self.local_batch = cfg.global_batch // cfg.num_shards
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_alpha)
        self._cdf = np.cumsum(p / p.sum())

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """Generates the GLOBAL batch from (seed, step) and slices this
        shard's rows — so the global token stream is invariant under
        re-sharding (the elastic-rescale property: a job restarted on a
        different host count replays the identical stream)."""
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step]))
        b, s = cfg.global_batch, cfg.seq_len
        base = np.searchsorted(self._cdf, rng.random((b, s + 1)))
        # Markov locality: with prob `locality`, stay near the prior token
        stay = rng.random((b, s + 1)) < cfg.locality
        jitter = rng.integers(-64, 65, (b, s + 1))
        toks = base.copy()
        for t in range(1, s + 1):
            local = np.clip(toks[:, t - 1] + jitter[:, t], 0,
                            cfg.vocab_size - 1)
            toks[:, t] = np.where(stay[:, t], local, base[:, t])
        lo = cfg.shard_index * self.local_batch
        sl = slice(lo, lo + self.local_batch)
        tokens = toks[sl, :-1].astype(np.int32)
        labels = toks[sl, 1:].astype(np.int32)
        return {"tokens": tokens, "labels": labels}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
