"""Deterministic synthetic LM data: the port's own copy of the JAX package's
``repro.train.data`` (numpy only, so ``batch_at`` gives the same arrays
bit for bit).

``batch_at(step)`` is a pure function of (seed, step, shard), so any worker
can reconstruct any batch: exact resume after a checkpoint restore and
elastic re-sharding come for free. Token streams are Zipf-distributed with
short-range Markov structure so the loss actually decreases."""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2           # unigram skew
    repeat_p: float = 0.3         # P(copy a recent token) -> learnable bigrams


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        # fixed Zipf unigram table (top 4096 ranks folded into the vocab)
        ranks = np.arange(1, min(cfg.vocab_size, 4096) + 1)
        p = ranks ** (-cfg.zipf_a)
        self._uni_p = p / p.sum()
        self._uni_ids = (np.arange(len(ranks)) * 2654435761 %
                         cfg.vocab_size).astype(np.int64)

    def batch_at(self, step: int, shard: int = 0,
                 num_shards: int = 1) -> Dict[str, np.ndarray]:
        """The (deterministic) global batch for ``step``, sliced for
        ``shard`` of ``num_shards`` along the batch dim."""
        cfg = self.cfg
        assert cfg.global_batch % num_shards == 0
        b = cfg.global_batch // num_shards
        rng = np.random.RandomState(
            (cfg.seed * 1_000_003 + step) % (2 ** 31 - 1))
        # draw the full global batch then slice — all shards agree
        draws = rng.choice(len(self._uni_p), size=(cfg.global_batch,
                                                   cfg.seq_len + 1),
                           p=self._uni_p)
        toks = self._uni_ids[draws]
        rep = rng.rand(cfg.global_batch, cfg.seq_len + 1) < cfg.repeat_p
        for off in (1, 2):
            m = rep & (rng.rand(*rep.shape) < 0.5)
            m[:, :off] = False
            toks = np.where(m, np.roll(toks, off, axis=1), toks)
        toks = toks[shard * b:(shard + 1) * b]
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}
