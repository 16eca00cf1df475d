"""The one generator of training traffic: a traffic file
(``traffic/<name>.json``) sets the sequence length, the sequences an
optimizer step, the micro-batch, the token statistics and the job around
them (the optimizer, the Guard hook, the steps before the window), and
``--seed`` draws the tokens.

``SyntheticLM`` is a frozen copy of the program's
``repro_torch.train.data.SyntheticLM`` (numpy only; the same arrays for
the same seed and step): Zipf unigrams over 4,096 ids spread over the
vocabulary, with copies of the last two tokens mixed in so that the loss
can fall. ``batch_at(step)`` depends on (seed, step) alone, so the
reference rebuilds any step's batch.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict

import numpy as np

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    repeat_p: float = 0.3


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        ranks = np.arange(1, min(cfg.vocab_size, 4096) + 1)
        p = ranks ** (-cfg.zipf_a)
        self._uni_p = p / p.sum()
        self._uni_ids = (np.arange(len(ranks)) * 2654435761 %
                         cfg.vocab_size).astype(np.int64)

    def batch_at(self, step: int, shard: int = 0,
                 num_shards: int = 1) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        assert cfg.global_batch % num_shards == 0
        b = cfg.global_batch // num_shards
        rng = np.random.RandomState(
            (cfg.seed * 1_000_003 + step) % (2 ** 31 - 1))
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


def load(name: str) -> dict:
    """The traffic file of ``name``."""
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def source(traffic: dict, vocab_size: int, seed: int) -> SyntheticLM:
    return SyntheticLM(DataConfig(
        vocab_size=vocab_size, seq_len=traffic["seq_len"],
        global_batch=traffic["global_batch"], seed=int(seed),
        zipf_a=traffic["zipf_a"], repeat_p=traffic["repeat_p"]))
