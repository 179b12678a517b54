"""Deterministic synthetic LM data pipeline (a copy of the reference's
``repro.data.tokens``: numpy, so a seed gives the reference's batches
bit for bit).

Batches are a *learnable* synthetic language (a fixed random first-order
Markov chain over the vocab with Zipfian marginals), so a few hundred
training steps show a real loss decrease.

Sharded iteration: each host materialises only its slice of the global
batch (``host_id``/``num_hosts``), deterministically from (seed, step) —
restart-safe without data-loader state in checkpoints.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenDatasetConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    branching: int = 4          # candidate successors per token (learnability)


class SyntheticTokens:
    def __init__(self, cfg: TokenDatasetConfig, host_id: int = 0,
                 num_hosts: int = 1):
        if cfg.global_batch % num_hosts != 0:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split over {num_hosts} hosts")
        self.cfg = cfg
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.local_batch = cfg.global_batch // num_hosts
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # fixed Markov structure: each token has `branching` successors with
        # Zipfian transition probabilities
        self._succ = rng.integers(0, v, size=(v, cfg.branching), dtype=np.int64)
        p = 1.0 / np.arange(1, cfg.branching + 1)
        self._probs = p / p.sum()
        zipf = 1.0 / np.arange(1, v + 1)
        self._init_probs = zipf / zipf.sum()

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """Deterministic batch for a global step (this host's shard)."""
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed, step, self.host_id, 0xD00D))
        b, s = self.local_batch, cfg.seq_len
        toks = np.empty((b, s + 1), dtype=np.int32)
        toks[:, 0] = rng.choice(cfg.vocab_size, size=b, p=self._init_probs)
        choice = rng.choice(cfg.branching, size=(b, s), p=self._probs)
        for t in range(s):
            toks[:, t + 1] = self._succ[toks[:, t], choice[:, t]]
        return {"tokens": toks[:, :-1],
                "labels": toks[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
