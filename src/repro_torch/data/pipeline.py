"""Synthetic-but-deterministic data pipeline (a copy of
``repro.data.pipeline``: numpy only, so batch ``i`` is the reference's
batch ``i`` bit for bit).

Production posture without external data: a seeded Zipfian token stream with
injected n-gram structure (so models actually learn and loss curves are
meaningful), sharded per host (``host_id/num_hosts``) the same way a real
multi-pod input pipeline would shard files.

Determinism: batch ``i`` is a pure function of (seed, host_id, i) — a
restarted/elastic job resumes mid-epoch with no duplicate/missing samples,
which the fault-tolerance tests assert.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

Array = np.ndarray


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    ngram: int = 3          # injected structure order
    zipf_a: float = 1.3


class SyntheticLM:
    """Zipf unigrams + deterministic n-gram transitions (learnable)."""

    def __init__(self, cfg: DataConfig, host_id: int = 0, num_hosts: int = 1):
        if cfg.global_batch % num_hosts:
            raise ValueError(f"global_batch {cfg.global_batch} does not "
                             f"split over {num_hosts} hosts")
        self.cfg = cfg
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.local_batch = cfg.global_batch // num_hosts
        # fixed "grammar": each context token deterministically prefers a
        # successor; mixture with Zipf noise makes the task non-trivial
        g = np.random.default_rng(cfg.seed ^ 0x5EED)
        self._succ = g.integers(0, cfg.vocab_size, size=cfg.vocab_size)
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self._zipf_p = p / p.sum()

    def batch(self, index: int) -> Dict[str, Array]:
        """Batch ``index`` for this host — pure function, O(1) seek."""
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + index) * 4096 + self.host_id)
        B, S = self.local_batch, cfg.seq_len
        noise = rng.choice(cfg.vocab_size, size=(B, S + 1), p=self._zipf_p)
        use_succ = rng.random((B, S + 1)) < 0.7
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = noise[:, 0]
        for t in range(1, S + 1):
            toks[:, t] = np.where(use_succ[:, t],
                                  self._succ[toks[:, t - 1]], noise[:, t])
        return {"tokens": toks[:, :-1].astype(np.int32),
                "targets": toks[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, Array]]:
        i = 0
        while True:
            yield self.batch(i)
            i += 1
