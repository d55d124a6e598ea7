"""Measurement protocol shared by the port's benchmarks (counterpart of
``repro.ff.tuning``; this slice carries ``time_interleaved`` only — the
tuning tables and ``tune`` are not ported yet)."""

from __future__ import annotations

import time
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_interleaved(fns: Sequence[Callable], args, reps: int, *,
                     device, rounds: int = 5,
                     sample_target_s: float = 0.03, rep_cap: int = 0,
                     min_reps: int = 2) -> List[Tuple[float, float]]:
    """Time each candidate ``fn(*args)``: once per round, in a fresh
    (deterministic) shuffled order each round after the first, so that
    no candidate always follows the same one.  Each sample runs a
    time-targeted number of calls (``sample_target_s`` from a warm-up
    estimate, at least ``min_reps``, at most ``rep_cap``, default
    ``6 * reps``) between two synchronisations of ``device`` (the card
    runs asynchronously), on the host clock.

    Returns, per candidate, ``(min_s, median_s)`` per call across rounds.
    Unlike the reference, a candidate that raises is not skipped: the
    error propagates."""
    device = torch.device(device)
    nreps: List[int] = []
    for fn in fns:
        fn(*args)                                  # warm (and build)
        _sync(device)
        t0 = time.perf_counter()
        fn(*args)
        _sync(device)
        est = time.perf_counter() - t0
        cap = rep_cap or 6 * reps
        nreps.append(max(min_reps,
                         min(cap, int(sample_target_s / max(est, 1e-7)))))
    samples: List[List[float]] = [[] for _ in fns]
    order = list(range(len(fns)))
    shuffler = np.random.default_rng(0)
    for r in range(rounds):
        for i in (order if r == 0 else list(shuffler.permutation(order))):
            _sync(device)
            t0 = time.perf_counter()
            for _ in range(nreps[i]):
                fns[i](*args)
            _sync(device)
            samples[i].append((time.perf_counter() - t0) / nreps[i])
    out: List[Tuple[float, float]] = []
    for s in samples:
        s = sorted(s)
        out.append((s[0], s[len(s) // 2]))
    return out
