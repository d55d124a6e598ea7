"""Precision policy: where float-float is applied inside a model.

A copy of ``repro.core.policy`` (the port imports nothing of ``repro``);
one policy string means the same in both packages.

Policies (ordered by cost):
  * ``baseline``   — plain f32 activations / f32 master weights.
  * ``ff_master``  — FF master weights + FF optimizer accumulators only.
  * ``ff_reduce``  — ff_master + compensated reductions (loss, LN/RMS stats,
                     softmax LSE, grad-norm).
  * ``ff_full``    — ff_reduce + FF logits matmul.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

Level = Literal["baseline", "ff_master", "ff_reduce", "ff_full"]


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    level: Level = "ff_master"
    ff_master_weights: bool = True
    ff_reductions: bool = False
    ff_logits: bool = False
    # FF elementary functions in the model (silu gates, soft-caps, scoring)
    ff_math: bool = False
    # ``ff.attention`` implementation the attention layers request
    # ("fast" = f32 online softmax, "ff"/"pallas" = compensated FF class)
    attention: str = "fast"
    compute_dtype: str = "bfloat16"
    ff_matmul_block_k: int = 512
    matmul_impl: str = "auto"

    @staticmethod
    def make(level: Level = "ff_master", compute_dtype: str = "bfloat16",
             **overrides) -> "PrecisionPolicy":
        table = dict(
            baseline=dict(ff_master_weights=False, ff_reductions=False,
                          ff_logits=False),
            ff_master=dict(ff_master_weights=True, ff_reductions=False,
                           ff_logits=False),
            ff_reduce=dict(ff_master_weights=True, ff_reductions=True,
                           ff_logits=False),
            ff_full=dict(ff_master_weights=True, ff_reductions=True,
                         ff_logits=True),
        )
        if level not in table:
            raise ValueError(f"unknown precision-policy level {level!r}; "
                             f"choose from {tuple(table)}")
        base = table[level]
        base.update(overrides)
        return PrecisionPolicy(level=level, compute_dtype=compute_dtype,
                               **base)


BASELINE = PrecisionPolicy.make("baseline")
FF_MASTER = PrecisionPolicy.make("ff_master")
FF_REDUCE = PrecisionPolicy.make("ff_reduce")
FF_FULL = PrecisionPolicy.make("ff_full")
