"""The float-float (FF) format — paper §4 — as a pair of torch f32 tensors.

Counterpart of ``repro.core.ff``.  An FF value represents ``x = hi + lo``
(unevaluated sum of two f32 with ``|lo| <= ulp(hi)/2`` when normalized).
The algorithms are the paper's branch-free variants with the reference's
op sequences, so they return the reference's bits on normal-range inputs.
f64 never appears here; it is an oracle for tests only.
"""

from __future__ import annotations

import torch

from repro_torch.core import transforms as T

Tensor = torch.Tensor


class FF:
    """Unevaluated sum of two f32 tensors: value == hi + lo."""

    __slots__ = ("hi", "lo")

    def __init__(self, hi: Tensor, lo: Tensor):
        self.hi = hi
        self.lo = lo

    @property
    def shape(self):
        return self.hi.shape

    def to_f32(self) -> Tensor:
        """Round to nearest f32 (hi is already the correctly rounded value)."""
        return self.hi

    def __repr__(self):
        return f"FF(hi={self.hi!r}, lo={self.lo!r})"


def add22(a: FF, b: FF) -> FF:
    """Paper Theorem 5 Add22 (branch-free, 'sloppy' variant)."""
    sh, sl = T.two_sum(a.hi, b.hi)
    v = sl + (a.lo + b.lo)
    rh, rl = T.fast_two_sum(sh, v)
    return FF(rh, rl)


def add22_accurate(a: FF, b: FF) -> FF:
    """Accurate Add22: a second TwoSum on the low limbs (~2^-44 always)."""
    sh, sl = T.two_sum(a.hi, b.hi)
    th, tl = T.two_sum(a.lo, b.lo)
    c = sl + th
    vh, vl = T.fast_two_sum(sh, c)
    w = tl + vl
    rh, rl = T.fast_two_sum(vh, w)
    return FF(rh, rl)


def add212(a: FF, b) -> FF:
    """FF + f32."""
    sh, sl = T.two_sum(a.hi, b)
    v = sl + a.lo
    rh, rl = T.fast_two_sum(sh, v)
    return FF(rh, rl)


def mul22(a: FF, b: FF) -> FF:
    """Paper Theorem 6 Mul22: relative error <= 2^-44."""
    th, tl = T.two_prod(a.hi, b.hi)
    t = tl + (a.hi * b.lo + a.lo * b.hi)
    rh, rl = T.fast_two_sum(th, t)
    return FF(rh, rl)


def mul212(a: FF, b) -> FF:
    """FF * f32."""
    th, tl = T.two_prod(a.hi, b)
    t = tl + a.lo * b
    rh, rl = T.fast_two_sum(th, t)
    return FF(rh, rl)


def div22(a: FF, b: FF) -> FF:
    """FF division (Dekker quotient + one correction step)."""
    ch = a.hi / b.hi
    th, tl = T.two_prod(ch, b.hi)
    cl = ((((a.hi - th) - tl) + a.lo) - ch * b.lo) / b.hi
    rh, rl = T.fast_two_sum(ch, cl)
    return FF(rh, rl)


def to_f32(a: FF) -> Tensor:
    """The f32 rounding of an FF value: its hi limb."""
    return a.to_f32()
