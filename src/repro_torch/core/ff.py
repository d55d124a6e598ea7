"""The float-float (FF) format — paper §4 — as a pair of torch f32 tensors.

Counterpart of ``repro.core.ff``.  An FF value represents ``x = hi + lo``
(unevaluated sum of two f32 with ``|lo| <= ulp(hi)/2`` when normalized).
The algorithms are the paper's branch-free variants with the reference's
op sequences, so they return the reference's bits on normal-range inputs.
f64 never appears here; it is an oracle for tests only.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core import transforms as T

Tensor = torch.Tensor


class FF:
    """Unevaluated sum of two f32 tensors: value == hi + lo."""

    __slots__ = ("hi", "lo")

    def __init__(self, hi: Tensor, lo: Tensor):
        self.hi = hi
        self.lo = lo

    @classmethod
    def from_f32(cls, x: Tensor) -> "FF":
        x = torch.as_tensor(x, dtype=torch.float32)
        return cls(x, torch.zeros_like(x))

    @classmethod
    def from_f64(cls, x, device=None) -> "FF":
        """FF nearest a numpy float64 value: hi = fl32(x), lo =
        fl32(x - hi) (test and oracle convenience, on the host)."""
        x64 = np.asarray(x, np.float64)
        hi = np.asarray(x64.astype(np.float32))
        lo = np.asarray((x64 - hi.astype(np.float64)).astype(np.float32))
        return cls(torch.from_numpy(hi).to(device),
                   torch.from_numpy(lo).to(device))

    @classmethod
    def zeros(cls, shape, device=None) -> "FF":
        z = torch.zeros(shape, dtype=torch.float32, device=device)
        return cls(z, torch.zeros_like(z))

    @property
    def shape(self):
        return self.hi.shape

    def to_f32(self) -> Tensor:
        """Round to nearest f32 (hi is already the correctly rounded value)."""
        return self.hi

    def to_f64(self) -> np.ndarray:
        """The exact value as numpy float64 (host-side verification only)."""
        return (self.hi.detach().cpu().numpy().astype(np.float64)
                + self.lo.detach().cpu().numpy().astype(np.float64))

    def astuple(self) -> Tuple[Tensor, Tensor]:
        return self.hi, self.lo

    def __neg__(self) -> "FF":
        return FF(-self.hi, -self.lo)

    def __repr__(self):
        return f"FF(hi={self.hi!r}, lo={self.lo!r})"


def add12(a: Tensor, b: Tensor) -> FF:
    """Paper Theorem 2 (Knuth Add12): exact a+b as an FF."""
    s, r = T.two_sum(a, b)
    return FF(s, r)


def mul12(a: Tensor, b: Tensor) -> FF:
    """Paper Theorem 4 (Dekker Mul12): exact a*b as an FF."""
    x, y = T.two_prod(a, b)
    return FF(x, y)


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


def sqrt_rn(x: Tensor) -> Tensor:
    """The correctly rounded f32 square root.  PyTorch's vectorised CPU
    ``sqrt`` is not (it is within ~0.5001 ulp); the f64 root of an f32
    rounds back to the correctly rounded f32 (53 >= 2*24 + 2 bits)."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def sqrt22(a: FF) -> FF:
    """FF square root: one Newton correction of the correctly rounded f32
    root (:func:`sqrt_rn`, as ``jnp.sqrt`` and the card's ``sqrtf``)."""
    ch = sqrt_rn(a.hi)
    th, tl = T.two_prod(ch, ch)
    num = ((a.hi - th) - tl) + a.lo
    cl = num / (ch + ch)
    rh, rl = T.fast_two_sum(ch, cl)
    return FF(rh, rl)


def normalize(a: FF) -> FF:
    """Re-establish |lo| <= ulp(hi)/2 (Fast2Sum renormalisation)."""
    return FF(*T.fast_two_sum(a.hi, a.lo))


def fma22(a: FF, b: FF, c: FF) -> FF:
    """a*b + c in FF (fused at the algorithm level: one renormalization)."""
    th, tl = T.two_prod(a.hi, b.hi)
    t = tl + (a.hi * b.lo + a.lo * b.hi)
    sh, sl = T.two_sum(th, c.hi)
    v = sl + (t + c.lo)
    rh, rl = T.fast_two_sum(sh, v)
    return FF(rh, rl)


def to_f32(a: FF) -> Tensor:
    """The f32 rounding of an FF value: its hi limb."""
    return a.to_f32()


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, FF):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_from_f32(tree):
    """Each f32 leaf of a nested dict (list, tuple) as an FF with lo = 0."""
    return _tree_map(FF.from_f32, tree)


def tree_to_f32(tree):
    """Each FF leaf of a nested dict (list, tuple) rounded to f32 (its hi
    limb); other leaves pass through."""
    return _tree_map(lambda x: x.to_f32() if isinstance(x, FF) else x, tree)
