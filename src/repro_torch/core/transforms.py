"""Error-free transformations (EFTs) of Da Graça & Defour 2006, in eager
PyTorch f32.  Counterpart of ``repro.core.transforms``; the op sequences
are identical, so on the same normal-range inputs the results are the
same bits.

  * ``two_sum``       — Add12 / Knuth TwoSum (branch-free, 6 flops).
  * ``fast_two_sum``  — Dekker Fast2Sum (3 flops, requires |a| >= |b|).
  * ``split``         — Dekker splitting at s=12 for p=24 (f32).
  * ``split_safe``    — ``split`` with the overflow guard (|a| >= 2^115).
  * ``two_prod``      — Mul12 / Dekker product via ``split`` (no FMA).
  * ``two_prod_safe`` — ``two_prod`` through ``split_safe``.
  * ``two_diff``      — TwoSum of a and -b.
  * ``pairwise_sum_compensated`` — a two_sum tree over one axis.

Contraction note: the reference pins rounded products with an
optimization barrier because XLA:CPU may contract ``s + a*b`` into an
FMA.  Eager PyTorch runs every op as its own kernel and never contracts
across ops, so no barrier is needed here.  The port's rule is to never
use fused torch ops (``addcmul``, ``addmm``, ``lerp``) in EFT code.

Domain note: EFT exactness requires every intermediate to stay normal
(|x| in [2^-100, 2^115] for ``split``/``two_prod``), as in the reference.
Unlike XLA:CPU, torch keeps subnormals, so the two packages may differ
only inside that excluded band.

Operands are f32 tensors; a Python number is accepted as the second
operand where the algorithms use an exact constant (e.g. ``1.0``).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch

Tensor = torch.Tensor
Operand = Union[Tensor, float]

# Dekker split point for binary32: p = 24, s = 12  ->  2^s + 1.
SPLIT_CONST = 4097.0
# |a| above this can overflow split's (2^s + 1) * a (f32 max ~ 2^128):
# ``split_safe`` rescales it
SPLIT_OVERFLOW_THRESH = 2.0 ** 115


def _f32(x: Operand) -> Operand:
    if isinstance(x, Tensor):
        if x.dtype != torch.float32:
            raise TypeError(
                f"float-float EFTs are defined for float32, got {x.dtype}")
    elif not isinstance(x, float):
        raise TypeError(f"float-float EFTs take float32 tensors or Python "
                        f"floats, got {type(x).__name__}")
    return x


def two_sum(a: Operand, b: Operand) -> Tuple[Tensor, Tensor]:
    """Add12 (Knuth).  Returns (s, r) with s = fl(a+b), s + r == a + b."""
    a, b = _f32(a), _f32(b)
    s = a + b
    bb = s - a
    err_b = b - bb
    err_a = a - (s - bb)
    return s, err_a + err_b


def fast_two_sum(a: Operand, b: Operand) -> Tuple[Tensor, Tensor]:
    """Dekker Fast2Sum: exact only when |a| >= |b| (or a == 0)."""
    a, b = _f32(a), _f32(b)
    s = a + b
    r = b - (s - a)
    return s, r


def split(a: Tensor) -> Tuple[Tensor, Tensor]:
    """Dekker SPLIT (paper Theorem 3): a == a_hi + a_lo exactly, each half
    within 12 significand bits.  No overflow guard (|a| < 2^115)."""
    a = _f32(a)
    c = SPLIT_CONST * a
    a_big = c - a
    a_hi = c - a_big
    a_lo = a - a_hi
    return a_hi, a_lo


def split_safe(a: Tensor) -> Tuple[Tensor, Tensor]:
    """Overflow-guarded ``split``: |a| >= 2^115 is scaled by 2^-16 before
    the split and its halves by 2^16 after (branch-free, a select)."""
    a = _f32(a)
    big = a.abs() >= SPLIT_OVERFLOW_THRESH
    one = torch.ones_like(a)
    scale_dn = torch.where(big, 2.0 ** -16, one)
    scale_up = torch.where(big, 2.0 ** 16, one)
    hi, lo = split(a * scale_dn)
    return hi * scale_up, lo * scale_up


def _two_prod_with(a: Tensor, b: Tensor, split_fn) -> Tuple[Tensor, Tensor]:
    x = a * b
    a_hi, a_lo = split_fn(a)
    b_hi, b_lo = split_fn(b)
    err1 = x - (a_hi * b_hi)
    err2 = err1 - (a_lo * b_hi)
    err3 = err2 - (a_hi * b_lo)
    y = (a_lo * b_lo) - err3
    return x, y


def two_prod(a: Operand, b: Operand) -> Tuple[Tensor, Tensor]:
    """Mul12 (Dekker, paper Theorem 4): x + y == a * b exactly."""
    return _two_prod_with(_tensor(_f32(a)), _tensor(_f32(b)), split)


def two_prod_safe(a: Tensor, b: Tensor) -> Tuple[Tensor, Tensor]:
    """Mul12 through ``split_safe`` (for |a| or |b| near the f32 max)."""
    return _two_prod_with(_tensor(_f32(a)), _tensor(_f32(b)), split_safe)


def _tensor(x: Operand) -> Tensor:
    """A Python float constant as a 0-dim f32 tensor, so that ``split``
    rounds it to f32 at every step as it does a tensor operand (torch
    treats a 0-dim CPU tensor as a scalar beside a CUDA tensor)."""
    return x if isinstance(x, Tensor) else torch.tensor(x, dtype=torch.float32)


def two_diff(a: Operand, b: Operand) -> Tuple[Tensor, Tensor]:
    """TwoDiff: (s, r) with s + r == a - b exactly (negation is exact)."""
    a, b = _f32(a), _f32(b)
    return two_sum(a, -b)


def sum_in_order(x: Tensor, axis: int) -> Tensor:
    """Plain f32 sum over ``axis`` as XLA:CPU reduces a small axis: a left
    fold from +0, ``((0 + x0) + x1) + ...`` (``jnp.sum`` in the
    reference; torch's own ``sum`` may take another order)."""
    acc = torch.zeros_like(x.select(axis, 0))
    for xi in x.unbind(axis):
        acc = acc + xi
    return acc


def pairwise_sum_compensated(p: Tensor, axis: int, err: Optional[Tensor] = None,
                             *, two_sum_fn: Optional[Callable] = None
                             ) -> Tuple[Tensor, Tensor]:
    """Pairwise two_sum tree reduction over ``axis``: returns (sum, err)
    with sum + err tracking the exact total to ~2^-48 relative.

    Each level pairs the first half of the axis with the second half
    (an odd last entry carries over), and the level's two_sum roundings are
    summed into ``err`` in order (:func:`sum_in_order`), as the
    reference's ``core.transforms.pairwise_sum_compensated`` does; same
    inputs, same bits.  ``two_sum_fn`` selects the EFT (this module's
    ``two_sum`` by default)."""
    ts = two_sum_fn if two_sum_fn is not None else two_sum
    if err is None:
        err = torch.zeros_like(p.select(axis, 0))
    while p.shape[axis] > 1:
        width = p.shape[axis]
        half = width // 2
        s, e = ts(p.narrow(axis, 0, half), p.narrow(axis, half, half))
        err = err + sum_in_order(e, axis)
        if width % 2:
            s = torch.cat([s, p.narrow(axis, width - 1, 1)], dim=axis)
        p = s
    return p.select(axis, 0), err
