"""Compensated reductions built from the paper's EFTs (counterpart of
``repro.core.compensated``): ``ff_sum`` (the Neumaier cascade, the
``cascade`` tier of ``ff.sum``), ``kahan_sum`` and ``ff_sum_blocked``
(the reduction under the RMSNorm statistic, the vocab log-sum-exp and
the FF attention block sums).  f64 never appears."""

from __future__ import annotations

from typing import Sequence, Union

import torch

from repro_torch.core import transforms as T
from repro_torch.core.ff import FF, add22

Tensor = torch.Tensor
Axis = Union[None, int, Sequence[int]]


def _move_axis_front(x: Tensor, axis: Axis) -> Tensor:
    """Collapse the reduced axes to a single leading axis."""
    if axis is None:
        return x.reshape(-1)
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    axes = tuple(a % x.ndim for a in axes)
    keep = tuple(a for a in range(x.ndim) if a not in axes)
    xt = x.permute(axes + keep)
    red = 1
    for a in axes:
        red *= x.shape[a]
    return xt.reshape((red,) + tuple(x.shape[a] for a in keep))


def kahan_sum(x: Tensor, axis: Axis = None) -> Tensor:
    """Kahan–Neumaier compensated sum rounded to f32 (``ff_sum``'s hi)."""
    return ff_sum(x, axis=axis).to_f32()


def ff_sum(x: Tensor, axis: Axis = None) -> FF:
    """Sum of an f32 tensor in FF by the cascaded TwoSum (Sum3), one
    element of the reduced axis after another in index order, as the
    reference's ``lax.scan``: its bits."""
    x = x.to(torch.float32)
    xf = _move_axis_front(x, axis)
    s = c = cc = xf.new_zeros(xf.shape[1:])
    for xi in xf.unbind(0):
        s, e = T.two_sum(s, xi)
        c, e2 = T.two_sum(c, e)        # compensate the compensation
        cc = cc + e2
    return FF(*T.fast_two_sum(s, c + cc))


def ff_sum_blocked(x: Tensor, axis: Axis = None, block: int = 128,
                   ) -> FF:
    """Lane-parallel Neumaier over ``block`` independent accumulators, then
    an exact cascade of the ``block`` partials (the reference's scan order:
    the sum is bitwise ``repro.core.compensated.ff_sum_blocked``)."""
    x = x.to(torch.float32)
    xf = _move_axis_front(x, axis)
    n = xf.shape[0]
    pad = (-n) % block
    if pad:
        xf = torch.cat([xf, xf.new_zeros((pad,) + tuple(xf.shape[1:]))], 0)
    xb = xf.reshape((-1, block) + tuple(xf.shape[1:]))

    s = c = cc = xb.new_zeros(xb.shape[1:])          # lane accumulators
    for xi in xb.unbind(0):
        s, e = T.two_sum(s, xi)
        c, e2 = T.two_sum(c, e)
        cc = cc + e2
    c = c + cc

    # exact cascade over the `block` lane partials, in lane order
    z = s.new_zeros(s.shape[1:])
    acc = FF(z, z)
    for si, ci in zip(s.unbind(0), c.unbind(0)):
        acc = add22(acc, FF(si, ci))
    return acc
