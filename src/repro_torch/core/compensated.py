"""Compensated reductions built from the paper's EFTs (counterpart of
``repro.core.compensated``): ``ff_sum`` (the Neumaier cascade, the
``cascade`` tier of ``ff.sum``), ``kahan_sum``, ``ff_sum_blocked`` (the
reduction under the RMSNorm statistic, the vocab log-sum-exp and the FF
attention block sums), ``ff_dot`` (the ``jnp`` tier of ``ff.dot``),
``ff_mean``, ``ff_logsumexp`` and the streaming ``kahan_update``.  f64
never appears."""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

from repro_torch.core import transforms as T
from repro_torch.core.ff import FF, add22, add212, mul212

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


def axis_size(x: Tensor, axis: Axis) -> int:
    """The number of elements a reduction over ``axis`` adds up."""
    if axis is None:
        return x.numel()
    n = 1
    for a in ((axis,) if isinstance(axis, int) else tuple(axis)):
        n *= x.shape[a]
    return n


def ff_dot(a: Tensor, b: Tensor, axis: Axis = None) -> FF:
    """Compensated dot product (Ogita-Rump-Oishi Dot2 with an FF carry):
    each product made exact by TwoProd, then the Dot3-quality TwoSum
    cascade in index order along the reduced axes (the reference's
    ``lax.scan``: its bits)."""
    af = _move_axis_front(a.to(torch.float32), axis)
    bf = _move_axis_front(b.to(torch.float32), axis)
    s = c = cc = af.new_zeros(af.shape[1:])
    for ai, bi in zip(af.unbind(0), bf.unbind(0)):
        p, pe = T.two_prod(ai, bi)
        s, se = T.two_sum(s, p)
        c, ce = T.two_sum(c, se + pe)
        cc = cc + ce
    return FF(*T.fast_two_sum(s, c + cc))


def ff_mean(x: Tensor, axis: Axis = None) -> FF:
    """``ff_sum`` times the f32 rounding of 1/n (Mul212)."""
    x = x.to(torch.float32)
    s = ff_sum(x, axis=axis)
    inv = torch.tensor(1.0 / axis_size(x, axis), dtype=torch.float32,
                       device=x.device)
    return mul212(s, inv)


def ff_logsumexp(x: Tensor, axis: int = -1) -> Tuple[Tensor, FF]:
    """(max, FF sum of exp(x - max)) over ``axis``: the f32 builtin exp,
    the lane-parallel cascade (block 256) of the exp-sum."""
    x = x.to(torch.float32)
    m = torch.amax(x, dim=axis, keepdim=True)
    s = ff_sum_blocked(torch.exp(x - m), axis=axis, block=256)
    return m.squeeze(axis), s


def kahan_update(acc: FF, delta: Tensor) -> FF:
    """Streaming compensated accumulate: acc += delta (f32), FF carry
    (Add212)."""
    return add212(acc, torch.as_tensor(delta, dtype=torch.float32))
