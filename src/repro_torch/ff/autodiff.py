"""Gradients of the FF ops on the training path: one
``torch.autograd.Function`` per op (counterpart of the ``custom_vjp``
rules of ``repro.ff.autodiff``).

Each backward is the reference's closed form.  Autograd never traces
through the EFT code inside: the error terms of TwoSum/Add22 chains have
zero derivative almost everywhere, so differentiating them op by op gives
a wrong gradient for the low limbs and thousands of backward ops.

The Functions take the already resolved implementation ``fn`` (the
public calls in ``repro_torch.ff.dispatch`` resolve it against the
registry and the scopes), so the forward runs exactly what a call
without gradients runs: on the card, the CUDA kernels.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch

from repro_torch.core.ff import FF, add12, add22, mul22, mul212
from repro_torch.core.ffmatmul import _dot_f32
from repro_torch.ff import tuning
from repro_torch.kernels.ff_attention import flash_attention_fast

Tensor = torch.Tensor

# the options of the attention call that the fast recurrence shares
_ATTN_FAST_KEYS = ("causal", "block_q", "block_kv", "q_offset", "scale")


def bucket2d(shape) -> Tuple[int, int]:
    """The tuning bucket of an elementwise or row operand: (prod(leading),
    last), as the kernels flatten it and ``ff.tune`` keys it
    (``_bucket2d`` of ``repro/ff/autodiff.py``)."""
    if len(shape) == 0:
        return (1, 1)
    if len(shape) == 1:
        return (1, int(shape[0]))
    r = 1
    for d in shape[:-1]:
        r *= int(d)
    return (r, int(shape[-1]))


def merge_tuned(op: str, name: str, shape, opts: dict, device) -> dict:
    """The tuned block config of (op, impl, shape bucket, device) merged
    under the caller's explicit options (``_merge_tuned``)."""
    opts = dict(opts)
    if shape is not None:
        for k, v in tuning.lookup_opts(op, name, shape,
                                       torch.device(device)).items():
            opts.setdefault(k, v)
    return opts


def _norm_axes(axis, ndim: int) -> Tuple[int, ...]:
    """``axis`` (None, an int or a sequence) as sorted non-negative axes."""
    if axis is None:
        return tuple(range(ndim))
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    return tuple(sorted(a % ndim for a in axes))


class Sum(torch.autograd.Function):
    """``ff.sum`` -> FF limbs (hi, lo).  Backward: the normalised FF
    cotangent's hi limb, broadcast over the summed axes
    (``repro/ff/autodiff.py:402-417``)."""

    @staticmethod
    def forward(ctx, x: Tensor, fn: Callable, axis) -> Tuple[Tensor, Tensor]:
        ctx.axes = _norm_axes(axis, x.ndim)
        ctx.shape = x.shape
        r = fn(x, axis=axis)
        return r.hi, r.lo

    @staticmethod
    def backward(ctx, g_hi: Tensor, g_lo: Tensor):
        g = g_hi + g_lo                  # hi limb of the normalised pair
        for ax in ctx.axes:
            g = g.unsqueeze(ax)
        return g.expand(ctx.shape), None, None


class LogSumExp(torch.autograd.Function):
    """``ff.logsumexp`` -> f32.  Backward: ``g * exp(x - out)``, the
    softmax (``repro/ff/autodiff.py:461-477``)."""

    @staticmethod
    def forward(ctx, x: Tensor, fn: Callable, axis: int) -> Tensor:
        out = fn(x, axis=axis)
        ctx.axis = axis
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g: Tensor):
        x, out = ctx.saved_tensors
        ax = ctx.axis
        return g.unsqueeze(ax) * torch.exp(x - out.unsqueeze(ax)), None, None


class MeanSq(torch.autograd.Function):
    """``ff.mean_sq`` (the RMSNorm statistic) -> f32.  Backward:
    ``x * (2g / n)`` (``repro/ff/autodiff.py:657-685``)."""

    @staticmethod
    def forward(ctx, x: Tensor, fn: Callable) -> Tensor:
        ctx.save_for_backward(x)
        return fn(x)

    @staticmethod
    def backward(ctx, g: Tensor):
        (x,) = ctx.saved_tensors
        return x * (2.0 * g[..., None] / x.shape[-1]), None


class Attention(torch.autograd.Function):
    """``ff.attention`` on an accurate tier, without ``kv_len``.  Backward:
    the gradient of the fast f32 recurrence at the same inputs, recomputed
    (``repro/ff/autodiff.py:567-594``): the FF value is 2^-44-class, its
    gradients stay at flash-attention training precision, as in the
    reference."""

    @staticmethod
    def forward(ctx, q: Tensor, k: Tensor, v: Tensor, fn: Callable,
                opts: dict) -> Tensor:
        ctx.opts = {n: o for n, o in opts.items() if n in _ATTN_FAST_KEYS}
        ctx.save_for_backward(q, k, v)
        return fn(q, k, v, **opts)

    @staticmethod
    def backward(ctx, g: Tensor):
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            y = flash_attention_fast(*qkv, **ctx.opts)
            dq, dk, dv = torch.autograd.grad(y, qkv, g)
        return dq, dk, dv, None, None


def mm_any(base: Callable, a: Union[FF, Tensor], b: Union[FF, Tensor]) -> FF:
    """The f32 matmul impl ``base`` extended to FF operands with the two
    significant cross terms (``a.lo @ b.lo`` is below 2^-48, below FF
    precision), as the reference's ``_mm_any``."""
    if not isinstance(a, FF) and not isinstance(b, FF):
        return base(a, b)
    ah = a.hi if isinstance(a, FF) else a
    bh = b.hi if isinstance(b, FF) else b
    out = base(ah, bh)
    if isinstance(b, FF):
        out = add22(out, FF.from_f32(_dot_f32(ah, b.lo)))
    if isinstance(a, FF):
        out = add22(out, FF.from_f32(_dot_f32(a.lo, bh)))
    return out


def _operand(hi: Tensor, lo: Optional[Tensor]) -> Union[FF, Tensor]:
    return hi if lo is None else FF(hi, lo)


def _t(x: Union[FF, Tensor]) -> Union[FF, Tensor]:
    if isinstance(x, FF):
        return FF(x.hi.transpose(-1, -2), x.lo.transpose(-1, -2))
    return x.transpose(-1, -2)


class Matmul(torch.autograd.Function):
    """``ff.matmul`` -> FF limbs (hi, lo).  Each operand is an f32 tensor
    (``lo`` None) or an FF pair.  Backward (``repro/ff/autodiff.py:346-
    351``): with the normalised FF cotangent ``gv = Add12(g.hi, g.lo)``,
    ``da = gv @ b^T`` and ``db = a^T @ gv`` through the same impl, so the
    gradient runs the forward's kernel; an f32 operand gets the hi limb,
    an FF operand both limbs."""

    @staticmethod
    def forward(ctx, a_hi: Tensor, a_lo: Optional[Tensor], b_hi: Tensor,
                b_lo: Optional[Tensor], base: Callable
                ) -> Tuple[Tensor, Tensor]:
        ctx.base = base
        ctx.save_for_backward(a_hi, a_lo, b_hi, b_lo)
        r = mm_any(base, _operand(a_hi, a_lo), _operand(b_hi, b_lo))
        return r.hi, r.lo

    @staticmethod
    def backward(ctx, g_hi: Tensor, g_lo: Tensor):
        a_hi, a_lo, b_hi, b_lo = ctx.saved_tensors
        gv = add12(g_hi, g_lo)
        need = ctx.needs_input_grad
        grads = [None] * 5
        if need[0] or need[1]:
            da = mm_any(ctx.base, gv, _t(_operand(b_hi, b_lo)))
            grads[0], grads[1] = da.hi, (None if a_lo is None else da.lo)
        if need[2] or need[3]:
            db = mm_any(ctx.base, _t(_operand(a_hi, a_lo)), gv)
            grads[2], grads[3] = db.hi, (None if b_lo is None else db.lo)
        return tuple(grads)


def _limb_pair(x: Union[FF, Tensor]) -> Tuple[Tensor, Optional[Tensor]]:
    return (x.hi, x.lo) if isinstance(x, FF) else (x, None)


def broadcast2(a: Union[FF, Tensor], b: Union[FF, Tensor]):
    """Both operands' limbs expanded to their broadcast shape, outside the
    Functions, so that autograd sums the gradient over the broadcast
    dimensions (``_broadcast2``).  Returns (a_hi, a_lo, b_hi, b_lo), a
    ``lo`` None for an f32 operand."""
    limbs = _limb_pair(a) + _limb_pair(b)
    shape = torch.broadcast_shapes(limbs[0].shape, limbs[2].shape)
    return tuple(t if t is None or t.shape == shape else t.expand(shape)
                 for t in limbs)


def _ff_mul_any(g: FF, x: Union[FF, Tensor]) -> FF:
    return mul22(g, x) if isinstance(x, FF) else mul212(g, x)


class Add(torch.autograd.Function):
    """``ff.add`` (and ``sub``) -> FF limbs (hi, lo), each operand an f32
    tensor (``lo`` None) or an FF pair of one shape.  Backward
    (``repro/ff/autodiff.py:109-120``): the normalised FF cotangent ``gv =
    Add12(g.hi, g.lo)`` to both operands, both limbs to an FF operand and
    the hi limb to an f32 one."""

    @staticmethod
    def forward(ctx, a_hi: Tensor, a_lo: Optional[Tensor], b_hi: Tensor,
                b_lo: Optional[Tensor], fn: Callable
                ) -> Tuple[Tensor, Tensor]:
        ctx.ff = (a_lo is not None, b_lo is not None)
        r = fn(_operand(a_hi, a_lo), _operand(b_hi, b_lo))
        return r.hi, r.lo

    @staticmethod
    def backward(ctx, g_hi: Tensor, g_lo: Tensor):
        gv = add12(g_hi, g_lo)
        a_ff, b_ff = ctx.ff
        return (gv.hi, gv.lo if a_ff else None, gv.hi,
                gv.lo if b_ff else None, None)


class Mul(torch.autograd.Function):
    """``ff.mul`` -> FF limbs (hi, lo).  Backward (``repro/ff/autodiff.py:
    123-141``): with ``gv = Add12(g.hi, g.lo)``, ``gv * b`` to ``a`` and
    ``gv * a`` to ``b`` (Mul22 by an FF operand, Mul212 by an f32 one),
    both limbs to an FF operand and the hi limb to an f32 one."""

    @staticmethod
    def forward(ctx, a_hi: Tensor, a_lo: Optional[Tensor], b_hi: Tensor,
                b_lo: Optional[Tensor], fn: Callable
                ) -> Tuple[Tensor, Tensor]:
        ctx.save_for_backward(a_hi, a_lo, b_hi, b_lo)
        r = fn(_operand(a_hi, a_lo), _operand(b_hi, b_lo))
        return r.hi, r.lo

    @staticmethod
    def backward(ctx, g_hi: Tensor, g_lo: Tensor):
        a_hi, a_lo, b_hi, b_lo = ctx.saved_tensors
        gv = add12(g_hi, g_lo)
        da = _ff_mul_any(gv, _operand(b_hi, b_lo))
        db = _ff_mul_any(gv, _operand(a_hi, a_lo))
        return (da.hi, None if a_lo is None else da.lo, db.hi,
                None if b_lo is None else db.lo, None)


def needs_grad(*xs: Optional[Tensor]) -> bool:
    """Whether a call on ``xs`` has to record its gradient."""
    return torch.is_grad_enabled() and any(
        isinstance(x, Tensor) and x.requires_grad for x in xs)
