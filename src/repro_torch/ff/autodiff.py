"""Gradients of the FF ops: one ``torch.autograd.Function`` per op
(counterpart of the ``custom_vjp`` rules of ``repro.ff.autodiff``).

Each backward is the reference's closed form, computed in FF:

    d(a + b) = da + db          d(a * b) = a db + b da
    d(a / b) = da / b - (a / b) db / b      d(sqrt a) = da / (2 sqrt a)

and for the ``ff.math`` functions the derivative rules of ``MATH_BWD``
(exp(x) dx, dx / x, (1 - t)(1 + t) dx, ...), built from Mul22, Div22,
Add212 and the FF functions themselves.  Autograd never traces through
the EFT code inside: the error terms of TwoSum/Add22 chains have zero
derivative almost everywhere, so differentiating them op by op gives a
wrong gradient for the low limbs and thousands of backward ops.

Cotangent convention (the reference's "value convention"): the cotangent
of an FF output is itself a limb pair whose value ``g.hi + g.lo`` is the
cotangent of ``hi + lo``.  Each backward normalises it, ``gv =
Add12(g.hi, g.lo)``, and gives an FF operand both limbs of its gradient,
an f32 operand the hi limb.  ``FF.to_f32`` (the hi limb) is the boundary
to plain autograd: its lo limb's cotangent is 0.

The Functions take the already resolved implementation ``fn`` (the
public calls in ``repro_torch.ff.dispatch`` resolve it against the
registry and the scopes), so the forward runs exactly what a call
without gradients runs: on the card, the CUDA kernels.  The backward of
an ``ff.math`` function on the kernel tier runs the FF functions it
needs (``sigmoid22``, ``exp22``, ``erf22``, ``log22``) through the
``ff_math`` kernel too, and through ``core.ffmath`` on the other tiers:
the same bits either way.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch

from repro_torch.core import ffmath
from repro_torch.core.ff import (FF, add12, add22, add212, div22, mul22,
                                 mul212)
from repro_torch.core.ffmatmul import _dot_f32
from repro_torch.ff import tuning
from repro_torch.kernels import ff_math
from repro_torch.kernels.ff_attention import flash_attention_fast
from repro_torch.kernels.ff_fused import div_n

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


def _expand(g: Tensor, axes: Tuple[int, ...], shape) -> Tensor:
    """``g`` broadcast back over the reduced ``axes`` of ``shape``."""
    for ax in axes:
        g = g.unsqueeze(ax)
    return g.expand(shape)


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
        return _expand(g, ctx.axes, ctx.shape), None, None


class Mean(Sum):
    """``ff.mean`` -> FF limbs (hi, lo), the forward of ``Sum``.
    Backward: the normalised cotangent's hi limb over n, an IEEE division,
    broadcast over the reduced axes (``repro/ff/autodiff.py:420-437``)."""

    @staticmethod
    def backward(ctx, g_hi: Tensor, g_lo: Tensor):
        n = 1
        for ax in ctx.axes:
            n *= ctx.shape[ax]
        g = div_n(g_hi + g_lo, n)        # each element's own division
        return _expand(g, ctx.axes, ctx.shape), None, None


class Dot(torch.autograd.Function):
    """``ff.dot`` -> FF limbs (hi, lo).  Backward: the normalised
    cotangent's hi limb, broadcast over the reduced axes, times the other
    operand, in f32 (``repro/ff/autodiff.py:440-458``)."""

    @staticmethod
    def forward(ctx, a: Tensor, b: Tensor, fn: Callable, axis
                ) -> Tuple[Tensor, Tensor]:
        ctx.axes = _norm_axes(axis, a.ndim)
        ctx.save_for_backward(a, b)
        r = fn(a, b, axis=axis)
        return r.hi, r.lo

    @staticmethod
    def backward(ctx, g_hi: Tensor, g_lo: Tensor):
        a, b = ctx.saved_tensors
        g = _expand(g_hi + g_lo, ctx.axes, a.shape)
        return g * b, g * a, None, None


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
    ``x * (2g / n)``, an IEEE division (``repro/ff/autodiff.py:657-685``)."""

    @staticmethod
    def forward(ctx, x: Tensor, fn: Callable) -> Tensor:
        ctx.save_for_backward(x)
        return fn(x)

    @staticmethod
    def backward(ctx, g: Tensor):
        (x,) = ctx.saved_tensors
        return x * div_n(2.0 * g[..., None], x.shape[-1]), None


class Softmax(torch.autograd.Function):
    """``ff.softmax`` -> f32.  Backward: ``(g - sum(g y)) y`` over the
    axis, in f32 (``repro/ff/autodiff.py:524-541``)."""

    @staticmethod
    def forward(ctx, x: Tensor, fn: Callable, axis: int) -> Tensor:
        y = fn(x, axis=axis)
        ctx.axis = axis
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g: Tensor):
        (y,) = ctx.saved_tensors
        dot = (g * y).sum(dim=ctx.axis, keepdim=True)
        return (g - dot) * y, None, None


class NormStats(torch.autograd.Function):
    """``ff.norm_stats`` -> (mean, var), both f32.  Backward: ``g_mu / n +
    g_var 2 (x - mu) / n``, in f32 with IEEE divisions
    (``repro/ff/autodiff.py:687-707``)."""

    @staticmethod
    def forward(ctx, x: Tensor, fn: Callable) -> Tuple[Tensor, Tensor]:
        mu, var = fn(x)
        ctx.save_for_backward(x, mu)
        return mu, var

    @staticmethod
    def backward(ctx, g_mu: Tensor, g_var: Tensor):
        x, mu = ctx.saved_tensors
        n = x.shape[-1]
        return (div_n(g_mu[..., None], n)
                + div_n(g_var[..., None] * 2.0 * (x - mu[..., None]), n),
                None)


class Attention(torch.autograd.Function):
    """``ff.attention`` on an accurate tier, with or without a per-row
    ``kv_len``.  Backward: the gradient of the fast f32 recurrence at the
    same inputs and the same ``kv_len``, recomputed
    (``repro/ff/autodiff.py:567-618``): the FF value is 2^-44-class, its
    gradients stay at flash-attention training precision, as in the
    reference.  ``kv_len`` (integer valid-key counts) gets no gradient."""

    @staticmethod
    def forward(ctx, q: Tensor, k: Tensor, v: Tensor, fn: Callable,
                opts: dict, kv_len: Optional[Tensor] = None) -> Tensor:
        ctx.opts = {n: o for n, o in opts.items() if n in _ATTN_FAST_KEYS}
        ctx.save_for_backward(q, k, v, kv_len)
        return fn(q, k, v, kv_len=kv_len, **opts)

    @staticmethod
    def backward(ctx, g: Tensor):
        q, k, v, kv_len = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            y = flash_attention_fast(*qkv, kv_len=kv_len, **ctx.opts)
            dq, dk, dv = torch.autograd.grad(y, qkv, g)
        return dq, dk, dv, None, None, None


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


def limb_pair(x: Union[FF, Tensor]) -> Tuple[Tensor, Optional[Tensor]]:
    """(hi, lo) of an FF operand, (x, None) of an f32 one."""
    return (x.hi, x.lo) if isinstance(x, FF) else (x, None)


def broadcast2(a: Union[FF, Tensor], b: Union[FF, Tensor]):
    """Both operands' limbs expanded to their broadcast shape, outside the
    Functions, so that autograd sums the gradient over the broadcast
    dimensions (``_broadcast2``).  Returns (a_hi, a_lo, b_hi, b_lo), a
    ``lo`` None for an f32 operand."""
    limbs = limb_pair(a) + limb_pair(b)
    shape = torch.broadcast_shapes(limbs[0].shape, limbs[2].shape)
    return tuple(t if t is None or t.shape == shape else t.expand(shape)
                 for t in limbs)


def _ff_mul_any(g: FF, x: Union[FF, Tensor]) -> FF:
    return mul22(g, x) if isinstance(x, FF) else mul212(g, x)


def _asff(hi: Tensor, lo: Optional[Tensor]) -> FF:
    """An operand as FF: an f32 operand's lo is 0 (``FF.from_f32``)."""
    return FF(hi, torch.zeros_like(hi) if lo is None else lo)


def _grads(d: FF, lo: Optional[Tensor]) -> Tuple[Tensor, Optional[Tensor]]:
    """An operand's gradient limbs: both for an FF operand, the hi limb
    for an f32 one (``_ct`` of the reference)."""
    return d.hi, (None if lo is None else d.lo)


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


class Div(torch.autograd.Function):
    """``ff.div`` -> FF limbs (hi, lo).  Backward (``repro/ff/autodiff.py:
    144-163``): ``q = gv / b`` (Div22, an f32 b lifted to FF) to ``a`` and
    ``-(q * out)`` (Mul22 by the FF quotient) to ``b``."""

    @staticmethod
    def forward(ctx, a_hi: Tensor, a_lo: Optional[Tensor], b_hi: Tensor,
                b_lo: Optional[Tensor], fn: Callable
                ) -> Tuple[Tensor, Tensor]:
        r = fn(_operand(a_hi, a_lo), _operand(b_hi, b_lo))
        ctx.a_ff = a_lo is not None
        ctx.save_for_backward(b_hi, b_lo, r.hi, r.lo)
        return r.hi, r.lo

    @staticmethod
    def backward(ctx, g_hi: Tensor, g_lo: Tensor):
        b_hi, b_lo, o_hi, o_lo = ctx.saved_tensors
        q = div22(add12(g_hi, g_lo), _asff(b_hi, b_lo))
        db = -mul22(q, FF(o_hi, o_lo))
        return (q.hi, q.lo if ctx.a_ff else None, *_grads(db, b_lo), None)


class Sqrt(torch.autograd.Function):
    """``ff.sqrt`` -> FF limbs (hi, lo).  Backward (``repro/ff/autodiff.py:
    166-181``): ``gv / (2 out)`` (Div22 by Mul212(out, 2))."""

    @staticmethod
    def forward(ctx, a_hi: Tensor, a_lo: Optional[Tensor], fn: Callable
                ) -> Tuple[Tensor, Tensor]:
        r = fn(_operand(a_hi, a_lo))
        ctx.a_ff = a_lo is not None
        ctx.save_for_backward(r.hi, r.lo)
        return r.hi, r.lo

    @staticmethod
    def backward(ctx, g_hi: Tensor, g_lo: Tensor):
        o_hi, o_lo = ctx.saved_tensors
        da = div22(add12(g_hi, g_lo), mul212(FF(o_hi, o_lo), 2.0))
        return da.hi, da.lo if ctx.a_ff else None, None


class TwoSum(torch.autograd.Function):
    """``ff.two_sum`` of two f32 tensors -> FF limbs (hi, lo).  Backward
    (``repro/ff/autodiff.py:263-275``): the normalised cotangent's hi
    limb to both operands."""

    @staticmethod
    def forward(ctx, a: Tensor, b: Tensor, fn: Callable
                ) -> Tuple[Tensor, Tensor]:
        r = fn(a, b)
        return r.hi, r.lo

    @staticmethod
    def backward(ctx, g_hi: Tensor, g_lo: Tensor):
        gv = add12(g_hi, g_lo).hi
        return gv, gv, None


class TwoProd(torch.autograd.Function):
    """``ff.two_prod`` of two f32 tensors -> FF limbs (hi, lo).  Backward
    (``repro/ff/autodiff.py:278-295``): ``Mul212(gv, b).hi`` to ``a``,
    ``Mul212(gv, a).hi`` to ``b``."""

    @staticmethod
    def forward(ctx, a: Tensor, b: Tensor, fn: Callable
                ) -> Tuple[Tensor, Tensor]:
        ctx.save_for_backward(a, b)
        r = fn(a, b)
        return r.hi, r.lo

    @staticmethod
    def backward(ctx, g_hi: Tensor, g_lo: Tensor):
        a, b = ctx.saved_tensors
        gv = add12(g_hi, g_lo)
        return mul212(gv, b).hi, mul212(gv, a).hi, None


# -- the ff.math functions ------------------------------------------------------
#
# Each rule takes the normalised cotangent ``gv``, the operand ``a`` and the
# output ``out`` (both FF) and ``f``, the FF functions of the forward's tier
# (``f("exp", hi, lo) -> FF``), and returns the operand's FF gradient
# (``_MATH_BWD`` of ``repro/ff/autodiff.py:749-832``).

# 1/sqrt(2 pi), FF (gelu's pdf factor)
_INV_SQRT2PI = (0.3989423, -1.133517e-08)


def math_fns(tier: str) -> Callable[[str, Tensor, Tensor], FF]:
    """The FF functions a backward of an ``ff.math`` call on ``tier``
    runs: the ``ff_math`` kernel on the kernel tier (``"pallas"``; its
    plain version on CPU tensors), ``core.ffmath`` otherwise.  The kernel
    is bit for bit its plain version, so both give the same gradient."""
    if tier == "pallas":
        return lambda op, hi, lo: FF(*ff_math.math_elementwise(op, hi, lo))
    return lambda op, hi, lo: FF(*ffmath.UNARY22[op](hi, lo))


def _ffc(pair: Tuple[float, float], like: FF) -> FF:
    return FF(torch.full_like(like.hi, pair[0]),
              torch.full_like(like.hi, pair[1]))


def _one_minus(t: FF) -> FF:
    return add212(FF(-t.hi, -t.lo), 1.0)


def _bwd_exp(gv, a, out, f):
    return mul22(gv, out)


def _bwd_expm1(gv, a, out, f):
    return mul22(gv, add212(out, 1.0))


def _bwd_log(gv, a, out, f):
    return div22(gv, a)


def _bwd_log1p(gv, a, out, f):
    return div22(gv, add212(a, 1.0))


def _bwd_tanh(gv, a, out, f):
    # (1 - t)(1 + t): the factored form keeps relative accuracy as |t| -> 1
    return mul22(gv, mul22(_one_minus(out), add212(out, 1.0)))


def _bwd_sigmoid(gv, a, out, f):
    return mul22(gv, mul22(out, _one_minus(out)))


def _bwd_erf(gv, a, out, f):
    z = mul22(a, a)
    e = f("exp", -z.hi, -z.lo)
    return mul22(gv, mul22(e, _ffc(ffmath._TWO_OVER_SQRTPI, a)))


def _bwd_gelu(gv, a, out, f):
    # gelu'(x) = Phi(x) + x phi(x), Phi = (1 + erf(x / sqrt2)) / 2,
    # phi = exp(-x^2 / 2) / sqrt(2 pi)
    v = mul22(a, _ffc(ffmath._INV_SQRT2, a))
    e = f("erf", v.hi, v.lo)
    phi_cap = add212(e, 1.0)
    phi_cap = FF(0.5 * phi_cap.hi, 0.5 * phi_cap.lo)
    z = mul22(a, a)
    w = f("exp", -0.5 * z.hi, -0.5 * z.lo)
    pdf = mul22(w, _ffc(_INV_SQRT2PI, a))
    return mul22(gv, add22(phi_cap, mul22(a, pdf)))


def _bwd_silu(gv, a, out, f):
    # silu'(x) = s (1 + x (1 - s))
    s = f("sigmoid", a.hi, a.lo)
    inner = add212(mul22(a, _one_minus(s)), 1.0)
    return mul22(gv, mul22(s, inner))


MATH_BWD = {
    "exp": _bwd_exp, "expm1": _bwd_expm1, "log": _bwd_log,
    "log1p": _bwd_log1p, "tanh": _bwd_tanh, "sigmoid": _bwd_sigmoid,
    "erf": _bwd_erf, "gelu": _bwd_gelu, "silu": _bwd_silu,
}


class Math1(torch.autograd.Function):
    """One of the nine unary ``ff.math`` functions -> FF limbs (hi, lo).
    Backward: the op's rule of ``MATH_BWD``, with the FF functions of the
    forward's ``tier`` (``math_fns``)."""

    @staticmethod
    def forward(ctx, a_hi: Tensor, a_lo: Optional[Tensor], fn: Callable,
                op: str, tier: str) -> Tuple[Tensor, Tensor]:
        r = fn(_operand(a_hi, a_lo))
        ctx.op, ctx.tier = op, tier
        ctx.save_for_backward(a_hi, a_lo, r.hi, r.lo)
        return r.hi, r.lo

    @staticmethod
    def backward(ctx, g_hi: Tensor, g_lo: Tensor):
        a_hi, a_lo, o_hi, o_lo = ctx.saved_tensors
        d = MATH_BWD[ctx.op](add12(g_hi, g_lo), _asff(a_hi, a_lo),
                             FF(o_hi, o_lo), math_fns(ctx.tier))
        return (*_grads(d, a_lo), None, None, None)


class Pow(torch.autograd.Function):
    """``ff.pow`` -> FF limbs (hi, lo).  Backward (``repro/ff/autodiff.py:
    856-877``): ``gv b (out / a)`` to ``a``, ``gv out log(a)`` to ``b``
    (log22 on the forward's tier)."""

    @staticmethod
    def forward(ctx, a_hi: Tensor, a_lo: Optional[Tensor], b_hi: Tensor,
                b_lo: Optional[Tensor], fn: Callable, tier: str
                ) -> Tuple[Tensor, Tensor]:
        r = fn(_operand(a_hi, a_lo), _operand(b_hi, b_lo))
        ctx.tier = tier
        ctx.save_for_backward(a_hi, a_lo, b_hi, b_lo, r.hi, r.lo)
        return r.hi, r.lo

    @staticmethod
    def backward(ctx, g_hi: Tensor, g_lo: Tensor):
        a_hi, a_lo, b_hi, b_lo, o_hi, o_lo = ctx.saved_tensors
        gv = add12(g_hi, g_lo)
        af, bf, out = _asff(a_hi, a_lo), _asff(b_hi, b_lo), FF(o_hi, o_lo)
        da = mul22(gv, mul22(bf, div22(out, af)))
        ln_a = math_fns(ctx.tier)("log", af.hi, af.lo)
        db = mul22(gv, mul22(out, ln_a))
        return (*_grads(da, a_lo), *_grads(db, b_lo), None, None)


def needs_grad(*xs: Optional[Tensor]) -> bool:
    """Whether a call on ``xs`` has to record its gradient."""
    return torch.is_grad_enabled() and any(
        isinstance(x, Tensor) and x.requires_grad for x in xs)
