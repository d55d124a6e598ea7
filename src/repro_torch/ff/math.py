"""``repro_torch.ff.math``: the dispatched FF elementary functions
(counterpart of ``repro.ff.math``).

The f32 builtins (``torch.exp``, ``torch.tanh``, ...) are ~2^-24
accurate and cap any FF pipeline that calls one; these hold the FF
contract of ``docs/NUMERICS.md`` (argument reduction + compensated FF
polynomials, :mod:`repro_torch.core.ffmath`) behind the registry::

    import repro_torch.ff as ff
    y = ff.exp(x)                       # FF or f32 in, FF out
    y = ff.silu(x, impl="pallas")       # one CUDA kernel on the card

Each function resolves per call like every other op: ``jnp`` (the
default), ``pallas`` (the ``ff_math`` kernel), ``f64`` or ``fast``, by
``impl=``, an ``ff.use`` scope or the ``ff.tune`` table for the call's
(device, (R, C) bucket).  Each is differentiable with the reference's FF
derivative rule (``autodiff.Math1``, ``autodiff.Pow``); on the kernel
tier the backward's FF functions (``sigmoid22`` for silu, ...) run
through the ``ff_math`` kernel too.  Each result passes through the
ambient ``ff.guard`` scope (:func:`repro_torch.ff.guard.protect`),
after the gradient's Function: counted under ``check``, repaired and the
op degraded one class under ``degrade``, untouched under ``off``.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.core.ff import FF
from repro_torch.ff import autodiff, dispatch
from repro_torch.ff.guard import protect

UNARY = ("exp", "expm1", "log", "log1p", "tanh", "sigmoid", "erf", "gelu",
         "silu")
__all__ = list(UNARY) + ["pow"]


def _call(op: str, impl: Optional[str], opts: dict, *xs) -> FF:
    fn, xs = dispatch._ew_call(op, impl, opts, *xs)
    limbs = [t for x in xs for t in dispatch._limbs(x)]
    if not autodiff.needs_grad(*limbs):
        return protect(op, fn(*xs))
    if op == "pow":
        r = autodiff.Pow.apply(*autodiff.broadcast2(*xs), fn, fn.impl)
    else:
        r = autodiff.Math1.apply(*autodiff.limb_pair(xs[0]), fn, op,
                                 fn.impl)
    return protect(op, FF(*r))


def exp(a, *, impl: Optional[str] = None, **opts) -> FF:
    """FF exponential: <= 2 ulp_FF (~2^-43) on |x| <= ln2/2, saturating
    at the f32 range edges.  FF or f32 operand -> FF."""
    return _call("exp", impl, opts, a)


def expm1(a, *, impl: Optional[str] = None, **opts) -> FF:
    """FF exp(x) - 1 with full relative accuracy near 0."""
    return _call("expm1", impl, opts, a)


def log(a, *, impl: Optional[str] = None, **opts) -> FF:
    """FF natural logarithm: nan for x < 0, -inf at 0."""
    return _call("log", impl, opts, a)


def log1p(a, *, impl: Optional[str] = None, **opts) -> FF:
    """FF log(1 + x), fully accurate for tiny x."""
    return _call("log1p", impl, opts, a)


def tanh(a, *, impl: Optional[str] = None, **opts) -> FF:
    """FF hyperbolic tangent, exact +-1 saturation."""
    return _call("tanh", impl, opts, a)


def sigmoid(a, *, impl: Optional[str] = None, **opts) -> FF:
    """FF logistic sigmoid (cancellation-free two-sided form)."""
    return _call("sigmoid", impl, opts, a)


def erf(a, *, impl: Optional[str] = None, **opts) -> FF:
    """FF error function (alternating series |x| <= 1, positive series
    to 4, asymptotic erfc beyond; exact +-1 saturation)."""
    return _call("erf", impl, opts, a)


def gelu(a, *, impl: Optional[str] = None, **opts) -> FF:
    """FF exact-form GELU, 0.5 x (1 + erf(x / sqrt2))."""
    return _call("gelu", impl, opts, a)


def silu(a, *, impl: Optional[str] = None, **opts) -> FF:
    """FF SiLU / swish, x * sigmoid(x)."""
    return _call("silu", impl, opts, a)


def pow(a, b, *, impl: Optional[str] = None, **opts) -> FF:  # noqa: A001
    """FF power a**b = exp(b log a) for a > 0 (error grows with
    |b ln a|); IEEE limits for a in {0, inf}, b = 0."""
    return _call("pow", impl, opts, a, b)
