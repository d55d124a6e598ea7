"""Float-float elementary functions (counterpart of ``repro.core.ffmath``):
``exp22``, ``expm122``, ``log22``, ``log1p22``, ``tanh22``,
``sigmoid22``, ``erf22``, ``gelu22``, ``silu22`` and ``pow22`` over raw
``(hi, lo)`` limbs, and ``UNARY22``, the nine unary ones by name.

Same constants, same op order as the reference (Cody–Waite ``ln2``
reduction with exact 16-bit-piece products, FF Horner over an f32 tail,
frexp to [sqrt2/2, sqrt2) + an atanh series for log), so the results are
the reference's bits on arguments whose limbs stay normal.  ``torch.round``
rounds half to even like ``jnp.round``; exact powers of two are built from
exponent bits, never with ``exp2``.  Constants are Python floats; torch
rounds a scalar operand to f32 before the op, as ``jnp.float32(c)`` does.
A number over a tensor is divided as two tensors (``_num``): torch
evaluates ``c / t`` as ``c * (1 / t)``, two roundings, and on the card
``t / c`` as a multiply by the rounded reciprocal.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import ff as core_ff
from repro_torch.core import transforms as T
from repro_torch.core.ff import FF

Tensor = torch.Tensor
Limb = Tuple[Tensor, Tensor]

# Cody–Waite split of ln2 (16-bit pieces: k*L1, k*L2 exact for |k| <= 2^8)
_EXP_L1 = 0.693145751953125          # 45426 * 2^-16
_EXP_L2 = 1.4286197256296873e-06     # 49087 * 2^-35
_EXP_L3 = -1.290532e-11
_INV_LN2 = 1.4426950408889634

# ln2 as an FF constant (for the log reconstruction e*ln2)
_LN2_H, _LN2_L = 0.6931471824645996, -1.9046542121259336e-09

# exp kernel: exp(r) = 1 + r + r^2 W(r); FF coefficients j = 0..5, f32 tail
_EXP_W_FF = (
    (0.5, 0.0),
    (0.16666667, -4.967054e-09),
    (0.041666668, -1.2417635e-09),
    (0.008333334, -4.346172e-10),
    (0.0013888889, -3.3631094e-11),
    (0.0001984127, -2.7255969e-12),
)
_EXP_W_F32 = (2.4801588e-05, 2.7557319e-06, 2.755732e-07,
              2.5052108e-08, 2.0876756e-09, 1.6059044e-10)

# atanh kernel: log(m) = 2 s S(s^2); FF for n = 0..3, f32 tail n = 4..9
_LOG_S_FF = (
    (1.0, 0.0),
    (0.33333334, -9.934108e-09),
    (0.2, -2.9802323e-09),
    (0.14285715, -6.386212e-09),
)
_LOG_S_F32 = (0.11111111, 0.09090909, 0.07692308,
              0.06666667, 0.05882353, 0.05263158)

# tanh Maclaurin (odd series, coefficients of x^(2n+1)) for |x| <= 0.35:
# FF for n = 0..5, f32 tail n = 6..11
_TANH_C_FF = (
    (1.0, 0.0),
    (-0.33333334, 9.934108e-09),
    (0.13333334, -6.9538753e-09),
    (-0.053968254, 5.085317e-10),
    (0.021869488, 4.7568083e-10),
    (-0.008863236, 2.939079e-10),
)
_TANH_C_F32 = (0.003592128, -0.0014558344, 0.0005900274,
               -0.00023912912, 9.691538e-05, -3.9278322e-05)

_EXP_CLIP_LO, _EXP_CLIP_HI = -105.0, 89.0   # beyond: saturated anyway
_TANH_SMALL = 0.35                          # Maclaurin branch bound
_IDENTITY = 2.0 ** -45                      # f(x) == x at FF precision
_SQRT2_F32 = 1.4142135

_TWO_OVER_SQRTPI = (1.1283792, -5.8635383e-08)
_INV_SQRT2 = (0.70710677, 1.21016175e-08)
_SQRTPI = (1.7724539, -5.32464e-08)
# asymptotic erfc series A(w) = sum_k (-1)^k (2k-1)!! w^k, w = 1/(2x^2)
_ERFC_ASY = (1.0, -1.0, 3.0, -15.0, 105.0, -945.0, 10395.0, -135135.0,
             2027025.0, -34459425.0, 654729075.0, -13749310575.0,
             316234143225.0)
_ERF_SMALL = 1.0                            # alternating-series bound
_ERF_MID = 4.0                              # positive-series / asymptotic seam
_ERF_ALT_TERMS = 17                         # n = 1..16 after the n=0 seed
_ERF_POS_TERMS = 60                         # n = 1..59 after the n=0 seed
_ERF_CLAMP = 30.0                           # erf(30) == 1 at FF precision
_LOG1P_NEAR = (-0.2928932, 0.41421354)      # 1 + x in the reduced range


def _num(x: Tensor, c: float) -> Tensor:
    """The constant ``c`` as a tensor like ``x`` (a divisor or dividend)."""
    return torch.full_like(x, c)


def _exp2i(k: Tensor) -> Tensor:
    """Exact 2^k for int32 k in [-126, 127], built from exponent bits."""
    return ((k + 127) << 23).to(torch.int32).view(torch.float32)


def _scale2k(h: Tensor, l: Tensor, k: Tensor) -> Limb:
    """(h, l) * 2^k for int32 k in [-252, 254], exact via two half-steps."""
    k1 = k >> 1
    k2 = k - k1
    s1, s2 = _exp2i(k1), _exp2i(k2)
    return (h * s1) * s2, (l * s1) * s2


def _exp_reduce(xh: Tensor, xl: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Cody–Waite reduction x = k*ln2 + r, r an FF pair, |r| <= ln2/2."""
    xc = torch.clamp(xh, _EXP_CLIP_LO, _EXP_CLIP_HI)
    kf = torch.round(xc * _INV_LN2)
    h1 = xc - kf * _EXP_L1                        # exact
    sh, sl = T.two_sum(h1, -(kf * _EXP_L2))       # k*L2 exact; TwoSum exact
    v = xl - kf * _EXP_L3                         # both ~2^-28: one rounding
    r = core_ff.add212(FF(sh, sl), v)
    return r.hi, r.lo, kf.to(torch.int32)


def _exp_poly(rh: Tensor, rl: Tensor) -> FF:
    """expm1(r) = r + r^2 W(r) on |r| <= ln2/2 as an FF pair."""
    t = _EXP_W_F32[-1]
    for c in _EXP_W_F32[-2::-1]:
        t = t * rh + c
    w = FF(t, torch.zeros_like(t))
    r = FF(rh, rl)
    for ch, cl in _EXP_W_FF[::-1]:
        w = core_ff.mul22(w, r)
        w = core_ff.add22(w, FF(torch.full_like(rh, ch),
                                torch.full_like(rh, cl)))
    z = core_ff.mul22(r, r)                       # r^2
    q = core_ff.mul22(z, w)                       # r^2 W
    return core_ff.add22(r, q)                    # r + r^2 W


def exp22(xh: Tensor, xl: Tensor) -> Limb:
    """FF exp of an FF input (raw limbs).  Saturates to inf above ~88.72
    and to 0 below ~-103, as the reference does."""
    rh, rl, k = _exp_reduce(xh, xl)
    s = _exp_poly(rh, rl)
    p = core_ff.add212(s, 1.0)                    # 1 + expm1(r)
    eh, el = _scale2k(p.hi, p.lo, k)
    inf = float("inf")
    big = xh > _EXP_CLIP_HI
    tiny = xh < _EXP_CLIP_LO
    eh = torch.where(big, inf, torch.where(tiny, 0.0, eh))
    # natural hi-limb overflow: zero the lo limb so the saturated FF is a
    # clean (inf, 0)
    el = torch.where(big | tiny | (eh == inf), 0.0, el)
    nan = xh != xh
    return torch.where(nan, xh, eh), torch.where(nan, xh, el)


def expm122(xh: Tensor, xl: Tensor) -> Limb:
    """FF expm1: the exp kernel without the +1 where the reduction
    integer k is 0, exp(x) - 1 beyond; x itself below 2^-45."""
    rh, rl, k = _exp_reduce(xh, xl)
    s = _exp_poly(rh, rl)                         # expm1(r): the k=0 answer
    p = core_ff.add212(s, 1.0)
    eh, el = _scale2k(p.hi, p.lo, k)
    g = core_ff.add212(FF(eh, el), -1.0)          # exp(x) - 1, k != 0
    inf = float("inf")
    ovf = eh == inf               # inf - 1 trips TwoSum nans: saturate
    gh = torch.where(ovf, eh, g.hi)
    gl = torch.where(ovf, 0.0, g.lo)
    small = k == 0
    oh = torch.where(small, s.hi, gh)
    ol = torch.where(small, s.lo, gl)
    idt = torch.abs(xh) < _IDENTITY
    oh = torch.where(idt, xh, oh)
    ol = torch.where(idt, xl, ol)
    big = xh > _EXP_CLIP_HI
    tiny = xh < _EXP_CLIP_LO
    oh = torch.where(big, inf, torch.where(tiny, -1.0, oh))
    ol = torch.where(big | tiny, 0.0, ol)
    nan = xh != xh
    return torch.where(nan, xh, oh), torch.where(nan, xh, ol)


# tanh's bands, the costliest first: the codes of tanh_band (the CUDA
# kernel's tanh22 runs only its element's band's branch)
TANH_LARGE, TANH_SMALL, TANH_IDENTITY = 0, 1, 2


def tanh_band(xh: Tensor) -> Tensor:
    """The branch tanh22 takes for each hi limb: TANH_IDENTITY below 2^-45,
    TANH_SMALL (the Maclaurin kernel) to 0.35, TANH_LARGE beyond, where
    nan and +-inf also go."""
    a = torch.abs(xh)
    return torch.where(a < _IDENTITY, TANH_IDENTITY,
                       torch.where(a <= _TANH_SMALL, TANH_SMALL, TANH_LARGE))


def tanh_small22(xh: Tensor, xl: Tensor) -> Limb:
    """tanh's Maclaurin branch, x p(x^2) (its band: |x| <= 0.35)."""
    x = FF(xh, xl)
    z = core_ff.mul22(x, x)
    t = _TANH_C_F32[-1]
    for c in _TANH_C_F32[-2::-1]:
        t = t * z.hi + c
    p = FF(t, torch.zeros_like(t))
    for ch, cl in _TANH_C_FF[::-1]:
        p = core_ff.mul22(p, z)
        p = core_ff.add22(p, FF(torch.full_like(xh, ch),
                                torch.full_like(xh, cl)))
    sm = core_ff.mul22(x, p)
    return sm.hi, sm.lo


def tanh_large22(xh: Tensor, xl: Tensor) -> Limb:
    """tanh's branch beyond 0.35: sgn(x) (-t / (2 + t)), t = expm1(-2|x|)."""
    sgn = torch.where(xh < 0, -1.0, 1.0)
    th, tl = expm122(-2.0 * sgn * xh, -2.0 * sgn * xl)
    d = core_ff.add212(FF(th, tl), 2.0)
    q = core_ff.div22(FF(-th, -tl), d)
    return sgn * q.hi, sgn * q.lo


def tanh22(xh: Tensor, xl: Tensor) -> Limb:
    """FF tanh: the odd Maclaurin kernel on |x| <= 0.35, -t/(2+t) with
    t = expm1(-2|x|) beyond, x itself below 2^-45: both branches
    evaluated, each element's selected by ``tanh_band``."""
    sh, sl = tanh_small22(xh, xl)
    qh, ql = tanh_large22(xh, xl)
    band = tanh_band(xh)
    small = band == TANH_SMALL
    rh = torch.where(small, sh, qh)
    rl = torch.where(small, sl, ql)
    idt = band == TANH_IDENTITY
    return torch.where(idt, xh, rh), torch.where(idt, xl, rl)


def sigmoid22(xh: Tensor, xl: Tensor) -> Limb:
    """FF logistic sigmoid, u / (1 + z) with z = exp(-|x|), u = 1 for
    x >= 0 and z otherwise (no cancellation)."""
    sgn = torch.where(xh < 0, -1.0, 1.0)
    zh, zl = exp22(-sgn * xh, -sgn * xl)
    d = core_ff.add212(FF(zh, zl), 1.0)
    pos = xh >= 0
    n = FF(torch.where(pos, 1.0, zh), torch.where(pos, 0.0, zl))
    r = core_ff.div22(n, d)
    nan = xh != xh
    return torch.where(nan, xh, r.hi), torch.where(nan, xh, r.lo)


def _atanh_poly(s: FF) -> FF:
    """S(z) = sum z^n/(2n+1) at z = s^2 <= 0.0295."""
    z = core_ff.mul22(s, s)
    t = _LOG_S_F32[-1]
    for c in _LOG_S_F32[-2::-1]:
        t = t * z.hi + c
    a = FF(t, torch.zeros_like(t))
    for ch, cl in _LOG_S_FF[::-1]:
        a = core_ff.mul22(a, z)
        a = core_ff.add22(a, FF(torch.full_like(s.hi, ch),
                                torch.full_like(s.hi, cl)))
    return a


def _log_core(mh: Tensor, ml: Tensor, ef: Tensor) -> FF:
    """log(2^e * m) = e*ln2 + 2 s S(s^2), s = (m-1)/(m+1)."""
    m = FF(mh, ml)
    n = core_ff.add212(m, -1.0)
    d = core_ff.add212(m, 1.0)
    s = core_ff.div22(n, d)
    p = _atanh_poly(s)
    l = core_ff.mul22(s, p)
    l = FF(2.0 * l.hi, 2.0 * l.lo)               # exact
    t = core_ff.mul212(FF(torch.full_like(ef, _LN2_H),
                          torch.full_like(ef, _LN2_L)), ef)
    return core_ff.add22(t, l)


def _frexp_sqrt2(xh: Tensor, xl: Tensor):
    """x = 2^e * m with m in [1/sqrt2, sqrt2), by exponent-bit surgery."""
    bits = xh.contiguous().view(torch.int32)
    e = ((bits >> 23) & 0xFF) - 127
    mh = ((bits & 0x007FFFFF) | 0x3F800000).to(torch.int32).view(
        torch.float32)
    big = mh > _SQRT2_F32
    mh = torch.where(big, mh * 0.5, mh)
    e = e + big.to(torch.int32)
    ml, _zero = _scale2k(xl, torch.zeros_like(xl), -e)
    return mh, ml, e


def log22(xh: Tensor, xl: Tensor) -> Limb:
    """FF natural log of an FF input: nan for x < 0, -inf at x == 0."""
    mh, ml, e = _frexp_sqrt2(xh, xl)
    r = _log_core(mh, ml, e.to(torch.float32))
    rh, rl = r.hi, r.lo
    bad = (xh < 0) | (xh != xh)
    rh = torch.where(xh == 0, float("-inf"),
                     torch.where(bad, float("nan"), rh))
    rh = torch.where(xh == float("inf"), float("inf"), rh)
    rl = torch.where((xh == 0) | bad | (xh == float("inf")), 0.0, rl)
    return rh, rl


def log1p22(xh: Tensor, xl: Tensor) -> Limb:
    """FF log1p: 2 atanh(x / (2 + x)) from x itself on the near branch
    (x in [-0.2929, 0.4142]), log of the exact 1 + x beyond; x itself
    below 2^-45."""
    d = core_ff.add212(FF(xh, xl), 2.0)
    s = core_ff.div22(FF(xh, xl), d)
    p = _atanh_poly(s)
    n = core_ff.mul22(s, p)
    nh, nl = 2.0 * n.hi, 2.0 * n.lo
    # the traced operand first, as the reference orders it
    wh, we = T.two_sum(xh, torch.ones_like(xh))
    wl = we + xl
    wh, wl = T.fast_two_sum(wh, wl)
    fh, fl = log22(wh, wl)
    near = (xh >= _LOG1P_NEAR[0]) & (xh <= _LOG1P_NEAR[1])
    rh = torch.where(near, nh, fh)
    rl = torch.where(near, nl, fl)
    idt = torch.abs(xh) < _IDENTITY
    rh = torch.where(idt, xh, rh)
    rl = torch.where(idt, xl, rl)
    inf = xh == float("inf")                      # 1 + inf trips TwoSum nans
    rh = torch.where(inf, float("inf"), rh)
    rl = torch.where(inf, 0.0, rl)
    nan = xh != xh
    return torch.where(nan, xh, rh), torch.where(nan, xh, rl)


def _ff_const(like: Tensor, c: Tuple[float, float]) -> FF:
    return FF(torch.full_like(like, c[0]), torch.full_like(like, c[1]))


def _erf_small(xh: Tensor, xl: Tensor) -> FF:
    """Alternating Maclaurin sum for |x| <= 1: (2/sqrt pi) x sum_n
    (-1)^n (x^2)^n / (n! (2n+1)), every term update in FF."""
    z = core_ff.mul22(FF(xh, xl), FF(xh, xl))
    zero = torch.zeros_like(xh)
    u = FF(torch.ones_like(xh), zero)
    a = FF(torch.ones_like(xh), zero)
    for n in range(1, _ERF_ALT_TERMS):
        u = core_ff.mul22(u, z)
        u = core_ff.div22(u, FF(_num(xh, float(n)), zero))   # z^n / n!
        t = core_ff.div22(u, FF(_num(xh, float(2 * n + 1)), zero))
        sg = -1.0 if n % 2 == 1 else 1.0
        a = core_ff.add22(a, FF(sg * t.hi, sg * t.lo))
    s = core_ff.mul22(FF(xh, xl), a)
    return core_ff.mul22(s, _ff_const(xh, _TWO_OVER_SQRTPI))


def _erf_mid(axh: Tensor, axl: Tensor) -> FF:
    """Positive (Kummer) series for 1 < x <= 4: (2x/sqrt pi) e^{-x^2}
    sum_n (2x^2)^n / (2n+1)!!, with e^{-x^2} the FF exp of the FF x^2."""
    z = core_ff.mul22(FF(axh, axl), FF(axh, axl))          # x^2
    v = FF(2.0 * z.hi, 2.0 * z.lo)                          # 2 x^2 (exact)
    zero = torch.zeros_like(axh)
    t = FF(torch.ones_like(axh), zero)
    a = FF(torch.ones_like(axh), zero)
    for n in range(1, _ERF_POS_TERMS):
        t = core_ff.mul22(t, v)
        t = core_ff.div22(t, FF(_num(axh, float(2 * n + 1)), zero))
        a = core_ff.add22(a, t)
    e = FF(*exp22(-z.hi, -z.lo))
    g = core_ff.mul22(FF(axh, axl), e)
    g = core_ff.mul22(g, a)
    return core_ff.mul22(g, _ff_const(axh, _TWO_OVER_SQRTPI))


def _erf_big(axh: Tensor, axl: Tensor) -> FF:
    """Asymptotic band x > 4: 1 - e^{-x^2} A(w) / (x sqrt pi),
    w = 1/(2x^2), A by an f32 Horner."""
    z = core_ff.mul22(FF(axh, axl), FF(axh, axl))          # x^2
    w = _num(z.hi, 0.5) / z.hi                              # f32 suffices
    a = _ERFC_ASY[-1]
    for c in _ERFC_ASY[-2::-1]:
        a = a * w + c
    e = FF(*exp22(-z.hi, -z.lo))
    u = core_ff.mul212(e, a)
    d = core_ff.mul22(FF(axh, axl), _ff_const(axh, _SQRTPI))
    c = core_ff.div22(u, d)                                 # erfc
    return core_ff.add212(FF(-c.hi, -c.lo), 1.0)            # 1 - erfc


def erf22(xh: Tensor, xl: Tensor) -> Limb:
    """FF error function: the alternating series on |x| <= 1, the
    positive series to 4, the asymptotic erfc beyond; |x| clamped at 30,
    erf(+-0) = +-0."""
    sgn = torch.where(xh < 0, -1.0, 1.0)
    axh, axl = sgn * xh, sgn * xl
    big_in = axh > _ERF_CLAMP
    axh = torch.minimum(axh, _num(axh, _ERF_CLAMP))
    axl = torch.where(big_in, 0.0, axl)
    sm = _erf_small(xh, xl)                       # odd series: sign built in
    md = _erf_mid(axh, axl)
    bg = _erf_big(axh, axl)
    mid = axh <= _ERF_MID
    lgh = torch.where(mid, md.hi, bg.hi)
    lgl = torch.where(mid, md.lo, bg.lo)
    small = axh <= _ERF_SMALL
    rh = torch.where(small, sm.hi, sgn * lgh)
    rl = torch.where(small, sm.lo, sgn * lgl)
    zero = xh == 0
    rh = torch.where(zero, xh, rh)
    rl = torch.where(zero, 0.0, rl)
    nan = xh != xh
    return torch.where(nan, xh, rh), torch.where(nan, xh, rl)


def _zero_and_rails(xh: Tensor, rh: Tensor, rl: Tensor) -> Limb:
    """f(+-0) = +-0, f(-inf) = 0, f(inf) = inf (gelu and silu)."""
    zero = xh == 0
    rh = torch.where(zero, xh, rh)
    rl = torch.where(zero, 0.0, rl)
    ninf, pinf = xh == float("-inf"), xh == float("inf")
    rh = torch.where(ninf, 0.0, torch.where(pinf, float("inf"), rh))
    rl = torch.where(ninf | pinf, 0.0, rl)
    return rh, rl


def gelu22(xh: Tensor, xl: Tensor) -> Limb:
    """FF exact-form GELU, 0.5 x (1 + erf(x / sqrt2))."""
    v = core_ff.mul22(FF(xh, xl), _ff_const(xh, _INV_SQRT2))
    e = FF(*erf22(v.hi, v.lo))
    o = core_ff.add212(e, 1.0)
    r = core_ff.mul22(FF(xh, xl), o)
    return _zero_and_rails(xh, 0.5 * r.hi, 0.5 * r.lo)   # exact scale


def silu22(xh: Tensor, xl: Tensor) -> Limb:
    """FF SiLU, x * sigmoid(x)."""
    s = FF(*sigmoid22(xh, xl))
    r = core_ff.mul22(FF(xh, xl), s)
    return _zero_and_rails(xh, r.hi, r.lo)


def pow22(ah: Tensor, al: Tensor, bh: Tensor, bl: Tensor) -> Limb:
    """FF a**b = exp(b log a): nan for a < 0; IEEE limits at a in
    {0, inf}; b == 0 gives 1, last (0**0 == 1)."""
    lh, ll = log22(ah, al)
    t = core_ff.mul22(FF(lh, ll), FF(bh, bl))
    rh, rl = exp22(t.hi, t.lo)
    inf = float("inf")
    for edge, blim in ((ah == 0, 0.0), (ah == inf, inf)):
        rh = torch.where(edge & (bh > 0), blim, rh)
        rh = torch.where(edge & (bh < 0), inf if blim == 0 else 0.0, rh)
        rl = torch.where(edge, 0.0, rl)
    b0 = bh == 0
    rh = torch.where(b0, 1.0, rh)
    rl = torch.where(b0, 0.0, rl)
    return rh, rl


UNARY22 = {
    "exp": exp22, "expm1": expm122, "log": log22, "log1p": log1p22,
    "tanh": tanh22, "sigmoid": sigmoid22, "erf": erf22, "gelu": gelu22,
    "silu": silu22,
}
