"""log1p, pow and log of the ``ff_math`` CUDA kernel on the FMA TwoProd
(``log1p22_fma``, ``pow22_fma`` and ``log22_fmapath`` of
``csrc/ff_eft.cuh``), emulated exactly on the CPU:

  * TwoProd as a multiply and an FMA: ``fma(a, b, -x)`` through float64,
    where ``a * b`` (48 bits) and ``a * b - x`` are exact, then one
    rounding to f32 (+0 where the error is zero, as the FMA gives);
  * the element's tests: the atanh argument s of log (``2^-48 <= |s.hi|
    <= 1/2``, or ``n.hi == 0``, m an exact power of two) and of log1p's
    near branch (with ``u != 0`` on its last Mul22, whose low limb is the
    output's); pow's product ``t = l b`` (``|t.hi| >= 2^-100``, ``|b.hi|
    < 2^100``) and exp's reduced argument; and ``log1p22`` / ``pow22`` /
    ``log22`` themselves (Dekker's TwoProd) on every other element.

That path is held bit for bit, signed zeros included, to the port's plain
``log1p22`` / ``pow22`` on each class of ``math_variants.log_pow_edges``,
to ``log22`` on those of ``math_variants.exp_log_edges``, and on the timed
inputs, and to the reference's on normal-range inputs.
Each guard is shown to matter: the bare FMA form differs from Dekker's
where it sends an element away.  Zero errors of the other sign arise on
the FMA path and leave no trace.  The device's constants and tests are the
emulated ones.
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ffmath as ref_math
from repro_torch.benchmarks import math_variants as mv
from repro_torch.core import ff as core_ff
from repro_torch.core import ffmath
from repro_torch.core import transforms as T
from repro_torch.core.ff import FF

CSRC = Path(core_ff.__file__).resolve().parents[1] / "csrc"
SRC = (CSRC / "ff_eft.cuh").read_text()
S_TOP, S_LEAST = 0.5, 2.0 ** -48          # the domain of |s.hi|
R_TOP, R_LEAST = 0.5, 2.0 ** -48          # exp's reduced argument |r.hi|
T_LEAST, B_TOP = 2.0 ** -100, 2.0 ** 100  # pow's |t.hi| and |b.hi|


def two_prod_fma(a, b, seen=None):
    if seen is not None:
        seen.append((a, b))
    x = a * b
    return x, (a.double() * b.double() - x.double()).float()


def mul22_fma(a: FF, b: FF, seen=None) -> FF:
    th, tl = two_prod_fma(a.hi, b.hi, seen)
    u = tl + (a.hi * b.lo + a.lo * b.hi)
    return FF(*T.fast_two_sum(th, u))


def mul212_fma(a: FF, b, seen=None) -> FF:
    th, tl = two_prod_fma(a.hi, b, seen)
    return FF(*T.fast_two_sum(th, tl + a.lo * b))


def div22_fma(a: FF, b: FF, seen=None) -> FF:
    ch = a.hi / b.hi
    th, tl = two_prod_fma(ch, b.hi, seen)
    cl = ((((a.hi - th) - tl) + a.lo) - ch * b.lo) / b.hi
    return FF(*T.fast_two_sum(ch, cl))


def horner(s_f32, s_ff, x: FF, z: FF, seen=None) -> FF:
    """An f32 Horner tail at z.hi, then an FF Horner at z (ffmath's
    _exp_poly and _atanh_poly), on mul22_fma."""
    t = s_f32[-1]
    for c in s_f32[-2::-1]:
        t = t * z.hi + c
    a = FF(t, torch.zeros_like(t))
    for ch, cl in s_ff[::-1]:
        a = mul22_fma(a, z, seen)
        a = core_ff.add22(a, FF(torch.full_like(x.hi, ch),
                                torch.full_like(x.hi, cl)))
    return a


def exp22_fma(xh, xl, seen=None):
    """ffmath.exp22 on mul22_fma, and whether r is in exp's domain."""
    rh, rl, k = ffmath._exp_reduce(xh, xl)
    r = FF(rh, rl)
    w = horner(ffmath._EXP_W_F32, ffmath._EXP_W_FF, r, r, seen)
    s = core_ff.add22(r, mul22_fma(mul22_fma(r, r, seen), w, seen))
    p = core_ff.add212(s, 1.0)
    eh, el = ffmath._scale2k(p.hi, p.lo, k)
    big, tiny = xh > ffmath._EXP_CLIP_HI, xh < ffmath._EXP_CLIP_LO
    eh = torch.where(big, math.inf, torch.where(tiny, 0.0, eh))
    el = torch.where(big | tiny | (eh == math.inf), 0.0, el)
    nan = xh != xh
    ar = rh.abs()
    ok = (ar <= R_TOP) & ((ar >= R_LEAST) | (ar == 0))
    return torch.where(nan, xh, eh), torch.where(nan, xh, el), ok


def atanh_poly_fma(s: FF, seen=None) -> FF:
    z = mul22_fma(s, s, seen)
    return horner(ffmath._LOG_S_F32, ffmath._LOG_S_FF, s, z, seen)


def s_ok(sh):
    a = sh.abs()
    return (a <= S_TOP) & (a >= S_LEAST)


def log22_fma(xh, xl, seen=None):
    """ffmath.log22 on the twins; (hi, lo, ok), ok the kernel's test as
    math_variants.dekker_elements emulates it (chip_smoke holds that to
    the card's)."""
    mh, ml, e = ffmath._frexp_sqrt2(xh, xl)
    ef = e.to(torch.float32)
    m = FF(mh, ml)
    n, d = core_ff.add212(m, -1.0), core_ff.add212(m, 1.0)
    s = div22_fma(n, d, seen)
    l = mul22_fma(s, atanh_poly_fma(s, seen), seen)
    tl = mul212_fma(FF(torch.full_like(ef, ffmath._LN2_H),
                       torch.full_like(ef, ffmath._LN2_L)), ef, seen)
    r = core_ff.add22(tl, FF(2.0 * l.hi, 2.0 * l.lo))
    bad = (xh < 0) | (xh != xh)
    rh = torch.where(xh == 0, -math.inf, torch.where(bad, math.nan, r.hi))
    rh = torch.where(xh == math.inf, math.inf, rh)
    rl = torch.where((xh == 0) | bad | (xh == math.inf), 0.0, r.lo)
    return rh, rl, ~mv.dekker_elements("log", xh, xl)


def log1p_body(xh, xl, seen=None):
    """log1p22 on the twins, each element on its own branch; (hi, lo,
    ok)."""
    x = FF(xh, xl)
    s = div22_fma(x, core_ff.add212(x, 2.0), seen)
    a = atanh_poly_fma(s, seen)
    th, tl = two_prod_fma(s.hi, a.hi, seen)
    u = tl + (s.hi * a.lo + s.lo * a.hi)
    nh, nl = T.fast_two_sum(th, u)
    wh, we = T.two_sum(xh, torch.ones_like(xh))
    fh, fl, far_ok = log22_fma(*T.fast_two_sum(wh, we + xl), seen)
    near = (xh >= ffmath._LOG1P_NEAR[0]) & (xh <= ffmath._LOG1P_NEAR[1])
    rh = torch.where(near, 2.0 * nh, fh)
    rl = torch.where(near, 2.0 * nl, fl)
    ok = torch.where(near, s_ok(s.hi) & (u != 0), far_ok)
    rest = (xh.abs() < ffmath._IDENTITY) | (xh == math.inf) | (xh != xh)
    rh = torch.where(xh.abs() < ffmath._IDENTITY, xh, rh)
    rl = torch.where(xh.abs() < ffmath._IDENTITY, xl, rl)
    rh = torch.where(xh == math.inf, math.inf, rh)
    rl = torch.where(xh == math.inf, 0.0, rl)
    nan = xh != xh
    return torch.where(nan, xh, rh), torch.where(nan, xh, rl), ok | rest


def pow_parts(ah, al, bh, bl, seen=None):
    """pow22 on the twins before its selections: (r, and its tests: log's,
    exp's, |t.hi| >= 2^-100, |b.hi| < 2^100)."""
    lh, ll, lok = log22_fma(ah, al, seen)
    t = mul22_fma(FF(lh, ll), FF(bh, bl), seen)
    rh, rl, eok = exp22_fma(t.hi, t.lo, seen)
    return (rh, rl), (lok, eok, t.hi.abs() >= T_LEAST, bh.abs() < B_TOP)


def pow_body(ah, al, bh, bl, seen=None):
    """pow22 on the twins; (hi, lo, ok)."""
    (rh, rl), tests = pow_parts(ah, al, bh, bl, seen)
    for edge, blim in ((ah == 0, 0.0), (ah == math.inf, math.inf)):
        rh = torch.where(edge & (bh > 0), blim, rh)
        rh = torch.where(edge & (bh < 0), math.inf if blim == 0 else 0.0, rh)
        rl = torch.where(edge, 0.0, rl)
    b0 = bh == 0
    ok = tests[0] & tests[1] & tests[2] & tests[3]
    return torch.where(b0, 1.0, rh), torch.where(b0, 0.0, rl), ok


BODY = {"pow": pow_body, "log1p": log1p_body, "log": log22_fma}
PLAIN = {"pow": ffmath.pow22, "log1p": ffmath.log1p22, "log": ffmath.log22}
OPS = tuple(BODY)


def device(op, *planes):
    """The kernel's element: the FMA form where ok, else the plain
    function; (hi, lo, ok)."""
    fh, fl, ok = BODY[op](*planes)
    ph, pl = PLAIN[op](*planes)
    return torch.where(ok, fh, ph), torch.where(ok, fl, pl), ok


def differs(a, b):
    """Where the bits differ (a NaN matches any NaN)."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return ~((a.view(torch.int32) == b.view(torch.int32)) | (na & nb))


EDGES = {**mv.log_pow_edges("cpu"), "log": mv.exp_log_edges("cpu")["log"]}


def _limbs(x, rng):
    h = torch.from_numpy(x.astype(np.float32))
    return h, h * 1e-8 * torch.from_numpy(
        rng.standard_normal(x.size).astype(np.float32))


def timed(op):
    """The operators phase's inputs (a = |N(0,1)| + 0.5, b = N(0,1); log1p
    and log on |N(0,1)| + 0.5) and, for log1p, x uniform in its near band
    (-0.29, 0.41), for log x = exp(U(-50, 50)), lo ~ hi 1e-8."""
    rng = np.random.default_rng(227)
    a = _limbs(np.abs(rng.standard_normal(20000)) + 0.5, rng)
    if op == "pow":
        return {"timed": a + _limbs(rng.standard_normal(20000), rng)}
    if op == "log":
        return {"timed": a, "timed exp(U(-50, 50))": _limbs(
            np.exp(rng.uniform(-50, 50, 20000)), rng)}
    return {"timed": a, "timed near band": _limbs(
        rng.uniform(-0.29, 0.41, 20000), rng)}


CASES = [(op, kind) for op in OPS
         for kind in list(EDGES[op]) + list(timed(op))]
# the classes whose every element the tests send to the Dekker body
OFF_PATH = {("pow", "a near 1, |b| in 2^100-2^127"),
            ("pow", "|b| in 2^-140-2^-90"),
            ("log", "lo ~ -2 hi (s near +-2^6.8)")}
# log's classes whose elements the test sends to log22 in part
LOG_FAR = {"2^k (1 + tiny)", "lo beyond hi", "non-finite, zero, negative",
           "|s| near 1/2 (lo beyond hi)"}


@pytest.mark.parametrize("op,kind", CASES, ids=[f"{o}-{k}" for o, k in CASES])
def test_fma_path_is_the_plain_function(op, kind):
    planes = {**EDGES[op], **timed(op)}[kind]
    gh, gl, ok = device(op, *planes)
    ph, pl = PLAIN[op](*planes)
    assert not (differs(gh, ph) | differs(gl, pl)).any()
    assert bool(ok.any()) != ((op, kind) in OFF_PATH)
    if op == "log":       # the classes meant to reach log22 do
        assert bool((~ok).any()) == (kind in LOG_FAR | {
            k for o, k in OFF_PATH if o == "log"})


@pytest.mark.parametrize("op", OPS)
def test_fma_path_is_the_reference(op):
    """On the timed inputs, whose limbs and results stay normal (XLA:CPU
    flushes subnormals, ROADMAP's FTZ policy)."""
    ref = {"pow": ref_math.pow22, "log1p": ref_math.log1p22,
           "log": ref_math.log22}[op]
    for planes in timed(op).values():
        gh, gl, ok = device(op, *planes)
        rh, rl = ref(*(jnp.asarray(p.numpy()) for p in planes))
        assert bool(ok.all())
        assert np.array_equal(np.asarray(rh).view(np.int32),
                              gh.numpy().view(np.int32))
        assert np.array_equal(np.asarray(rl).view(np.int32),
                              gl.numpy().view(np.int32))


@pytest.mark.parametrize("op", OPS)
def test_timed_inputs_take_the_fma_path(op):
    """Every element of chip_smoke's and math_variants' timed inputs (their
    distributions, another seed) takes the FMA path."""
    for planes in timed(op).values():
        assert bool(BODY[op](*planes)[2].all())


def _bare_differs(op, kind):
    planes = EDGES[op][kind]
    fh, fl, ok = BODY[op](*planes)
    ph, pl = PLAIN[op](*planes)
    return differs(fh, ph) | differs(fl, pl), ok, planes


def test_guard_on_s_above_half():
    """log1p's near band with lo limbs far beyond hi (2 + x near 0): the
    division's quotient is huge and Dekker's split of it overflows, nan
    against a finite value; the test on |s.hi| <= 1/2 sends those
    elements to log1p22."""
    bad, ok, (xh, xl) = _bare_differs("log1p", "near band, lo beyond hi")
    assert bad.any() and not (bad & ok).any()
    x = FF(xh, xl)
    s = div22_fma(x, core_ff.add212(x, 2.0))
    assert bool((s.hi[bad].abs() > S_TOP).all())


def test_guard_on_s_below_2_48():
    """Below ~2^-52, s s and the Horner's a z round in Dekker's partial
    products: atanh_poly on the FMA differs from Dekker's, and the test
    sends |s.hi| < 2^-48 away (2^-50 would leave the Horner's first
    product at exponents -104)."""
    rng = np.random.default_rng(229)
    e = rng.integers(-100, -44, 8192)
    sh = torch.from_numpy((np.ldexp(rng.uniform(1, 2, 8192), e)
                           * rng.choice([-1, 1], 8192)).astype(np.float32))
    s = FF(sh, sh * 2.0 ** -25)
    a, b = ffmath._atanh_poly(s), atanh_poly_fma(s)
    bad = differs(a.hi, b.hi) | differs(a.lo, b.lo)
    assert bad.any() and not (bad & s_ok(sh)).any()
    # the class that reaches it: a = 2^k with a tiny lo
    ah, al, _bh, _bl = EDGES["pow"]["a = 2^k, tiny lo"]
    lok = log22_fma(ah, al)[2]
    assert bool(lok.any()) and bool((~lok).any())


def test_guard_on_pow_product():
    """|b| in 2^-140 ... 2^-90: l b falls below 2^-100, where Dekker's
    TwoProd rounds its partial products; the bare FMA form of pow differs
    from pow22, and the test on |t.hi| sends those elements to it (exp's
    test on r = t also fails there)."""
    bad, ok, planes = _bare_differs("pow", "|b| in 2^-140-2^-90")
    assert bad.any() and not (bad & ok).any()
    _r, (lok, eok, tok, bok) = pow_parts(*planes)
    assert bool((~tok[bad]).all()) and bool((lok & bok)[bad].all())
    ah, al, bh, bl = planes
    l = FF(*ffmath.log22(ah, al))
    d, f = core_ff.mul22(l, FF(bh, bl)), mul22_fma(l, FF(bh, bl))
    prod_bad = differs(d.hi, f.hi) | differs(d.lo, f.lo)
    assert prod_bad.any() and not (prod_bad & tok).any()


def test_guard_on_pow_exponent():
    """a near 1 with |b| in 2^100 ... 2^127: from ~2^116 Dekker's split of
    b overflows (nan where the FMA gives 0 or inf); the test on |b.hi|
    sends every such element to pow22 (exp's test on r fails there too,
    the lo limb of l b being huge)."""
    bad, ok, planes = _bare_differs("pow", "a near 1, |b| in 2^100-2^127")
    assert bad.any() and not (bad & ok).any()
    _r, (lok, eok, tok, bok) = pow_parts(*planes)
    assert bool((~bok[bad]).all())
    ah, al, bh, bl = planes
    l = FF(*ffmath.log22(ah, al))
    d, f = core_ff.mul22(l, FF(bh, bl)), mul22_fma(l, FF(bh, bl))
    prod_bad = differs(d.hi, f.hi) | differs(d.lo, f.lo)
    assert bool(torch.isnan(d.lo[prod_bad]).any())
    assert prod_bad.any() and not (prod_bad & bok).any()


def test_guard_on_log1p_zero_error():
    """log1p's near branch returns 2 mul22(s, a): where its product is
    exact (a.hi == 1), s.hi's split low half negative and both cross
    products -0, Dekker's error is -0 and the FMA's +0, and that sign is
    the output's lo.  No log1p input found reaches it (a.lo ~ s^2/3 != 0
    on the branch); the operands show it, and u == 0 is what the kernel
    tests."""
    s = FF(torch.tensor([-(1.0 + 2.0 ** -23)]), torch.tensor([-0.0]))
    a = FF(torch.tensor([1.0]), torch.tensor([0.0]))
    d, f = core_ff.mul22(s, a), mul22_fma(s, a)
    assert torch.equal(d.hi, f.hi) and d.lo.item() == 0 == f.lo.item()
    assert math.copysign(1, d.lo.item()) != math.copysign(1, f.lo.item())
    th, tl = two_prod_fma(s.hi, a.hi)
    assert (tl + (s.hi * a.lo + s.lo * a.hi)).item() == 0     # u == 0


def test_guard_on_log_s_above_half():
    """log on lo ~ -2 hi: m = mh + ml near -1, so s = (m - 1) / (m + 1) is
    near +-2^6.8 and the atanh kernel's a.hi passes 2^116, where Dekker's
    split overflows (nan against the FMA's finite value); the test on
    |s.hi| <= 1/2 sends every such element to log22.  (Below 2^-48 the
    guard is shown on atanh_poly: test_guard_on_s_below_2_48.)"""
    bad, ok, (xh, xl) = _bare_differs("log", "lo ~ -2 hi (s near +-2^6.8)")
    assert bad.any() and not (bad & ok).any()
    mh, ml, _e = ffmath._frexp_sqrt2(xh, xl)
    n, d = (core_ff.add212(FF(mh, ml), c) for c in (-1.0, 1.0))
    assert bool(((n.hi / d.hi)[bad].abs() > S_TOP).all())
    ph = PLAIN["log"](xh, xl)[0]
    fh = BODY["log"](xh, xl)[0]
    assert bool((torch.isnan(ph) & torch.isfinite(fh))[bad].any())


def test_log_test_reads_s_hi_not_the_quotient():
    """The kernel tests div22_fma's s.hi = RN(ch + cl), not its quotient
    ch = n.hi / d.hi.  Near |s| = 1/2 (m near 3 and 1/3, lo beyond hi)
    d.hi is no power of two and the two fall on either side of 1/2, and
    the emulated test is the one on s.hi.  Near 2^-48 they cannot
    differ: there m is within 2^-46 of 1, d.hi = 2 and n.lo = 0, so ch
    is exact and s.hi == ch."""
    def parts(xh, xl):
        mh, ml, _e = ffmath._frexp_sqrt2(xh, xl)
        n, d = (core_ff.add212(FF(mh, ml), c) for c in (-1.0, 1.0))
        return n, d, div22_fma(n, d).hi
    xh, xl = EDGES["log"]["|s| near 1/2 (lo beyond hi)"]
    n, d, sh = parts(xh, xl)
    on_s, on_ch = s_ok(sh) | (n.hi == 0), s_ok(n.hi / d.hi) | (n.hi == 0)
    assert bool((on_s != on_ch).any())
    assert torch.equal(~mv.dekker_elements("log", xh, xl), on_s)
    for kind in ("2^k (1 + tiny)", "near 1 and sqrt2"):
        n, d, sh = parts(*EDGES["log"][kind])
        small = sh.abs() < 2.0 ** -40
        assert bool(small.any()) and bool((d.hi[small] == 2).all())
        assert torch.equal(sh[small], (n.hi / d.hi)[small])


def test_log_output_drops_the_zero_sign_at_e_zero():
    """log's own output has no exp after it: at e == 0 (x in [1/sqrt2,
    sqrt2)) tl = mul212(ln2, +0) is (+0, +0) in both forms, and add22(tl,
    l) gives the same bits for l.lo = +0 and -0 (tl.lo + l.lo = +0); l.hi,
    2 RN(s.hi a.hi), is never -0 on the domain."""
    e = torch.zeros(4)
    ln2 = FF(torch.full_like(e, ffmath._LN2_H),
             torch.full_like(e, ffmath._LN2_L))
    d, f = core_ff.mul212(ln2, e), mul212_fma(ln2, e)
    zero = torch.zeros(4, dtype=torch.int32)               # +0 bits
    for t in (d, f):
        assert torch.equal(t.hi.view(torch.int32), zero)
        assert torch.equal(t.lo.view(torch.int32), zero)
    lh = torch.tensor([0.25, -0.125, 2.0 ** -40, -3.0])
    a = core_ff.add22(d, FF(lh, torch.zeros(4)))
    b = core_ff.add22(d, FF(lh, -torch.zeros(4)))
    assert not (differs(a.hi, b.hi) | differs(a.lo, b.lo)).any()
    # on log's e == 0 inputs the FMA path's l.hi is never -0
    xh, xl = EDGES["log"]["near 1 and sqrt2"]
    mh, ml, ee = ffmath._frexp_sqrt2(xh, xl)
    n, dd = (core_ff.add212(FF(mh, ml), c) for c in (-1.0, 1.0))
    sq = div22_fma(n, dd)
    l = mul22_fma(sq, atanh_poly_fma(sq))
    ok = s_ok(sq.hi) | (n.hi == 0)
    assert bool((ee == 0).any())
    assert not ((l.hi == 0) & (l.hi.view(torch.int32) < 0) & ok).any()


@pytest.mark.parametrize("op", OPS)
def test_zero_errors_of_either_sign_leave_no_trace(op):
    """On exact products the FMA path meets errors that Dekker's TwoProd
    gives as -0 (its own +0); the outputs are the plain function's all the
    same (div22's x1, the Horner's add22, add22(tl, l), exp_reduce and
    exp22's +1 drop the sign)."""
    planes = EDGES[op]["exact products"]
    seen = []
    fh, fl, ok = BODY[op](*planes, seen=seen)
    neg = torch.zeros_like(planes[0], dtype=torch.bool)
    for a, b in seen:
        y = T.two_prod(a, b)[1]
        neg |= (y == 0) & (y.view(torch.int32) < 0)
    assert bool((neg & ok).any())
    ph, pl = PLAIN[op](*planes)
    assert not ((differs(fh, ph) | differs(fl, pl)) & ok).any()


def test_ln2_split_keeps_the_zero_product_positive():
    """mul212(ln2, e) for every exponent log22 gives (e in [-127, 129]):
    at e == 0 Dekker's split of LN2_H has a positive low half, so its
    error is +0, as the FMA's; both forms agree, and their lo is never
    -0 (add22(tl, l) then drops a zero l.lo's sign)."""
    e = torch.arange(-127, 130, dtype=torch.float32)
    ln2 = torch.full_like(e, ffmath._LN2_H)
    assert T.split(ln2)[1][0].item() > 0
    y = T.two_prod(ln2, e)[1]
    assert math.copysign(1, y[e == 0].item()) == 1
    f = mul212_fma(FF(ln2, torch.full_like(e, ffmath._LN2_L)), e)
    d = core_ff.mul212(FF(ln2, torch.full_like(e, ffmath._LN2_L)), e)
    assert not (differs(d.hi, f.hi) | differs(d.lo, f.lo)).any()
    assert not ((d.lo == 0) & (d.lo.view(torch.int32) < 0)).any()


def _body(fn):
    b = SRC[SRC.index(fn):]
    return b[:b.index("\n}\n")]


def _floats(fn):
    return sorted(float.fromhex(t[:-1]) for t in
                  re.findall(r"-?0x[0-9a-f.]+p[-+]\d+f", _body(fn)))


def test_device_constants_are_the_emulated_ones():
    """The twins have their Dekker forms' constants; the tests and the
    flat loop's instances are the ones emulated and documented."""
    assert _floats("ff2 atanh_poly_fma(ff2 s) {") == _floats(
        "ff2 atanh_poly(ff2 s) {")
    assert len(_floats("ff2 atanh_poly(ff2 s) {")) == 13
    assert _floats("ff2 log_finish(") == _floats("ff2 log_core(")
    assert _floats("float log_reduce(") == _floats("ff2 log22(")
    assert set(_floats("ff2 log1p22(")) <= set(
        _floats("ff2 log1p22_fma_body("))
    assert "return as <= 0.5f && as >= 0x1p-48f;" in _body(
        "bool atanh_arg_ok(")
    assert "*ok = atanh_arg_ok(sh) || n.hi == 0.0f;" in _body(
        "ff2 log22_fma(")
    log1p = _body("ff2 log1p22_fma_body(")
    assert "*ok = atanh_arg_ok(sh) && u != 0.0f;" in log1p
    assert "*ok = atanh_arg_ok(sh) || n.hi == 0.0f;" in log1p
    assert ("lok && eok && fabsf(t.hi) >= 0x1p-100f && fabsf(bh) < "
            "kSplitSafe" in _body("ff2 pow22_fma("))
    assert "kSplitSafe = 0x1p+100f;" in SRC
    assert (S_TOP, S_LEAST, T_LEAST, B_TOP) == (
        0.5, float.fromhex("0x1p-48"), float.fromhex("0x1p-100"),
        float.fromhex("0x1p+100"))
    assert [float.fromhex(v) for v in ("-0x1.2bec32p-2", "0x1.a82798p-2")] \
        == [float(np.float32(v)) for v in ffmath._LOG1P_NEAR] \
        == list(mv.LOG1P_NEAR)
    assert "  if (!ok) r = log22(xh, xl);\n" in _body("ff2 log22_fmapath(")
    assert "ff2 r = log22_fma(xh, xl, &ok);" in _body("ff2 log22_fmapath(")
    cu = (CSRC / "ff_math.cu").read_text()
    assert ("constexpr bool kFlat = OP == EXP || OP == EXPM1 || OP == LOG "
            "||\n    OP == SIGMOID || OP == SILU || OP == LOG1P || OP == POW;"
            in cu)
    assert "return log22_fmapath(h, l);" in cu
    assert "return log1p22_fma(h, l);" in cu
    assert "return pow22_fma(h, l, bh, bl);" in cu
    # pow's flat loop reads four planes, so all four must be dense
    assert ("t.cs[2] == 1 && t.cs[3] == 1 && t.rs[2] == t.cols &&\n"
            "           t.rs[3] == t.cols" in cu)
