"""The exact division by a small integer of ``csrc/ff_eft.cuh``, which the
erf series of the ``ff_math`` kernel run instead of IEEE division,
emulated exactly on the CPU for each of the 68 divisors of the series
(n = 1..16, the odd 2n + 1 to 119):

  * ``div_int``: for odd d, q0 = RN(a zh), r = -RN(q0 d - a), q =
    RN(r zh + q0) with zh = RN(1/d), each FMA emulated exactly (the
    float64 product, a TwoSum and a midpoint fix of the last rounding);
    d = 1 and powers of two exact, another even d = m 2^k as RN(a/m)
    scaled, with the tie fix on the subnormal grid: RN(a/d) on 2^16
    seeded mantissas in each of the binades 2^0, 2^-60 and 2^-119 (where
    quotients turn subnormal), of either sign, on every subnormal with a
    mantissa below 2^14, and at the binade edges, +-0, +-inf and nan; the
    product a zh alone is not;
  * ``div22_int`` (that division, TwoProd by FMA, without div22's
    ``- ch * 0``) is bit for bit the port's ``div22(a, (d, 0))`` on FF
    dividends of every magnitude, with signed-zero, subnormal, huge and
    non-finite limbs;
  * the device's hex-float table ``kRecip`` is float32(1/d), and its guard
    constants are the ones emulated here.

On the card, ``chip_smoke.py`` holds both against IEEE division and
``div22`` for every f32 bit pattern.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import ff as core_ff
from repro_torch.core.ff import FF

SRC = (Path(core_ff.__file__).resolve().parents[1] / "csrc"
       / "ff_eft.cuh").read_text()
DIVISORS = list(range(1, 17)) + list(range(17, 120, 2))
SPLIT_SAFE = 2.0 ** 100       # kSplitSafe: div22 itself at and beyond it
F32 = np.float32
INF = np.float32(np.inf)


def test_divisors_are_the_series():
    assert len(DIVISORS) == 68
    assert set(DIVISORS) == set(range(1, 17)) | {2 * n + 1
                                                 for n in range(1, 60)}


def test_reciprocal_table_and_guards():
    """kRecip[d] == float32(1/d) for every d < 120 (entry 0 unused); the
    guard constants are those emulated here."""
    body = SRC[SRC.index("kRecip[kDivLimit] = {"):]
    body = body[body.index("{") + 1:body.index("};")]
    vals = [float.fromhex(t[:-1]) for t in
            re.findall(r"-?0x[0-9a-f.]+p[-+]\d+f|0\.0f", body)
            if t != "0.0f"]
    assert "kDivLimit = 120;" in SRC and len(vals) == 119
    for d, v in enumerate(vals, start=1):
        assert v == float(F32(1.0) / F32(d)), d
    assert "kSplitSafe = 0x1p+100f;" in SRC


def fma32(a, b, c):
    """RN32(a b + c) of float32 arrays, exactly: a b is exact in float64,
    a TwoSum gives s + e == a b + c; s rounds to float32 correctly unless
    it is a float32 midpoint and e != 0, where e picks the side."""
    with np.errstate(all="ignore"):
        p = a.astype(np.float64) * b.astype(np.float64)
        c64 = c.astype(np.float64)
        s = p + c64
        bb = s - p
        e = (p - (s - bb)) + (c64 - bb)
        r = s.astype(F32)
        r64 = r.astype(np.float64)
        nb = np.nextafter(r, np.where(s > r64, INF, -INF)).astype(F32)
        mid = (r64 + nb.astype(np.float64)) / 2
        fix = np.isfinite(s) & (s != r64) & (s == mid) & (e != 0)
        side = np.sign(nb.astype(np.float64) - r64) == np.sign(e)
        e0 = np.where(np.isfinite(e), e, 0.0)
        return np.where(fix & side & (e0 != 0), nb, r).astype(F32)


def div_odd(a, m):
    """The device's div_odd (m odd >= 3), emulated."""
    zh = F32(1.0) / F32(m)
    with np.errstate(all="ignore"):
        q0 = a * zh
        q = fma32(-fma32(q0, np.full_like(a, F32(m)), -a), np.full_like(a, zh),
                  q0)
        return np.where(np.abs(q0) == INF, q0, q)


def div_int(a, d):
    """The device's div_int(a, d) (ff_eft.cuh), emulated: d = m 2^k."""
    if d == 1:
        return a.copy()
    k = (d & -d).bit_length() - 1
    m, scale = d >> k, F32(2.0 ** -k)
    with np.errstate(all="ignore"):
        if m == 1:
            return a * scale
        q1 = div_odd(a, m)
        if k == 0:
            return q1
        q = q1 * scale
        e = fma32(-q, np.full_like(a, F32(2 ** k)), q1)
        r1 = -fma32(q1, np.full_like(a, F32(m)), -a)
        fix = ((np.abs(e) == F32(2.0 ** (k - 150))) & (r1 != 0)
               & ((r1 > 0) == (e > 0)))
        return np.where(fix, fma32(e, np.full_like(a, 2 * scale), q), q)


def rn_div(a, d):
    """RN32(a / d): the float64 quotient is within 2^-53 relative of a/d,
    which lies at least ulp/(2d) from a float32 midpoint unless it is one,
    and then exactly representable: one rounding to float32 is exact."""
    with np.errstate(all="ignore"):
        return (a.astype(np.float64) / d).astype(F32)


def same(a, b) -> bool:
    """The same bits; a NaN matches any NaN."""
    a, b = np.asarray(a, F32), np.asarray(b, F32)
    na, nb = np.isnan(a), np.isnan(b)
    return bool(np.array_equal(na, nb)
                and np.array_equal(a[~na].view(np.int32),
                                   b[~nb].view(np.int32)))


def _binade(rng, e, n):
    """n seeded f32 values in [2^e, 2^(e+1)) (every mantissa equally
    likely), of random sign."""
    m = rng.integers(0, 1 << 23, n, dtype=np.int64)
    x = ((1 << 23) + m).astype(np.float64) * 2.0 ** (e - 23)
    return np.where(rng.random(n) < 0.5, -x, x).astype(F32)


def _edges():
    """Binade edges, the largest and smallest floats, the subnormals with
    mantissas below 2^14 (the subnormal quotients' ties and near-ties),
    spread subnormal patterns, +-0, +-inf and nan, of both signs."""
    f = np.finfo(F32)
    pts = [F32(1), np.nextafter(F32(1), F32(0)), np.nextafter(F32(2), F32(0)),
           f.max, f.tiny, np.nextafter(f.tiny, F32(0)), F32(2.0 ** -126 * 1.5),
           F32(2.0 ** 100), np.nextafter(F32(2.0 ** 100), F32(0)), F32(0.0),
           INF, F32(np.nan)]
    pts = np.array(pts, F32)
    low = np.arange(1, 1 << 14, dtype=np.uint32).view(F32)
    spread = (np.arange(1, 4096, dtype=np.int64) * 2047).astype(
        np.uint32).view(F32)
    return np.concatenate([pts, -pts, low, -low, spread, -spread]).astype(F32)


@pytest.mark.parametrize("d", DIVISORS)
def test_div_int_is_the_rounded_quotient(d):
    rng = np.random.default_rng(1000 + d)
    a = np.concatenate([_binade(rng, 0, 1 << 16), _binade(rng, -60, 1 << 16),
                        _binade(rng, -119, 1 << 16), _binade(rng, 99, 1 << 12),
                        _edges()])
    assert same(div_int(a, d), rn_div(a, d))
    if d & (d - 1):
        # the correction matters: a zh alone misses RN(a/d) often
        b = a[:3 << 16]
        assert (b * (F32(1) / F32(d)) != rn_div(b, d)).mean() > 0.01


def _ff_dividends(rng, n):
    """FF pairs: hi of every magnitude (subnormal to 2^127, +-0, +-inf,
    nan), lo +-0, a few ulps of hi of either sign, or non-finite."""
    e = rng.integers(-149, 128, n)
    hi = (rng.uniform(1.0, 2.0, n) * 2.0 ** e.astype(np.float64))
    hi = np.where(rng.random(n) < 0.5, -hi, hi).astype(F32)
    hi[:8] = [0.0, -0.0, np.inf, -np.inf, np.nan, 2.0 ** 100, -2.0 ** 101,
              2.0 ** -126]
    kind = rng.integers(0, 8, n)
    frac = rng.uniform(-1.0, 1.0, n) * 2.0 ** -24
    with np.errstate(all="ignore"):
        scaled = (hi.astype(np.float64) * frac).astype(F32)
    lo = np.select([kind == 0, kind == 1, kind == 2],
                   [F32(0.0), F32(-0.0), F32(np.inf)], scaled).astype(F32)
    lo[np.isnan(hi)] = np.nan
    return hi, lo


@pytest.mark.parametrize("d", DIVISORS)
def test_div22_int_is_div22(d):
    rng = np.random.default_rng(2000 + d)
    ah, al = _ff_dividends(rng, 1 << 14)
    want = core_ff.div22(FF(torch.from_numpy(ah), torch.from_numpy(al)),
                         FF(torch.full((ah.size,), float(d)),
                            torch.zeros(ah.size)))
    d32 = np.full_like(ah, F32(d))
    with np.errstate(all="ignore"):
        ch = div_int(ah, d)
        th = ch * d32
        tl = fma32(ch, d32, -th)
        cl = div_int(((ah - th) - tl) + al, d)   # no "- ch * 0": see the .cuh
        sh = ch + cl
        sl = cl - (sh - ch)
    fast = np.abs(ch) < F32(SPLIT_SAFE)
    assert fast.mean() > 0.6
    got_h = np.where(fast, sh, want.hi.numpy())
    got_l = np.where(fast, sl, want.lo.numpy())
    assert same(got_h, want.hi.numpy()) and same(got_l, want.lo.numpy())
