"""sigmoid, silu, expm1 and exp of the ``ff_math`` CUDA kernel on the FMA
TwoProd (``sigmoid22_fma``, ``silu22_fma``, ``expm122_fmapath`` and
``exp22_fmapath`` of ``csrc/ff_eft.cuh``), emulated exactly on the CPU:

  * TwoProd as a multiply and an FMA: ``fma(a, b, -x)`` through float64,
    where ``a * b`` (48 bits) and ``a * b - x`` are exact, then one
    rounding to f32 (+0 where the error is zero, as the FMA gives);
  * the element's test on its reduced argument r (``|r.hi| <= 1/2`` and
    ``|r.hi| >= 2^-48`` or ``r.hi == 0``), silu's on its last product
    (``2^-100 <= |t.hi| < 2^100``, ``u != 0``), and ``sigmoid22`` /
    ``silu22`` / ``expm122`` / ``exp22`` themselves (Dekker's TwoProd) on
    every other element (expm1 and exp take exp's test alone).

That path is held bit for bit, signed zeros included, to the port's
plain ``sigmoid22`` / ``silu22`` on each class of
``math_variants.sigmoid_edges`` (subnormal z, k ln2 cancelled by lo,
|x| from 2^-150, lo +-0 and +-hi 2^-25, exact products, subnormal and
non-finite limbs, lo beyond hi) and on x uniform in (-30, 30), and to the
reference's on normal-range inputs; expm1 and exp the same on each of
their classes of ``math_variants.exp_log_edges`` and on their timed
inputs.  Each guard is
shown to matter: the bare FMA form differs from Dekker's where it sends
an element away.  Zero errors of the other sign do arise on the FMA path
(for expm1 also on its k == 0 branch, which has no +1) and leave no
trace: ``exp_poly_fma`` is ``exp_poly`` bit for bit on the domain.  The
device's constants are the emulated ones.
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

SRC = (Path(core_ff.__file__).resolve().parents[1] / "csrc"
       / "ff_eft.cuh").read_text()
OPS = ("sigmoid", "silu")
R_TOP, R_LEAST = 0.5, 2.0 ** -48          # the domain of |r.hi|
T_LEAST, T_TOP = 2.0 ** -100, 2.0 ** 100  # silu's last product |t.hi|


def two_prod_fma(a, b):
    x = a * b
    return x, (a.double() * b.double() - x.double()).float()


def mul22_fma(a: FF, b: FF, seen=None) -> FF:
    if seen is not None:
        seen.append((a.hi, b.hi))
    th, tl = two_prod_fma(a.hi, b.hi)
    u = tl + (a.hi * b.lo + a.lo * b.hi)
    return FF(*T.fast_two_sum(th, u))


def div22_fma(a: FF, b: FF) -> FF:
    ch = a.hi / b.hi
    th, tl = two_prod_fma(ch, b.hi)
    cl = ((((a.hi - th) - tl) + a.lo) - ch * b.lo) / b.hi
    return FF(*T.fast_two_sum(ch, cl))


def exp_poly_fma(rh, rl, seen=None) -> FF:
    """ffmath._exp_poly on mul22_fma."""
    t = ffmath._EXP_W_F32[-1]
    for c in ffmath._EXP_W_F32[-2::-1]:
        t = t * rh + c
    w, r = FF(t, torch.zeros_like(t)), FF(rh, rl)
    for ch, cl in ffmath._EXP_W_FF[::-1]:
        w = mul22_fma(w, r, seen)
        w = core_ff.add22(w, FF(torch.full_like(rh, ch),
                                torch.full_like(rh, cl)))
    z = mul22_fma(r, r, seen)
    q = mul22_fma(z, w, seen)
    return core_ff.add22(r, q)


def in_domain(rh):
    ar = rh.abs()
    return (ar <= R_TOP) & ((ar >= R_LEAST) | (ar == 0))


def exp22_fma(xh, xl, seen=None):
    """ffmath.exp22 on exp_poly_fma, and whether r is in the domain."""
    rh, rl, k = ffmath._exp_reduce(xh, xl)
    s = exp_poly_fma(rh, rl, seen)
    p = core_ff.add212(s, 1.0)
    eh, el = ffmath._scale2k(p.hi, p.lo, k)
    big, tiny = xh > ffmath._EXP_CLIP_HI, xh < ffmath._EXP_CLIP_LO
    eh = torch.where(big, math.inf, torch.where(tiny, 0.0, eh))
    el = torch.where(big | tiny | (eh == math.inf), 0.0, el)
    nan = xh != xh
    return torch.where(nan, xh, eh), torch.where(nan, xh, el), in_domain(rh)


def sigmoid_body(xh, xl):
    """sigmoid22 on the twins; (hi, lo, ok)."""
    sgn = torch.where(xh < 0, -1.0, 1.0)
    zh, zl, ok = exp22_fma(-sgn * xh, -sgn * xl)
    d = core_ff.add212(FF(zh, zl), 1.0)
    pos = xh >= 0
    r = div22_fma(FF(torch.where(pos, 1.0, zh), torch.where(pos, 0.0, zl)),
                  d)
    nan = xh != xh
    return torch.where(nan, xh, r.hi), torch.where(nan, xh, r.lo), ok


def silu_body(xh, xl):
    """silu22 on the twins; (hi, lo, ok): the rails, then x s with its
    test."""
    sh, sl, ok = sigmoid_body(xh, xl)
    th, tl = two_prod_fma(xh, sh)
    u = tl + (xh * sl + xl * sh)
    rh, rl = T.fast_two_sum(th, u)
    at = th.abs()
    ok = ok & (at >= T_LEAST) & (at < T_TOP) & (u != 0)
    rh, rl = ffmath._zero_and_rails(xh, rh, rl)
    return rh, rl, ok | (xh == 0) | torch.isinf(xh)


BODY = {"sigmoid": sigmoid_body, "silu": silu_body}


def device(op, xh, xl):
    """The kernel's element: the FMA form where ok, else the plain
    function; (hi, lo, ok)."""
    fh, fl, ok = BODY[op](xh, xl)
    ph, pl = ffmath.UNARY22[op](xh, xl)
    return torch.where(ok, fh, ph), torch.where(ok, fl, pl), ok


def differs(a, b):
    """Where the bits differ (a NaN matches any NaN)."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return ~((a.view(torch.int32) == b.view(torch.int32)) | (na & nb))


EDGES = mv.sigmoid_edges("cpu")


def _inputs(kind):
    if kind in EDGES:
        return EDGES[kind]
    rng = np.random.default_rng(211)
    x = rng.uniform(-30, 30, 20000)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return torch.from_numpy(hi), torch.from_numpy(lo)


@pytest.mark.parametrize("kind", list(EDGES) + ["uniform (-30, 30)"])
@pytest.mark.parametrize("op", OPS)
def test_fma_path_is_the_plain_function(op, kind):
    xh, xl = _inputs(kind)
    gh, gl, ok = device(op, xh, xl)
    ph, pl = ffmath.UNARY22[op](xh, xl)
    assert not (differs(gh, ph) | differs(gl, pl)).any()
    if kind in ("uniform (-30, 30)", "lo signed zeros", "z subnormal"):
        assert ok.any()                 # the class reaches the FMA path


@pytest.mark.parametrize("op", OPS)
def test_fma_path_is_the_reference(op):
    """On x uniform in (-30, 30), whose limbs and results stay normal
    (XLA:CPU flushes subnormals, ROADMAP's FTZ policy)."""
    xh, xl = _inputs("uniform (-30, 30)")
    gh, gl, ok = device(op, xh, xl)
    rh, rl = ref_math.UNARY22[op](jnp.asarray(xh.numpy()),
                                  jnp.asarray(xl.numpy()))
    assert bool(ok.all())
    assert np.array_equal(np.asarray(rh).view(np.int32),
                          gh.numpy().view(np.int32))
    assert np.array_equal(np.asarray(rl).view(np.int32),
                          gl.numpy().view(np.int32))


@pytest.mark.parametrize("op", OPS)
def test_timed_inputs_take_the_fma_path(op):
    """The operators phase's |N(0,1)| + 0.5 and x uniform in (-30, 30),
    with lo ~ hi 1e-8: every element on the FMA path."""
    g = torch.Generator().manual_seed(13)
    h = torch.cat([torch.randn(20000, generator=g).abs() + 0.5,
                   torch.rand(20000, generator=g) * 60 - 30])
    lo = h * 1e-8 * torch.randn(h.shape, generator=g)
    assert bool(BODY[op](h, lo)[2].all())


def test_guard_on_r_above_half():
    """Limbs whose lo exceeds hi put r beyond 1/2; there Dekker's splits
    overflow where the FMA's products do not: the bare FMA form is not
    sigmoid22 (nan against a finite value), and the test sends those
    elements to it."""
    xh, xl = EDGES["lo beyond hi"]
    for op in OPS:
        fh, fl, ok = BODY[op](xh, xl)
        ph, pl = ffmath.UNARY22[op](xh, xl)
        bad = differs(fh, ph) | differs(fl, pl)
        assert bad.any() and not (bad & ok).any()
    sgn = torch.where(xh < 0, -1.0, 1.0)
    rh = ffmath._exp_reduce(-sgn * xh, -sgn * xl)[0]
    assert bool((rh.abs() > R_TOP).any())


def test_guard_on_r_below_2_48():
    """Below 2^-48, r r (and, lower, w r) underflows in Dekker's partial
    products: exp22's polynomial on the FMA differs from Dekker's, and
    the test sends such r away.  (On the sampled sigmoid inputs the +1 of
    exp22 hid the difference.)"""
    rng = np.random.default_rng(223)
    e = rng.uniform(-110, -50, 4096)
    rh = torch.from_numpy((np.exp2(e) * rng.choice([-1, 1], 4096))
                          .astype(np.float32))
    rl = torch.zeros_like(rh)
    a, b = ffmath._exp_poly(rh, rl), exp_poly_fma(rh, rl)
    bad = differs(a.hi, b.hi) | differs(a.lo, b.lo)
    assert bad.any() and not (bad & in_domain(rh)).any()
    r2 = core_ff.mul22(FF(rh, rl), FF(rh, rl))
    f2 = mul22_fma(FF(rh, rl), FF(rh, rl))
    assert (differs(r2.hi, f2.hi) | differs(r2.lo, f2.lo)).any()


def test_guard_on_silu_product():
    """Where x s falls below 2^-100 (x below ~-73.6, z subnormal), Dekker's
    product of x and s rounds its partial products: the bare FMA form of
    silu differs from silu22 and the test on t.hi sends those elements to
    it."""
    xh, xl = EDGES["z subnormal"]
    fh, fl, ok = silu_body(xh, xl)
    ph, pl = ffmath.silu22(xh, xl)
    bad = differs(fh, ph) | differs(fl, pl)
    assert bad.any() and not (bad & ok).any()
    sgn = torch.where(xh < 0, -1.0, 1.0)
    zh, _zl, rok = exp22_fma(-sgn * xh, -sgn * xl)
    assert bool(rok[bad].all())         # r was fine: the product's test
    sh, sl, _ = sigmoid_body(xh, xl)    # sigmoid's bits are sigmoid22's
    qh, ql = ffmath.sigmoid22(xh, xl)
    assert not (differs(sh, qh) | differs(sl, ql)).any()


def test_guard_on_silu_zero_error():
    """silu's last Mul22 is the output: where its product is exact and
    one split half is +0 and the other negative, Dekker's error is -0
    and the FMA's +0, and with x.lo = -0, s.lo = +0, x < 0 that sign is the
    output's lo.  No silu input found reaches it; the operands show it,
    and u == 0 is what the kernel tests."""
    x = FF(torch.tensor([-(1.0 + 2.0 ** -23)]), torch.tensor([-0.0]))
    s = FF(torch.tensor([0.5]), torch.tensor([0.0]))
    d, f = core_ff.mul22(x, s), mul22_fma(x, s)
    assert torch.equal(d.hi, f.hi) and d.lo.item() == 0 == f.lo.item()
    assert math.copysign(1, d.lo.item()) == -1
    assert math.copysign(1, f.lo.item()) == 1
    th, tl = two_prod_fma(x.hi, s.hi)
    assert (tl + (x.hi * s.lo + x.lo * s.hi)).item() == 0     # u == 0


def test_zero_errors_of_either_sign_leave_no_trace():
    """On exact products the FMA path meets errors that Dekker's TwoProd
    gives as -0 (its own +0) in exp22's Mul22s; the outputs are
    sigmoid22's all the same (Horner's add22, the +1 of exp22 and div22
    drop the sign)."""
    xh, xl = EDGES["exact products"]
    seen = []
    sgn = torch.where(xh < 0, -1.0, 1.0)
    zh, zl, ok = exp22_fma(-sgn * xh, -sgn * xl, seen)
    neg = torch.zeros_like(xh, dtype=torch.bool)
    for a, b in seen:
        y = T.two_prod(a, b)[1]
        neg |= (y == 0) & (torch.sign(y.view(torch.int32)) < 0)
    assert bool((neg & ok).any())
    wh, wl = ffmath.exp22(-sgn * xh, -sgn * xl)
    assert not ((differs(zh, wh) | differs(zl, wl)) & ok).any()


def _body(fn):
    b = SRC[SRC.index(fn):]
    return b[:b.index("\n}\n")]


def test_device_constants_are_the_emulated_ones():
    """exp_poly_fma has exp_poly's constants; the domain's bounds and
    the kFlat instances are the ones emulated and documented."""
    def floats(fn):
        return sorted(float.fromhex(t[:-1]) for t in
                      re.findall(r"-?0x[0-9a-f.]+p[-+]\d+f", _body(fn)))
    assert floats("ff2 exp_poly_fma(ff2 r) {") == floats(
        "ff2 exp_poly(ff2 r) {")
    assert len(floats("ff2 exp_poly(ff2 r) {")) == 17
    assert "*ok = ar <= 0.5f && (ar >= 0x1p-48f || ar == 0.0f);" \
        in _body("ff2 exp22_fma(")
    assert "at >= 0x1p-100f && at < 0x1p+100f && u != 0.0f" \
        in _body("ff2 silu22_fma(")
    assert (R_TOP, R_LEAST, T_LEAST, T_TOP) == (
        0.5, float.fromhex("0x1p-48"), float.fromhex("0x1p-100"),
        float.fromhex("0x1p+100"))
    cu = (Path(core_ff.__file__).resolve().parents[1] / "csrc"
          / "ff_math.cu").read_text()
    assert "OP == SIGMOID || OP == SILU || OP == LOG1P || OP == POW;" in cu
    assert "return sigmoid22_fma(h, l);" in cu
    assert "return silu22_fma(h, l);" in cu


@pytest.mark.parametrize("name", sorted(mv.VARIANTS))
def test_math_variants_edit_the_sources_once(name):
    """Each math_variants variant is text edits of csrc/: every edited text
    occurs once in its file (else the variant cannot build)."""
    csrc = Path(core_ff.__file__).resolve().parents[1] / "csrc"
    for fname, old, new in mv.VARIANTS[name]:
        assert (csrc / fname).read_text().count(old) == 1, (fname, old)
        assert old != new


# ---------------------------------------------------------------------------
# expm1: expm122 on exp_poly_fma, exp22_fma's test, expm122 elsewhere

EXPM1_EDGES = mv.exp_log_edges("cpu")["expm1"]
# the classes whose elements the test sends to expm122, in part
EXPM1_FAR = {"r cancelling near k ln2", "lo beyond hi", "subnormal limbs",
             "non-finite"}


def expm1_body(xh, xl, seen=None):
    """expm122 on exp_poly_fma; (hi, lo, ok), ok the kernel's test as
    math_variants.dekker_elements emulates it (chip_smoke holds that to
    the card's)."""
    xc = torch.where(xh != xh, ffmath._EXP_CLIP_LO, xh)   # fminf / fmaxf
    rh, rl, k = ffmath._exp_reduce(xc, xl)
    s = exp_poly_fma(rh, rl, seen)
    p = core_ff.add212(s, 1.0)
    eh, el = ffmath._scale2k(p.hi, p.lo, k)
    g = core_ff.add212(FF(eh, el), -1.0)
    ovf = eh == math.inf
    small = k == 0
    oh = torch.where(small, s.hi, torch.where(ovf, eh, g.hi))
    ol = torch.where(small, s.lo, torch.where(ovf, 0.0, g.lo))
    idt = xh.abs() < ffmath._IDENTITY
    oh, ol = torch.where(idt, xh, oh), torch.where(idt, xl, ol)
    big, tiny = xh > ffmath._EXP_CLIP_HI, xh < ffmath._EXP_CLIP_LO
    oh = torch.where(big, math.inf, torch.where(tiny, -1.0, oh))
    ol = torch.where(big | tiny, 0.0, ol)
    nan = xh != xh
    return (torch.where(nan, xh, oh), torch.where(nan, xh, ol),
            ~mv.dekker_elements("expm1", xh, xl))


BODY["expm1"] = expm1_body


def _expm1_timed():
    """The operators phase's |N(0,1)| + 0.5, expm1's k == 0 band (-0.34,
    0.34) and (-1, 1), lo ~ hi 1e-8."""
    g = torch.Generator().manual_seed(17)
    h = {"|N(0,1)| + 0.5": torch.randn(20000, generator=g).abs() + 0.5,
         "k == 0 (-0.34, 0.34)": torch.rand(20000, generator=g) * 0.68 - 0.34,
         "uniform (-1, 1)": torch.rand(20000, generator=g) * 2 - 1}
    return {k: (v, v * 1e-8 * torch.randn(v.shape, generator=g))
            for k, v in h.items()}


EXPM1_TIMED = _expm1_timed()


@pytest.mark.parametrize("kind", list(EXPM1_EDGES) + list(EXPM1_TIMED))
def test_expm1_fma_path_is_the_plain_function(kind):
    """Bit for bit expm122, signed zeros included, on each edge class; the
    classes meant to reach expm122 do, and only those."""
    xh, xl = {**EXPM1_EDGES, **EXPM1_TIMED}[kind]
    gh, gl, ok = device("expm1", xh, xl)
    ph, pl = ffmath.expm122(xh, xl)
    assert not (differs(gh, ph) | differs(gl, pl)).any()
    rh = ffmath._exp_reduce(torch.where(xh != xh, ffmath._EXP_CLIP_LO, xh),
                            xl)[0]
    assert torch.equal(ok, in_domain(rh))          # exp22_fma's test
    assert bool(ok.any())
    assert bool((~ok).any()) == (kind in EXPM1_FAR)


def test_expm1_fma_path_is_the_reference():
    """On the timed inputs, whose limbs and results stay normal (XLA:CPU
    flushes subnormals, ROADMAP's FTZ policy)."""
    for xh, xl in EXPM1_TIMED.values():
        gh, gl, ok = device("expm1", xh, xl)
        rh, rl = ref_math.expm122(jnp.asarray(xh.numpy()),
                                  jnp.asarray(xl.numpy()))
        assert bool(ok.all())
        assert np.array_equal(np.asarray(rh).view(np.int32),
                              gh.numpy().view(np.int32))
        assert np.array_equal(np.asarray(rl).view(np.int32),
                              gl.numpy().view(np.int32))


def test_expm1_timed_inputs_take_the_fma_path():
    """Every element of the timed inputs (and of x uniform in (-30, 30))
    takes the FMA path: none runs expm122."""
    for xh, xl in list(EXPM1_TIMED.values()) + [_inputs("uniform (-30, 30)")]:
        assert bool(BODY["expm1"](xh, xl)[2].all())


def test_expm1_guard_on_r_below_2_48():
    """The reduced arguments that the test sends away on the class built
    for it (FF x within 2^-48 of k ln2, and for k == 0 a lo that nearly
    cancels hi): there exp_poly on the FMA, the k == 0 branch's output,
    differs from Dekker's, and only off the domain.  (expm1's outputs hide
    it: for k != 0 the +1 rounds it away, and on the k == 0 branch such an
    r has few bits.)"""
    xh, xl = EXPM1_EDGES["r cancelling near k ln2"]
    rh, rl, k = ffmath._exp_reduce(xh, xl)
    ok = in_domain(rh)
    assert bool((~ok).any()) and bool((~ok & (k == 0)).any())
    rng = np.random.default_rng(233)
    m = torch.from_numpy(rng.uniform(1, 2, rh.numel()).astype(np.float32))
    r = torch.where(ok, rh, rh * m)       # full significands at r's scale
    a, b = ffmath._exp_poly(r, rl), exp_poly_fma(r, rl)
    bad = differs(a.hi, b.hi) | differs(a.lo, b.lo)
    assert bool(bad[~ok].any()) and not (bad & in_domain(r)).any()


def test_expm1_guard_is_conservative():
    """expm1's outputs do not show its guard: on every edge class the bare
    FMA form is expm122 bit for bit, also on the elements the test sends
    away.  Those on the k == 0 branch (whose output is exp_poly itself)
    are an FF x whose lo cancels hi: r = xh + xl exactly (r.lo == 0), a
    multiple of 2^-69 below 2^-48, so r has at most 21 bits, W(r)'s hi is
    W_H[0] = 1/2 and every product of exp_poly is exact in Dekker's form
    too (ff_eft.cuh, above expm122_fma)."""
    assert ffmath._EXP_W_FF[0][0] == 0.5
    for xh, xl in EXPM1_EDGES.values():
        fh, fl, ok = expm1_body(xh, xl)
        ph, pl = ffmath.expm122(xh, xl)
        assert not (differs(fh, ph) | differs(fl, pl)).any()
        rh, rl, k = ffmath._exp_reduce(xh, xl)
        k0 = ~ok & (k == 0) & (xh.abs() >= ffmath._IDENTITY) & (rh != 0)
        k0 &= rh.abs() < R_LEAST
        assert bool((rl[k0] == 0).all())
        assert torch.equal(torch.remainder(rh[k0].double(), 2.0 ** -69),
                           torch.zeros_like(rh[k0].double()))
    xh, xl = EXPM1_EDGES["r cancelling near k ln2"]
    fh, fl, ok = expm1_body(xh, xl)
    rh, rl, k = ffmath._exp_reduce(xh, xl)
    assert bool((~ok & (k == 0) & (rh.abs() < R_LEAST)).any())


def test_expm1_zero_errors_of_either_sign_leave_no_trace():
    """On exact products (x = m 2^e) the FMA path meets errors that
    Dekker's TwoProd gives as -0 (its own +0), on the k == 0 branch too,
    whose output is exp_poly itself: exp_poly_fma is exp_poly bit for bit
    there, signed zeros included (r.hi never -0, w.hi > 0, z.lo never -0,
    so z w's cross products never sum to -0)."""
    xh, xl = EXPM1_EDGES["exact products"]
    seen = []
    fh, fl, ok = expm1_body(xh, xl, seen)
    k = ffmath._exp_reduce(xh, xl)[2]
    neg = torch.zeros_like(xh, dtype=torch.bool)
    for a, b in seen:
        y = T.two_prod(a, b)[1]
        neg |= (y == 0) & (y.view(torch.int32) < 0)
    idt = xh.abs() < ffmath._IDENTITY
    for branch in (k == 0, k != 0):
        assert bool((neg & ok & branch & ~idt).any())
    ph, pl = ffmath.expm122(xh, xl)
    assert not ((differs(fh, ph) | differs(fl, pl)) & ok).any()
    for cls in EXPM1_EDGES.values():
        rh, rl, _k = ffmath._exp_reduce(*cls)
        a, b = ffmath._exp_poly(rh, rl), exp_poly_fma(rh, rl)
        bad = differs(a.hi, b.hi) | differs(a.lo, b.lo)
        assert not (bad & in_domain(rh)).any()


def test_expm1_device_body_is_expm122s():
    """expm122_fma runs expm122's ops and selections (its kNonZeroK = false
    form) on exp_poly_fma, with exp22_fma's test; EXPM1 calls the path and
    takes the flat loop."""
    def statements(fn):
        text = re.sub(r"//[^\n]*", "", _body(fn).split("{", 1)[1])
        return [re.sub(r"\s+", "", t) for t in text.split(";") if t.strip()]
    plain = [t.replace("exp_poly(r)", "exp_poly_fma(r)")
             .replace("(!kNonZeroK&&k==0)?s", "k==0?s")
             for t in statements("ff2 expm122(float xh")]
    fma = iter(statements("ff2 expm122_fma("))
    assert all(t in fma for t in plain)       # in order, with the test
    assert ("*ok = ar <= 0.5f && (ar >= 0x1p-48f || ar == 0.0f);   "
            "// exp22_fma's") in _body("ff2 expm122_fma(")
    assert "if (!ok) r = expm122_far(xh, xl);" in _body(
        "ff2 expm122_fmapath(")
    cu = (Path(core_ff.__file__).resolve().parents[1] / "csrc"
          / "ff_math.cu").read_text()
    assert "return expm122_fmapath(h, l);" in cu
    assert ("constexpr bool kFlat = OP == EXP || OP == EXPM1 || OP == LOG "
            "||\n    OP == SIGMOID || OP == SILU || OP == LOG1P || OP == POW;"
            in cu)


# ---------------------------------------------------------------------------
# exp: exp22_fma where its test on r passes, exp22 elsewhere

EXP_EDGES = mv.exp_log_edges("cpu")["exp"]
# the classes whose elements the test sends to exp22, in part
EXP_FAR = {"+-0, |x| around 2^-48", "r cancelling near k ln2",
           "lo beyond hi", "subnormal limbs", "non-finite"}


def exp_body(xh, xl, seen=None):
    """exp22 on exp_poly_fma; (hi, lo, ok), ok the kernel's test as
    math_variants.dekker_elements emulates it (chip_smoke holds that to
    the card's)."""
    eh, el, _ok = exp22_fma(xh, xl, seen)
    return eh, el, ~mv.dekker_elements("exp", xh, xl)


BODY["exp"] = exp_body


def _exp_timed():
    """The operators phase's |N(0,1)| + 0.5 and x uniform in (-20, 20),
    lo ~ hi 1e-8."""
    g = torch.Generator().manual_seed(19)
    h = {"|N(0,1)| + 0.5": torch.randn(20000, generator=g).abs() + 0.5,
         "uniform (-20, 20)": torch.rand(20000, generator=g) * 40 - 20}
    return {k: (v, v * 1e-8 * torch.randn(v.shape, generator=g))
            for k, v in h.items()}


EXP_TIMED = _exp_timed()


@pytest.mark.parametrize("kind", list(EXP_EDGES) + list(EXP_TIMED))
def test_exp_fma_path_is_the_plain_function(kind):
    """Bit for bit exp22, signed zeros included, on each edge class; the
    classes meant to reach exp22 do, and only those."""
    xh, xl = {**EXP_EDGES, **EXP_TIMED}[kind]
    gh, gl, ok = device("exp", xh, xl)
    ph, pl = ffmath.exp22(xh, xl)
    assert not (differs(gh, ph) | differs(gl, pl)).any()
    rh = ffmath._exp_reduce(torch.where(xh != xh, ffmath._EXP_CLIP_LO, xh),
                            xl)[0]
    assert torch.equal(ok, in_domain(rh))          # exp22_fma's test
    assert bool(ok.any())
    assert bool((~ok).any()) == (kind in EXP_FAR)


def test_exp_fma_path_is_the_reference():
    """On the timed inputs, whose limbs and results stay normal (XLA:CPU
    flushes subnormals, ROADMAP's FTZ policy)."""
    for xh, xl in EXP_TIMED.values():
        gh, gl, ok = device("exp", xh, xl)
        rh, rl = ref_math.UNARY22["exp"](jnp.asarray(xh.numpy()),
                                         jnp.asarray(xl.numpy()))
        assert bool(ok.all())
        assert np.array_equal(np.asarray(rh).view(np.int32),
                              gh.numpy().view(np.int32))
        assert np.array_equal(np.asarray(rl).view(np.int32),
                              gl.numpy().view(np.int32))


def test_exp_timed_inputs_take_the_fma_path():
    """Every element of the timed inputs (and of x uniform in (-30, 30))
    takes the FMA path: none runs exp22."""
    for xh, xl in list(EXP_TIMED.values()) + [_inputs("uniform (-30, 30)")]:
        assert bool(BODY["exp"](xh, xl)[2].all())


def test_exp_test_is_expm1s_on_every_class():
    """exp and expm1 share exp22_fma's test, and dekker_elements shares its
    code: the two masks agree on every input of either's classes."""
    for cls in list(EXP_EDGES.values()) + list(EXPM1_EDGES.values()):
        assert torch.equal(mv.dekker_elements("exp", *cls),
                           mv.dekker_elements("expm1", *cls))


def test_exp_zero_errors_of_either_sign_leave_no_trace():
    """On exact products (x = m 2^e, and k ln2 + m 2^e) the FMA path meets
    errors that Dekker's TwoProd gives as -0 (its own +0), for x of either
    sign; the outputs are exp22's all the same (exp_poly_fma is exp_poly bit
    for bit on the domain)."""
    xh, xl = EXP_EDGES["exact products"]
    seen = []
    fh, fl, ok = exp_body(xh, xl, seen)
    neg = torch.zeros_like(xh, dtype=torch.bool)
    for a, b in seen:
        y = T.two_prod(a, b)[1]
        neg |= (y == 0) & (y.view(torch.int32) < 0)
    for side in (xh > 0, xh < 0):
        assert bool((neg & ok & side).any())
    ph, pl = ffmath.exp22(xh, xl)
    assert not ((differs(fh, ph) | differs(fl, pl)) & ok).any()


def test_exp_guard_is_conservative():
    """exp's outputs do not show its guard: on every edge class the bare FMA
    form is exp22 bit for bit, also on the elements the test sends away
    (a reduced argument below 2^-48 leaves Dekker's partial products'
    underflow far under lo's last bit, beneath the +1; lo limbs beyond hi
    overflow both forms alike)."""
    away = 0
    for xh, xl in EXP_EDGES.values():
        fh, fl, ok = exp_body(xh, xl)
        ph, pl = ffmath.exp22(xh, xl)
        assert not (differs(fh, ph) | differs(fl, pl)).any()
        away += int((~ok).sum())
    assert away > 0


def test_exp_device_body_is_exp22s():
    """exp22_fma runs exp22's ops and selections on exp_poly_fma, with the
    test on r; exp22_fmapath takes it where the test passes and exp22 (out
    of line) elsewhere; EXP calls the path and takes the flat loop."""
    def statements(fn):
        text = re.sub(r"//[^\n]*", "", _body(fn).split("{", 1)[1])
        return [re.sub(r"\s+", "", t) for t in text.split(";") if t.strip()]
    plain = [t.replace("exp_poly(r)", "exp_poly_fma(r)")
             for t in statements("ff2 exp22(float xh")]
    fma = statements("ff2 exp22_fma(")
    assert [t for t in fma if not t.startswith(("constfloatar", "*ok"))] \
        == plain
    assert "*ok = ar <= 0.5f && (ar >= 0x1p-48f || ar == 0.0f);" \
        in _body("ff2 exp22_fma(")
    path = _body("ff2 exp22_fmapath(")
    assert "ff2 r = exp22_fma(xh, xl, &ok);" in path
    assert "if (!ok) r = exp22_far(xh, xl);" in path
    assert "return exp22(xh, xl);" in _body("ff2 exp22_far(")
    assert "__device__ __noinline__ ff2 exp22_far(" in SRC
    cu = (Path(core_ff.__file__).resolve().parents[1] / "csrc"
          / "ff_math.cu").read_text()
    assert "if constexpr (OP == EXP) return exp22_fmapath(h, l);" in cu
    assert "constexpr bool kFlat = OP == EXP ||" in cu

