"""The port's FF gradients against ``jax.grad`` of the reference ops.

Each case feeds the same inputs (a local numpy seed) to both packages,
takes the loss ``sum(r.hi * w_hi + r.lo * w_lo)`` of the op's FF result
``r`` (so the cotangent carries both limbs), and compares the gradient
limbs of every operand: both limbs of an FF operand, the one plane of an
f32 operand.  The tolerance stands beside each case:

  * bitwise where both packages run the same IEEE ops in the same order:
    the closed forms of div, sqrt, the EFTs, mean, dot, norm_stats and the
    ten ``ff.math`` functions (Mul22, Div22, Add212 and exp22 / sigmoid22
    / erf22 / log22), on inputs whose limbs and results stay normal (the
    FTZ policy of ``repro.verify.sweeps``: XLA's jit flushes subnormals,
    torch keeps them);
  * within a stated ulp bound where the two frameworks add in other
    orders (a broadcast operand's cotangent summed over the broadcast
    axes; softmax's ``sum(g y)``) or run other f32 builtins (the ``jnp``
    softmax's ``exp``);
  * attention's gradient is the fast f32 recurrence's in both, which add
    in other orders: within 1e-5 of the largest element.

The reference runs with explicit non-f64 impls (its f64 tiers raise on the
installed JAX); the port's ``attention`` ``f64`` tier is held to a numpy
float64 oracle instead, within 2^-40.  The EFT remainder (``mul12``,
``normalize``, ``split_safe``, ``two_prod_safe``) and the compensated
reductions (``ff_dot``, ``ff_mean``, ``ff_logsumexp``, ``kahan_update``)
are held to the reference's bits on the adversarial limb classes of
``tests/test_property_ff.py`` and on spread inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ff as ref_ff
import repro_torch.ff as port_ff
from repro.core import compensated as ref_comp
from repro.core import ff as ref_core
from repro.core import transforms as ref_T
from repro.core.ff import FF as RFF
from repro_torch.core import compensated as port_comp
from repro_torch.core import ff as port_core
from repro_torch.core import transforms as port_T
from repro_torch.core.ff import FF as PFF
from repro_torch.ff import autodiff, dispatch
from repro_torch.kernels import ff_attention, ff_math


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32, copy=True))


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


def _same(a, b) -> bool:
    """The same bits and shape; a NaN matches any NaN."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    if a.shape != b.shape or not np.array_equal(np.isnan(a), np.isnan(b)):
        return False
    ok = ~np.isnan(a)
    return np.array_equal(_bits(a[ok]), _bits(b[ok]))


def _same_ftz(ref, port) -> bool:
    """``_same`` under the FTZ policy of ``repro.verify.sweeps``: where
    the reference (XLA:CPU flushes subnormal results) gives a zero, the
    port may give the subnormal IEEE gives, of the same sign."""
    r, p = np.asarray(ref, np.float32), np.array(port, np.float32)
    flushed = (r == 0) & (np.abs(p) < np.float32(2.0 ** -126))
    p[flushed] = r[flushed]
    return _same(r, p)


def _ff_pair(rng, x):
    """An FF operand of value ~x: hi = x, a normal lo below ulp(hi)/2."""
    x = np.asarray(x, np.float32)
    lo = (x * np.float32(2.0 ** -25) * rng.uniform(-1, 1, x.shape)
          ).astype(np.float32)
    return x, lo


def _ref_arg(a):
    return RFF(jnp.asarray(a[0]), jnp.asarray(a[1])) if isinstance(a, tuple) \
        else jnp.asarray(a)


def _ref_grads(op, args, w):
    """The gradient planes of jax.grad of sum(r.hi w0 + r.lo w1)."""
    def loss(*xs):
        r = op(*xs)
        return jnp.sum(r.hi * w[0] + r.lo * w[1])
    gs = jax.grad(loss, argnums=tuple(range(len(args))))(
        *(_ref_arg(a) for a in args))
    out = []
    for g in gs:
        out += [np.asarray(g.hi), np.asarray(g.lo)] if isinstance(g, RFF) \
            else [np.asarray(g)]
    return out


def _port_grads(op, args, w):
    leaves, xs = [], []
    for a in args:
        if isinstance(a, tuple):
            ls = [_t(p).requires_grad_() for p in a]
            xs.append(PFF(*ls))
        else:
            ls = [_t(a).requires_grad_()]
            xs.append(ls[0])
        leaves += ls
    r = op(*xs)
    (r.hi * _t(w[0]) + r.lo * _t(w[1])).sum().backward()
    return [t.grad.numpy() for t in leaves]


def _weights(rng, shape):
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]


# ---------------------------------------------------------------------------
# div, sqrt, two_sum, two_prod
# ---------------------------------------------------------------------------

def _operands(rng, shape, kinds, positive=False):
    out = []
    for k, shp in zip(kinds, shape):
        x = rng.standard_normal(shp).astype(np.float32)
        if positive:
            x = np.abs(x) + np.float32(0.25)
        else:
            x = np.where(np.abs(x) < 0.25, np.float32(0.5), x
                         ).astype(np.float32)
        out.append(_ff_pair(rng, x) if k == "ff" else x)
    return out


BINARY_FORMS = {
    # operand kinds and shapes: full, and one operand broadcast over 5 rows
    "ff-ff": (("ff", "ff"), ((5, 7), (5, 7))),
    "ff-f32": (("ff", "f32"), ((5, 7), (5, 7))),
    "f32-ff": (("f32", "ff"), ((5, 7), (5, 7))),
    "f32-f32": (("f32", "f32"), ((5, 7), (5, 7))),
    "ff-ff-row": (("ff", "ff"), ((5, 7), (1, 7))),
    "f32-ff-col": (("f32", "ff"), ((5, 1), (5, 7))),
}


def _summed_ok(want, got, args, w):
    """Bitwise for an operand at the full shape; a broadcast operand's
    gradient is a sum over 5 rows, which XLA and PyTorch may add in other
    orders: within 4 ulps of the sum of the terms' magnitudes."""
    i = 0
    for a in args:
        planes = a if isinstance(a, tuple) else (a,)
        for p in planes:
            if p.shape == w[0].shape:
                assert _same(want[i], got[i]), i
            else:
                scale = np.abs(want[i]) + np.abs(got[i])
                assert np.all(np.abs(want[i] - got[i])
                              <= 4 * 2.0 ** -24 * scale + 1e-38), i
            i += 1


@pytest.mark.parametrize("form", sorted(BINARY_FORMS))
@pytest.mark.parametrize("impl", ["jnp", "pallas"])
def test_div_grad_matches_reference(form, impl):
    """Div22 by the divisor (an f32 divisor lifted to FF) and -(q * out):
    bitwise at the full shape; broadcast operands per ``_summed_ok``.  The
    port's kernel tier (its plain version here) gives the same bits."""
    rng = np.random.default_rng(201)
    kinds, shapes = BINARY_FORMS[form]
    args = _operands(rng, shapes, kinds)
    w = _weights(rng, (5, 7))
    want = _ref_grads(lambda a, b: ref_ff.div(a, b, impl="jnp"), args, w)
    got = _port_grads(lambda a, b: port_ff.div(a, b, impl=impl), args, w)
    _summed_ok(want, got, args, w)


@pytest.mark.parametrize("kind", ["ff", "f32"])
@pytest.mark.parametrize("impl", ["jnp", "pallas"])
def test_sqrt_grad_matches_reference(kind, impl):
    """gv / Mul212(out, 2), Div22: bitwise."""
    rng = np.random.default_rng(202)
    (a,) = _operands(rng, ((6, 9),), (kind,), positive=True)
    w = _weights(rng, (6, 9))
    want = _ref_grads(lambda x: ref_ff.sqrt(x, impl="jnp"), [a], w)
    got = _port_grads(lambda x: port_ff.sqrt(x, impl=impl), [a], w)
    for x, y in zip(want, got):
        assert _same(x, y)


@pytest.mark.parametrize("op", ["two_sum", "two_prod"])
@pytest.mark.parametrize("shapes", [((4, 9), (4, 9)), ((4, 9), (1, 9)),
                                    ((4, 1), (4, 9))])
@pytest.mark.parametrize("impl", ["jnp", "pallas"])
def test_eft_grads_match_reference(op, shapes, impl):
    """two_sum: the cotangent's hi limb to both operands; two_prod:
    Mul212(gv, b).hi and Mul212(gv, a).hi.  Bitwise at the full shape.
    The reference's EFT primitives take operands of one shape, so it is
    called on operands broadcast before the call (jax.grad sums over the
    broadcast, as autograd does in the port): per ``_summed_ok``."""
    rng = np.random.default_rng(203)
    args = [(rng.standard_normal(s) * 10.0 ** rng.uniform(-2, 2, s)
             ).astype(np.float32) for s in shapes]
    full = np.broadcast_shapes(*shapes)
    w = _weights(rng, full)
    want = _ref_grads(lambda a, b: getattr(ref_ff, op)(
        jnp.broadcast_to(a, full), jnp.broadcast_to(b, full), impl="jnp"),
        args, w)
    got = _port_grads(lambda a, b: getattr(port_ff, op)(a, b, impl=impl),
                      args, w)
    _summed_ok(want, got, args, w)


# ---------------------------------------------------------------------------
# softmax, norm_stats, mean, dot
# ---------------------------------------------------------------------------

def _row_grads(ref_call, port_call, x, w):
    want = np.asarray(jax.grad(lambda a: jnp.sum(ref_call(a) * w))(
        jnp.asarray(x)))
    t = _t(x).requires_grad_()
    (port_call(t) * _t(w)).sum().backward()
    return want, t.grad.numpy()


@pytest.mark.parametrize("impl", ["jnp", "ff", "pallas"])
def test_softmax_grad_matches_reference(impl):
    """``(g - sum(g y)) y``.  With the accurate impl ``ff`` (FF
    exponentials, the same bits in both) the gradients differ only by the
    order of ``sum(g y)``'s f32 adds: within 4 ulps of max |g| |y| per
    row.  ``jnp`` (and ``pallas``, whose plain version runs here) run the
    f32 builtin ``exp``, XLA's and PyTorch's ulps apart: within 8 ulps of
    that scale."""
    rng = np.random.default_rng(204)
    x = (rng.standard_normal((6, 300)) * 3).astype(np.float32)
    w = rng.standard_normal((6, 300)).astype(np.float32)
    ref_impl = "ff" if impl == "ff" else "jnp"
    want, got = _row_grads(
        lambda a: ref_ff.softmax(a, impl=ref_impl),
        lambda a: port_ff.softmax(a, impl=impl), x, w)
    y = np.asarray(ref_ff.softmax(jnp.asarray(x), impl=ref_impl))
    scale = (np.abs(w) * y).max(-1, keepdims=True) + \
        np.abs(w).max(-1, keepdims=True) * y
    ulps = 4 if impl == "ff" else 8
    assert np.all(np.abs(want - got) <= ulps * 2.0 ** -24 * scale)


def test_softmax_grad_on_other_axis():
    """The axis is the call's, here 0 of a (40, 3) input (accurate impl;
    the bound of ``test_softmax_grad_matches_reference``)."""
    rng = np.random.default_rng(205)
    x = (rng.standard_normal((40, 3)) * 2).astype(np.float32)
    w = rng.standard_normal((40, 3)).astype(np.float32)
    want, got = _row_grads(lambda a: ref_ff.softmax(a, axis=0, impl="ff"),
                           lambda a: port_ff.softmax(a, axis=0, impl="ff"),
                           x, w)
    assert np.abs(want - got).max() <= 4 * 2.0 ** -24 * np.abs(want).max()


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
def test_norm_stats_grad_matches_reference(impl):
    """``g_mu / n + g_var 2 (x - mu) / n`` with IEEE divisions: bitwise
    (the forward statistics are the reference's bits on both tiers)."""
    rng = np.random.default_rng(206)
    x = (rng.standard_normal((5, 200)) * 2 + 1).astype(np.float32)
    wm, wv = (rng.standard_normal(5).astype(np.float32) for _ in range(2))

    def ref_loss(a):
        mu, var = ref_ff.norm_stats(a, impl="jnp")
        return jnp.sum(mu * wm + var * wv)
    want = np.asarray(jax.grad(ref_loss)(jnp.asarray(x)))
    t = _t(x).requires_grad_()
    mu, var = port_ff.norm_stats(t, impl=impl)
    (mu * _t(wm) + var * _t(wv)).sum().backward()
    assert _same(want, t.grad.numpy())
    # one statistic alone: the other's cotangent is 0
    want = np.asarray(jax.grad(lambda a: jnp.sum(
        ref_ff.norm_stats(a, impl="jnp")[1] * wv))(jnp.asarray(x)))
    t = _t(x).requires_grad_()
    (port_ff.norm_stats(t, impl=impl)[1] * _t(wv)).sum().backward()
    assert _same(want, t.grad.numpy())


@pytest.mark.parametrize("axis", [None, -1, 0, (0, 2)])
def test_mean_matches_reference(axis):
    """Forward and gradient bitwise: the blocked sum over n (Div22), and
    the cotangent over n, an IEEE division, broadcast."""
    rng = np.random.default_rng(207)
    x = (rng.standard_normal((3, 4, 150))
         * 10.0 ** rng.uniform(-2, 2, (3, 4, 150))).astype(np.float32)
    r = ref_ff.mean(jnp.asarray(x), axis=axis)
    p = port_ff.mean(_t(x), axis=axis)
    assert _same(r.hi, p.hi) and _same(r.lo, p.lo)
    w = _weights(rng, np.shape(r.hi))
    want = _ref_grads(lambda a: ref_ff.mean(a, axis=axis), [x], w)
    got = _port_grads(lambda a: port_ff.mean(a, axis=axis), [x], w)
    assert _same(want[0], got[0])


@pytest.mark.parametrize("axis", [None, -1, 0])
def test_dot_matches_reference(axis):
    """Forward bitwise (TwoProd products, the Dot3 cascade in index order)
    and gradient bitwise (the cotangent's hi limb times the other
    operand)."""
    rng = np.random.default_rng(208)
    a = (rng.standard_normal((6, 70)) * 10.0 ** rng.uniform(-3, 3, (6, 70))
         ).astype(np.float32)
    b = (rng.standard_normal((6, 70)) * 10.0 ** rng.uniform(-3, 3, (6, 70))
         ).astype(np.float32)
    r = ref_ff.dot(jnp.asarray(a), jnp.asarray(b), axis=axis)
    p = port_ff.dot(_t(a), _t(b), axis=axis)
    assert _same(r.hi, p.hi) and _same(r.lo, p.lo)
    w = _weights(rng, np.shape(r.hi))
    want = _ref_grads(lambda x, y: ref_ff.dot(x, y, axis=axis), [a, b], w)
    got = _port_grads(lambda x, y: port_ff.dot(x, y, axis=axis), [a, b], w)
    for x, y in zip(want, got):
        assert _same(x, y)


# ---------------------------------------------------------------------------
# the ten ff.math functions
# ---------------------------------------------------------------------------

def _math_inputs(op, rng, n=96):
    """Each function's branches, with limbs and results normal."""
    u = lambda lo, hi: rng.uniform(lo, hi, n)  # noqa: E731
    x = {
        "exp": np.concatenate([u(-0.3, 0.3), u(-20, 20)]),
        "expm1": np.concatenate([u(-0.34, 0.34), u(-1, 1), u(-15, 15)]),
        "log": np.concatenate([np.exp(u(-20, 20)), u(0.7, 1.4)]),
        "log1p": np.concatenate([u(-0.29, 0.41), u(0.5, 100),
                                 u(-0.9, -0.3)]),
        "tanh": np.concatenate([u(-0.35, 0.35), u(-6, 6)]),
        "sigmoid": np.concatenate([u(-1, 1), u(-20, 20)]),
        "erf": np.concatenate([u(-1, 1), u(1, 4), -u(1, 4), u(4, 7.5)]),
        "gelu": np.concatenate([u(-1.4, 1.4), u(1.4, 5.6), u(-5, -1.4),
                                u(5.6, 10.5)]),
        "silu": np.concatenate([u(-1, 1), u(-20, 20)]),
    }[op]
    return x.astype(np.float32).reshape(-1, 32)


MATH_UNARY = ("exp", "expm1", "log", "log1p", "tanh", "sigmoid", "erf",
              "gelu", "silu")


@pytest.mark.parametrize("op", MATH_UNARY)
@pytest.mark.parametrize("kind", ["ff", "f32"])
@pytest.mark.parametrize("impl", ["jnp", "pallas"])
def test_math_grad_matches_reference(op, kind, impl):
    """The reference's FF derivative rule (``_MATH_BWD``), bitwise on each
    function's branches, for FF and f32 operands; on the kernel tier the
    backward's exp22 / sigmoid22 / erf22 run through ``math_elementwise``
    (its plain version here), the same bits."""
    rng = np.random.default_rng(209 + MATH_UNARY.index(op))
    x = _math_inputs(op, rng)
    a = _ff_pair(rng, x) if kind == "ff" else x
    w = _weights(rng, x.shape)
    want = _ref_grads(lambda t: getattr(ref_ff, op)(t, impl="jnp"), [a], w)
    got = _port_grads(lambda t: getattr(port_ff, op)(t, impl=impl), [a], w)
    for i, (p, q) in enumerate(zip(want, got)):
        assert _same(p, q), (op, i)


@pytest.mark.parametrize("kinds", [("ff", "ff"), ("f32", "f32"),
                                   ("ff", "f32")])
@pytest.mark.parametrize("impl", ["jnp", "pallas"])
def test_pow_grad_matches_reference(kinds, impl):
    """d/da = gv b (out / a), d/db = gv out log(a): bitwise on a in
    (0.1, 10) and b in (-3, 3), and with b broadcast along the rows
    (its gradient a sum over 4 rows: per ``_summed_ok``)."""
    rng = np.random.default_rng(219)
    a = rng.uniform(0.1, 10, (4, 40)).astype(np.float32)
    b = rng.uniform(-3, 3, (4, 40)).astype(np.float32)
    a = _ff_pair(rng, a) if kinds[0] == "ff" else a
    bb = _ff_pair(rng, b) if kinds[1] == "ff" else b
    w = _weights(rng, (4, 40))
    for args in ([a, bb], [a, (bb[0][:1], bb[1][:1]) if isinstance(bb, tuple)
                           else bb[:1]]):
        want = _ref_grads(lambda x, y: ref_ff.pow(x, y, impl="jnp"), args, w)
        got = _port_grads(lambda x, y: port_ff.pow(x, y, impl=impl), args, w)
        _summed_ok(want, got, args, w)


def test_math_backward_takes_the_forward_tier(monkeypatch):
    """silu's backward on the kernel tier runs sigmoid22 through
    ``math_elementwise`` (counted by a wrapper here, as launches are on the
    card); on ``jnp`` it does not; both give the same gradient.  protect
    under guard "degrade" repairs a NaN result after the Function and
    keeps the graph."""
    calls = []
    real = ff_math.math_elementwise

    def spy(op, *a, **k):
        calls.append(op)
        return real(op, *a, **k)
    monkeypatch.setattr(ff_math, "math_elementwise", spy)
    x = torch.linspace(-4, 4, 24)
    grads = {}
    for impl in ("jnp", "pallas"):
        calls.clear()
        t = x.clone().requires_grad_()
        port_ff.silu(t, impl=impl).hi.sum().backward()
        grads[impl] = (t.grad, list(calls))
    assert grads["jnp"][1] == []
    assert grads["pallas"][1] == ["silu", "sigmoid"]
    assert torch.equal(grads["jnp"][0], grads["pallas"][0])
    t = torch.tensor([-1.0, 4.0, 9.0]).requires_grad_()
    with port_ff.guard(mode="degrade"):
        r = port_ff.log(t - 2.0)          # log(-3) is NaN: repaired
    assert torch.isfinite(r.hi).all() and r.hi.requires_grad
    r.hi.sum().backward()
    assert t.grad[1] == 0.5 and t.grad[2] == np.float32(1 / 7)


# ---------------------------------------------------------------------------
# attention: ragged kv_len, the f64 tier
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
def test_attention_kv_len_grad_matches_reference(causal):
    """The accurate tier's gradient with a per-row ``kv_len`` is the fast
    recurrence's at the same lengths, in both packages: within 1e-5 of the
    largest gradient element (the two recurrences add in other orders);
    keys past a row's length get no gradient."""
    rng = np.random.default_rng(220)
    B, S, H, KV, hd = 3, 24, 4, 2, 8
    q, k, v, r = (rng.standard_normal(s).astype(np.float32) for s in
                  ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd),
                   (B, S, H, hd)))
    kv_len = np.array([24, 9, 17], np.int32)
    kw = dict(causal=causal, block_q=8, block_kv=8, impl="ff")
    want = jax.grad(
        lambda a, b, c: jnp.sum(ref_ff.attention(
            a, b, c, kv_len=jnp.asarray(kv_len), **kw) * r),
        argnums=(0, 1, 2))(*(jnp.asarray(t) for t in (q, k, v)))
    ts = [_t(t).requires_grad_() for t in (q, k, v)]
    (port_ff.attention(*ts, kv_len=torch.from_numpy(kv_len), **kw)
     * _t(r)).sum().backward()
    for name, a, b in zip("qkv", want, ts):
        a = np.asarray(a)
        assert np.abs(a - b.grad.numpy()).max() <= 1e-5 * np.abs(a).max(), \
            name
    for row, n in enumerate(kv_len):
        assert not ts[1].grad[row, n:].any() and not ts[2].grad[row, n:].any()


def _attention_oracle(q, k, v, causal, q_offset, kv_len, scale):
    """Float64 softmax attention in numpy, GQA by repeating K/V heads."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    q, k, v = (t.astype(np.float64) for t in (q, k, v))
    k = np.repeat(k, H // KV, axis=2)
    v = np.repeat(v, H // KV, axis=2)
    s = np.einsum("bqhd,bshd->bhqs", q, k) * scale
    qp = q_offset + np.arange(Sq)[:, None]
    kp = np.arange(Skv)[None, :]
    ok = np.broadcast_to(kp <= qp if causal else np.ones((Sq, Skv), bool),
                         s.shape)
    if kv_len is not None:
        ok = ok & (kp < kv_len[:, None, None, None])
    s = np.where(ok, s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p = p / p.sum(-1, keepdims=True)
    return np.einsum("bhqs,bshd->bqhd", p, v)


F64_CASES = {
    "causal": dict(causal=True, q_offset=0, kv_len=None, shape=(2, 12, 12)),
    "decode": dict(causal=True, q_offset=9, kv_len=None, shape=(1, 3, 12)),
    "ragged": dict(causal=False, q_offset=0, kv_len=[12, 5],
                   shape=(2, 4, 12)),
    "wide": dict(causal=False, q_offset=0, kv_len=None, shape=(1, 5, 40),
                 spread=30.0),
}


@pytest.mark.parametrize("case", sorted(F64_CASES))
def test_attention_f64_tier_against_float64(case):
    """The port's f64 tier (the reference's raises on the installed JAX):
    its FF result within 2^-40 of the largest |output| of a numpy float64
    oracle per row, its f32 result the oracle's rounding within an ulp;
    f32 and bf16 operands."""
    c = F64_CASES[case]
    B, Sq, Skv = c["shape"]
    H, KV, hd = 4, 2, 16
    rng = np.random.default_rng(221)
    q = (rng.standard_normal((B, Sq, H, hd)) * c.get("spread", 1.0)
         ).astype(np.float32)
    k = rng.standard_normal((B, Skv, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, Skv, KV, hd)).astype(np.float32)
    kv = None if c["kv_len"] is None else np.array(c["kv_len"], np.int32)
    kw = dict(causal=c["causal"], q_offset=c["q_offset"],
              kv_len=None if kv is None else torch.from_numpy(kv))
    for dt in (torch.float32, torch.bfloat16):
        qt, kt, vt = (_t(x).to(dt) for x in (q, k, v))
        want = _attention_oracle(*(t.float().numpy() for t in (qt, kt, vt)),
                                 c["causal"], c["q_offset"], kv,
                                 np.float64(np.float32(1 / np.sqrt(hd))))
        got = port_ff.attention(qt, kt, vt, impl="f64", return_ff=True, **kw)
        err = np.abs(got.to_f64() - want).max(-1)
        assert np.all(err <= 2.0 ** -40 * np.abs(want).max(-1) + 1e-300)
        y = port_ff.attention(qt, kt, vt, impl="f64", **kw)
        assert y.dtype == dt
        if dt == torch.float32:
            assert np.all(np.abs(y.numpy() - want)
                          <= 2.0 ** -24 * np.abs(want) + 1e-45)


def test_attention_f64_size_guard_and_gradient(monkeypatch):
    """Past the size guard (B H Sq Skv > 2^24; lowered here) the f64 tier
    warns and returns the ``ff`` tier, as the reference; its gradient is
    the fast recurrence's, as every accurate tier's."""
    rng = np.random.default_rng(222)
    q = rng.standard_normal((1, 8, 2, 8)).astype(np.float32)
    k = rng.standard_normal((1, 8, 1, 8)).astype(np.float32)
    v = rng.standard_normal((1, 8, 1, 8)).astype(np.float32)
    assert dispatch.ATTENTION_F64_MAX_SCORES == 1 << 24
    monkeypatch.setattr(dispatch, "ATTENTION_F64_MAX_SCORES", 8 * 8 * 2 - 1)
    with pytest.warns(UserWarning, match="size guard"):
        got = port_ff.attention(_t(q), _t(k), _t(v), impl="f64",
                                return_ff=True)
    want = ff_attention.flash_attention_ff(_t(q), _t(k), _t(v),
                                           return_ff=True)
    assert torch.equal(got.hi, want.hi) and torch.equal(got.lo, want.lo)
    monkeypatch.undo()
    grads = []
    for impl in ("f64", "fast"):
        ts = [_t(x).requires_grad_() for x in (q, k, v)]
        port_ff.attention(*ts, impl=impl).sum().backward()
        grads.append([t.grad for t in ts])
    for a, b in zip(*grads):
        assert torch.allclose(a, b, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the EFT remainder and the compensated reductions: the reference's bits
# ---------------------------------------------------------------------------

def _ulp32(x: np.ndarray) -> np.ndarray:
    a = np.abs(x).astype(np.float32)
    return (np.nextafter(a, np.float32(np.inf)) - a).astype(np.float32)


def _adversarial(rng, n, big=False):
    """FF pairs on the limb classes of ``tests/test_property_ff.py``:
    lo = +-ulp(hi)/2 (the tie), a subnormal, +-0.49 ulp(hi), +-0; hi
    in (1e-20, 1e20), or (1e30, 3e38) with ``big``."""
    mag = 10.0 ** (rng.uniform(30, 38.4, n) if big else
                   rng.uniform(-20, 20, n))
    hi = (np.sign(rng.uniform(-1, 1, n)) * np.minimum(mag, 3e38)
          ).astype(np.float32)
    cls = rng.integers(0, 4, n)
    sign = np.sign(rng.uniform(-1, 1, n)).astype(np.float32)
    lo = np.select([cls == 0, cls == 1, cls == 2],
                   [sign * 0.5 * _ulp32(hi), sign * np.float32(2.0 ** -140),
                    sign * 0.49 * _ulp32(hi)], sign * np.float32(0.0))
    return hi, lo.astype(np.float32)


def test_mul12_and_normalize_bitwise_reference():
    """mul12 of the limbs, and normalize (Fast2Sum) of the pairs, bitwise
    on the adversarial classes, under the FTZ policy: the reference's
    XLA:CPU flushes the subnormal lo class to zero, torch keeps it."""
    rng = np.random.default_rng(223)
    hi, lo = _adversarial(rng, 4000)
    bh, _ = _adversarial(rng, 4000)
    r = ref_core.mul12(jnp.asarray(hi), jnp.asarray(bh))
    p = port_core.mul12(_t(hi), _t(bh))
    keep = np.abs(hi.astype(np.float64) * bh) < 1e38   # no overflow
    keep &= np.abs(hi.astype(np.float64) * bh) > 1e-25  # the Dekker domain
    for x, y in ((r.hi, p.hi), (r.lo, p.lo)):
        assert _same(np.asarray(x)[keep], y.numpy()[keep])
    for big in (False, True):
        hi, lo = _adversarial(rng, 4000, big=big)
        r = ref_core.normalize(RFF(jnp.asarray(hi), jnp.asarray(lo)))
        p = port_core.normalize(PFF(_t(hi), _t(lo)))
        assert _same(r.hi, p.hi) and _same_ftz(r.lo, p.lo)


def test_split_safe_and_two_prod_safe_bitwise_reference():
    """split_safe and two_prod_safe bitwise on the adversarial hi limbs,
    near overflow (|a| >= 2^115 takes the rescaled split) and in the safe
    interior, and two_prod_safe on big x small operands whose product is
    normal; split_safe reassembles a exactly."""
    rng = np.random.default_rng(224)
    for big in (False, True):
        a, _ = _adversarial(rng, 4000, big=big)
        rh, rl = ref_T.split_safe(jnp.asarray(a))
        ph, pl = port_T.split_safe(_t(a))
        assert _same(rh, ph) and _same(rl, pl)
        assert np.array_equal(ph.numpy() + pl.numpy(), a)
    a, _ = _adversarial(rng, 4000, big=True)
    b = (rng.standard_normal(4000) * 10.0 ** rng.uniform(-25, -5, 4000)
         ).astype(np.float32)
    for x, y in ((a, b), (b, a)):
        rx, ry = ref_T.two_prod_safe(jnp.asarray(x), jnp.asarray(y))
        px, py = port_T.two_prod_safe(_t(x), _t(y))
        assert _same(rx, px) and _same(ry, py)
    a, _ = _adversarial(rng, 4000)
    b, _ = _adversarial(rng, 4000)
    keep = np.abs(a.astype(np.float64) * b) > 1e-25
    rx, ry = ref_T.two_prod_safe(jnp.asarray(a), jnp.asarray(b))
    px, py = port_T.two_prod_safe(_t(a), _t(b))
    assert _same(np.asarray(rx)[keep], px.numpy()[keep])
    assert _same(np.asarray(ry)[keep], py.numpy()[keep])


def test_tree_helpers_match_reference():
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": {"c": np.float32([1.5, -2.0])}}
    rt = ref_core.tree_from_f32(jax.tree_util.tree_map(jnp.asarray, tree))
    pt = port_core.tree_from_f32({"a": _t(tree["a"]),
                                  "b": {"c": _t(tree["b"]["c"])}})
    for r, p in ((rt["a"], pt["a"]), (rt["b"]["c"], pt["b"]["c"])):
        assert isinstance(p, PFF)
        assert _same(r.hi, p.hi) and _same(r.lo, p.lo)
    back = port_core.tree_to_f32({**pt, "x": _t([3.0])})
    assert torch.equal(back["a"], _t(tree["a"])) and back["x"].item() == 3.0
    assert port_ff.tree_to_f32 is port_core.tree_to_f32


@pytest.mark.parametrize("axis", [None, 0, -1, (0, 1)])
def test_ff_dot_and_ff_mean_bitwise_reference(axis):
    rng = np.random.default_rng(225)
    a, b = ((rng.standard_normal((5, 6, 40))
             * 10.0 ** rng.uniform(-4, 4, (5, 6, 40))).astype(np.float32)
            for _ in range(2))
    for r, p in ((ref_comp.ff_dot(jnp.asarray(a), jnp.asarray(b), axis=axis),
                  port_comp.ff_dot(_t(a), _t(b), axis=axis)),
                 (ref_comp.ff_mean(jnp.asarray(a), axis=axis),
                  port_comp.ff_mean(_t(a), axis=axis))):
        assert _same(r.hi, p.hi) and _same(r.lo, p.lo)


def test_ff_logsumexp_and_kahan_update_match_reference():
    """ff_logsumexp: the max bitwise, the FF exp-sum within 2^-22 of the
    reference's (the f32 builtin exp of XLA and of PyTorch differ by an
    ulp or two) and bitwise the blocked sum of the port's own exp terms;
    kahan_update (Add212) bitwise over a stream of 500 updates."""
    rng = np.random.default_rng(226)
    x = (rng.standard_normal((4, 700)) * 5).astype(np.float32)
    rm, rs = ref_comp.ff_logsumexp(jnp.asarray(x), axis=-1)
    pm, ps = port_comp.ff_logsumexp(_t(x), axis=-1)
    assert _same(rm, pm)
    ref_s = np.asarray(rs.hi, np.float64) + np.asarray(rs.lo, np.float64)
    assert np.all(np.abs(ps.to_f64() - ref_s) <= 2.0 ** -22 * ref_s)
    e = torch.exp(_t(x) - pm[:, None])
    own = port_comp.ff_sum_blocked(e, axis=-1, block=256)
    assert torch.equal(own.hi, ps.hi) and torch.equal(own.lo, ps.lo)
    deltas = (rng.standard_normal(500) * 10.0 ** rng.uniform(-6, 6, 500)
              ).astype(np.float32)
    racc = RFF(jnp.float32(0.0), jnp.float32(0.0))
    pacc = PFF(torch.tensor(0.0), torch.tensor(0.0))
    for d in deltas:
        racc = ref_comp.kahan_update(racc, jnp.float32(d))
        pacc = port_comp.kahan_update(pacc, torch.tensor(d))
    assert _same(racc.hi, pacc.hi) and _same(racc.lo, pacc.lo)


def test_registry_has_the_reference_ops():
    """mean and dot are registered under the reference's names and
    defaults; attention has its f64 tier; every op of the reference's
    differentiable set runs through an autograd Function on a
    gradient-requiring operand."""
    for op in ("mean", "dot"):
        assert port_ff.impls(op) == ("jnp",)
        assert port_ff.resolve_name(op, device="cuda") == "jnp"
    assert "f64" in port_ff.impls("attention")
    assert port_ff.resolve_name("attention", "tuned_accurate",
                                device="cuda") == "f64"
    x = torch.rand(2, 4).add_(0.5).requires_grad_()
    for fn, name in ((lambda: port_ff.div(x, x), "DivBackward"),
                     (lambda: port_ff.sqrt(x), "SqrtBackward"),
                     (lambda: port_ff.two_sum(x, x), "TwoSumBackward"),
                     (lambda: port_ff.two_prod(x, x), "TwoProdBackward"),
                     (lambda: port_ff.mean(x), "MeanBackward"),
                     (lambda: port_ff.dot(x, x), "DotBackward"),
                     (lambda: port_ff.exp(x), "Math1Backward"),
                     (lambda: port_ff.pow(x, x), "PowBackward")):
        assert type(fn().hi.grad_fn).__name__ == name
    assert type(port_ff.softmax(x).grad_fn).__name__ == "SoftmaxBackward"
    assert type(port_ff.norm_stats(x)[0].grad_fn).__name__ == \
        "NormStatsBackward"
    with torch.no_grad():
        assert port_ff.div(x, x).hi.grad_fn is None
    assert autodiff.MATH_BWD.keys() == set(MATH_UNARY)
