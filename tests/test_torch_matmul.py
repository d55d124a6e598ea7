"""The port's FF matmul path (``repro_torch.ff.matmul``) against the
reference's, on the CPU.

  * Bitwise on normal-range inputs: ``ozaki_params``, ``extract_slices``,
    ``pairwise_sum_compensated``, ``ref_ff_matmul_dot2``, the Dot2 kernel's
    plain version against the reference's kernel in interpret mode, the
    Ozaki kernel's and the hybrid kernel's plain versions on small-integer
    operands (where every block product is exact, so only the fold order
    decides the bits).
  * Error contracts on random data, with the reference tests' bounds
    (S = |A| @ |B|): hybrid within 2^-44 S of the reference's same-order
    result and 2 K u S of float64; Ozaki within 2^-42 S of float64 and of
    the reference's counterpart; Dot2 within u |E| + 2 K^2 u^2 S of
    float64; ``f64`` within 2^-48 S of numpy float64 (the reference's f64
    tier raises on the installed JAX).
  * Dispatch, policy and scope resolution, FF operands and the gradient.

The CUDA kernels run only on the card: ``chip_smoke.py`` holds them to
these plain versions there.  Inputs come from local numpy generators.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ff as ref_ff
from repro.core import ffmatmul as ref_mm
from repro.core import transforms as ref_T
from repro.core.ff import FF as RefFF
from repro.kernels import ff_matmul as ref_kernels
from repro.kernels import ref as ref_oracles
import repro_torch.ff as port_ff
from repro_torch.core import ffmatmul as port_mm
from repro_torch.core import transforms as port_T
from repro_torch.core.ff import FF
from repro_torch.ff import dispatch
from repro_torch.kernels import ff_matmul as port_kernels
from repro_torch.kernels import ref as port_oracles

U = 2.0 ** -24
SHAPES = [(8, 16, 8), (100, 300, 50), (257, 513, 129), (1, 2048, 1),
          (64, 1100, 8), (17, 100, 5)]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32, copy=True))


def _f64(x) -> np.ndarray:
    return np.asarray(x).astype(np.float64)


def _same(ref, port) -> bool:
    """Equal values (so -0 == +0), NaN nowhere."""
    r, p = np.asarray(ref), port.numpy()
    return (r.shape == p.shape and np.array_equal(r, p)
            and not np.isnan(p).any())


def _random(mkn, seed):
    M, K, N = mkn
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((M, K)).astype(np.float32)
    B = rng.standard_normal((K, N)).astype(np.float32)
    return A, B, _f64(A) @ _f64(B), np.abs(_f64(A)) @ np.abs(_f64(B))


def _integers(mkn, seed):
    M, K, N = mkn
    rng = np.random.default_rng(seed)
    return (rng.integers(-8, 9, (M, K)).astype(np.float32),
            rng.integers(-8, 9, (K, N)).astype(np.float32))


def _pair64(hi, lo) -> np.ndarray:
    return _f64(hi) + _f64(lo)


# ---------------------------------------------------------------------------
# the Ozaki slicing machinery and the compensated tree: bitwise
# ---------------------------------------------------------------------------

def test_ozaki_params_bitwise_reference():
    for K in (1, 2, 16, 100, 128, 300, 512, 513, 1024, 1100, 2048, 4096,
              8192, 49155, 65536):
        assert port_mm.ozaki_params(K) == ref_mm.ozaki_params(K), K
        for kw in (dict(slices=5), dict(slices=6, block_k=256),
                   dict(beta=7), dict(block_k=512)):
            assert (port_mm.ozaki_params(K, **kw)
                    == ref_mm.ozaki_params(K, **kw)), (K, kw)
    with pytest.raises(ValueError, match="exactness budget"):
        port_mm.ozaki_params(4096, beta=12)


def _slice_operand(seed):
    """Rows with a spread of exponents, and rows whose max sits just above
    a power of two (the f32-log2 edge of the alignment exponent)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((16, 256))
         * np.exp2(rng.integers(-8, 9, (16, 256)))).astype(np.float32)
    for r, ebit in enumerate((1, 8, 32, -32, 100)):
        top = np.float32(np.exp2(ebit)) * (np.float32(1)
                                           + np.float32(2.0 ** -23))
        x[r] = top * np.float32(0.9)
        x[r, 0] = top
    return x


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("n,beta", [(3, 8), (4, 8), (5, 7)])
def test_extract_slices_bitwise_reference(axis, n, beta):
    x = _slice_operand(61)
    if axis == 0:
        x = np.ascontiguousarray(x.T)
    want, want_r = ref_mm.extract_slices(jnp.asarray(x), axis, n, beta)
    got, got_r = port_mm.extract_slices(_t(x), axis, n, beta)
    for w, g in zip(want, got):
        assert _same(w, g)
    assert _same(want_r, got_r)
    total = _f64(got_r)
    for g in got:
        total = total + _f64(g)
    assert np.array_equal(total, _f64(x))       # slices + residual == x


def test_extract_slices_zero_rows_give_zero_slices():
    """A zero row gives zero slices and a zero residual.  (The reference's
    f32 log2 of 0 is -inf, its int32 exponent wraps, and from the slice
    whose exponent offset is negative on it returns NaN there.)"""
    x = _slice_operand(62)
    x[3] = 0.0
    parts, r = port_mm.extract_slices(_t(x), 1, 4, 8)
    for p in parts + [r]:
        assert torch.isfinite(p).all() and not p[3].any()
    assert np.array_equal(_f64(sum(_f64(p) for p in parts) + _f64(r)),
                          _f64(x))


@pytest.mark.parametrize("shape,axis", [((5, 8, 7), 1), ((13, 9, 4), 0),
                                        ((3, 4, 32), 2), ((6, 1, 3), 1)])
def test_pairwise_sum_compensated_bitwise_reference(shape, axis):
    rng = np.random.default_rng(63)
    p = (rng.standard_normal(shape)
         * 10.0 ** rng.uniform(-6, 6, shape)).astype(np.float32)
    err = rng.standard_normal(np.delete(shape, axis)).astype(np.float32)
    for e in (None, err):
        want = ref_T.pairwise_sum_compensated(
            jnp.asarray(p), axis, None if e is None else jnp.asarray(e))
        got = port_T.pairwise_sum_compensated(
            _t(p), axis, None if e is None else _t(e))
        assert _same(want[0], got[0]) and _same(want[1], got[1])


# ---------------------------------------------------------------------------
# the three kernels' plain versions and the oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mkn", SHAPES)
def test_ref_ff_matmul_dot2_bitwise_reference(mkn):
    A, B, E, S = _random(mkn, 64)
    want = ref_oracles.ref_ff_matmul_dot2(jnp.asarray(A), jnp.asarray(B))
    got = port_oracles.ref_ff_matmul_dot2(_t(A), _t(B))
    assert _same(want[0], got[0]) and _same(want[1], got[1])


@pytest.mark.parametrize("mkn", SHAPES)
def test_dot2_kernel_plain_bitwise_reference(mkn):
    """The plain version against the reference's TPU kernel in interpret
    mode, bit for bit, and both within the Dot2 bound of float64."""
    A, B, E, S = _random(mkn, 65)
    want = ref_kernels.ff_matmul_dot2(jnp.asarray(A), jnp.asarray(B),
                                      interpret=True)
    got = port_kernels.ff_matmul_dot2(_t(A), _t(B))      # CPU: plain
    assert _same(want[0], got[0]) and _same(want[1], got[1])
    K = mkn[1]
    assert np.all(np.abs(_pair64(*got) - E)
                  <= U * np.abs(E) + 2 * K * K * U * U * S)


@pytest.mark.parametrize("mkn", SHAPES)
def test_ozaki_kernel_plain_bitwise_reference_on_integers(mkn):
    A, B = _integers(mkn, 66)
    want = ref_kernels.ff_matmul_ozaki(jnp.asarray(A), jnp.asarray(B),
                                       interpret=True)
    got = port_kernels.ff_matmul_ozaki(_t(A), _t(B))     # CPU: plain
    assert _same(want[0], got[0]) and _same(want[1], got[1])
    assert np.array_equal(_pair64(*got), _f64(A) @ _f64(B))


@pytest.mark.parametrize("mkn", SHAPES)
def test_hybrid_plain_bitwise_reference_on_integers(mkn):
    A, B = _integers(mkn, 67)
    for bk in (512, 64):
        want = ref_oracles.ref_ff_matmul(jnp.asarray(A), jnp.asarray(B),
                                         bk=bk)
        got = port_kernels.ff_matmul(_t(A), _t(B), bk=bk)   # CPU: plain
        assert _same(want[0], got[0]) and _same(want[1], got[1])


def test_hybrid_plain_carries_lo_on_integers():
    """Non-negative integers in [0, 127] over K = 8192: every 512-long block
    product is exact (below 2^24) but their sum is not, so the fold must
    carry it in lo.  Bit for bit the reference's oracle, and hi + lo
    exact."""
    rng = np.random.default_rng(79)
    A = rng.integers(0, 128, (8, 8192)).astype(np.float32)
    B = rng.integers(0, 128, (8192, 8)).astype(np.float32)
    want = ref_oracles.ref_ff_matmul(jnp.asarray(A), jnp.asarray(B))
    got = port_kernels.ff_matmul(_t(A), _t(B))             # CPU: plain
    assert _same(want[0], got[0]) and _same(want[1], got[1])
    assert got[1].count_nonzero() > 0
    assert np.array_equal(_pair64(*got), _f64(A) @ _f64(B))


@pytest.mark.parametrize("mkn", SHAPES)
def test_hybrid_error_contract(mkn):
    """The FF fold within 2^-44 S of the exact sum of the same f32 block
    products (the reference test's kernel-vs-oracle bound: there both sides
    share XLA's block products, while the port's come from another GEMM);
    within 2 bk u S of the reference's result (two f32 GEMM orders) and
    2 K u S of float64."""
    A, B, E, S = _random(mkn, 68)
    K = mkn[1]
    bk = min(512, K)
    got = _pair64(*port_kernels.ff_matmul(_t(A), _t(B)))
    blocks = sum(_f64(_t(A[:, k:k + bk]) @ _t(B[k:k + bk]))
                 for k in range(0, K, bk))
    want = _pair64(*ref_oracles.ref_ff_matmul(jnp.asarray(A),
                                              jnp.asarray(B)))
    assert np.all(np.abs(got - blocks) <= 2.0 ** -44 * S + 1e-30)
    assert np.all(np.abs(got - want) <= 2 * bk * U * S + 1e-30)
    assert np.all(np.abs(got - E) <= 2 * K * U * S + 1e-30)


@pytest.mark.parametrize("slices", [0, 5])
@pytest.mark.parametrize("mkn", SHAPES)
def test_ozaki_error_contract(mkn, slices):
    """The kernel's plain version and the torch ``matmul_ozaki`` within
    2^-42 S of float64 and of their reference counterparts (the interpret
    kernel, the jnp path)."""
    A, B, E, S = _random(mkn, 69)
    kern = _pair64(*port_kernels.ff_matmul_ozaki(_t(A), _t(B),
                                                 slices=slices))
    jnp_path = port_mm.matmul_ozaki(_t(A), _t(B), slices).to_f64()
    ref_kern = _pair64(*ref_kernels.ff_matmul_ozaki(
        jnp.asarray(A), jnp.asarray(B), slices=slices, interpret=True))
    ref_jnp = ref_mm.matmul_ozaki(jnp.asarray(A), jnp.asarray(B),
                                  slices).to_f64()
    tol = 2.0 ** -42 * S + 1e-30
    for got, want in ((kern, ref_kern), (jnp_path, ref_jnp)):
        assert np.all(np.abs(got - E) <= tol)
        assert np.all(np.abs(got - want) <= tol)


@pytest.mark.parametrize("mkn", SHAPES)
def test_dot2_torch_path_error_contract(mkn):
    """``matmul_dot2`` (the ``dot2`` impl on the CPU): within the Dot2
    bound of float64 and 2^-44 S of the reference's jnp path."""
    A, B, E, S = _random(mkn, 70)
    K = mkn[1]
    got = port_mm.matmul_dot2(_t(A), _t(B)).to_f64()
    want = ref_mm.matmul_dot2(jnp.asarray(A), jnp.asarray(B)).to_f64()
    assert np.all(np.abs(got - E) <= U * np.abs(E) + 2 * K * K * U * U * S)
    assert np.all(np.abs(got - want) <= 2.0 ** -44 * S + 1e-30)


@pytest.mark.parametrize("mkn", SHAPES)
def test_f64_tier_against_numpy(mkn):
    A, B, E, S = _random(mkn, 71)
    got = port_ff.matmul(_t(A), _t(B), impl="f64")
    assert np.all(np.abs(got.to_f64() - E) <= 2.0 ** -48 * S + 1e-30)
    assert torch.equal(got.hi + got.lo, got.hi)          # normalised


@pytest.mark.parametrize("impl", ["compensated", "split"])
@pytest.mark.parametrize("mkn", SHAPES)
def test_split_and_compensated_match_reference(impl, mkn):
    """Against the reference's jnp counterparts: the same block structure,
    with f32 GEMMs that round in another order, so within 2 bk u S of each
    other (block_k 128: several K-blocks) and of float64; bitwise on
    small-integer operands, where every GEMM is exact."""
    fns = dict(compensated=(port_mm.matmul_compensated,
                            ref_mm.matmul_compensated),
               split=(port_mm.matmul_split, ref_mm.matmul_split))[impl]
    A, B, E, S = _random(mkn, 72)
    bk = 128
    got = fns[0](_t(A), _t(B), block_k=bk)
    want = fns[1](jnp.asarray(A), jnp.asarray(B), block_k=bk)
    tol = 2 * min(bk, mkn[1]) * U * S + 1e-30
    assert np.all(np.abs(got.to_f64() - E) <= tol)
    assert np.all(np.abs(got.to_f64() - want.to_f64()) <= tol)
    Ai, Bi = _integers(mkn, 73)
    got = fns[0](_t(Ai), _t(Bi), block_k=bk)
    want = fns[1](jnp.asarray(Ai), jnp.asarray(Bi), block_k=bk)
    assert _same(want.hi, got.hi) and _same(want.lo, got.lo)


def test_suggest_slices_matches_reference():
    rng = np.random.default_rng(74)
    for spread in (0, 6, 20):
        A = (rng.standard_normal((32, 512)) * np.exp2(
            rng.integers(0, spread + 1, (32, 512)))).astype(np.float32)
        B = rng.standard_normal((512, 16)).astype(np.float32)
        assert (port_mm.suggest_slices(_t(A), _t(B))
                == ref_mm.suggest_slices(A, B))


def test_matmul_wrappers_take_plain_version_only_on_cpu():
    A, B, _, _ = _random((20, 40, 12), 75)
    counts = [f.launches for f in (port_kernels.ff_matmul,
                                   port_kernels.ff_matmul_ozaki,
                                   port_kernels.ff_matmul_dot2)]
    for fn, plain in ((port_kernels.ff_matmul, port_kernels.ff_matmul_plain),
                      (port_kernels.ff_matmul_ozaki,
                       port_kernels.ff_matmul_ozaki_plain),
                      (port_kernels.ff_matmul_dot2,
                       port_kernels.ff_matmul_dot2_plain)):
        got, want = fn(_t(A), _t(B)), plain(_t(A), _t(B))
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        meta = torch.empty((4, 4), device="meta")
        with pytest.raises(RuntimeError, match="no kernel"):
            fn(meta, meta)
    assert counts == [f.launches for f in (port_kernels.ff_matmul,
                                           port_kernels.ff_matmul_ozaki,
                                           port_kernels.ff_matmul_dot2)]


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def test_matmul_registry_and_defaults():
    assert set(port_ff.impls("matmul")) == {
        "hybrid", "pallas_hybrid", "compensated", "split", "dot2",
        "pallas_dot2", "ozaki", "pallas_ozaki", "f64"}
    assert "matmul" in port_ff.ops()
    for dev in ("cpu", "cuda"):
        assert dispatch.resolve_name("matmul", device=dev) == "hybrid"
    assert ref_ff.resolve_name("matmul") == "hybrid"


def test_matmul_resolution_order_matches_reference():
    """explicit > use > policy(matmul=) > tuned/tuned_accurate > default;
    with no tuning table "tuned" is the static default and
    "tuned_accurate" the first of (f64, ozaki, dot2)."""
    def both(impl=None):
        return (dispatch.resolve_name("matmul", impl, "cpu"),
                ref_ff.resolve_name("matmul", impl))

    assert both("tuned") == ("hybrid", "hybrid")
    assert both("tuned_accurate") == ("f64", "f64")
    with port_ff.policy("ff_full", matmul="dot2") as p, \
            ref_ff.policy("ff_full", matmul="dot2") as q:
        assert p.matmul_impl == q.matmul_impl == "dot2" and p.ff_logits
        assert both() == ("dot2", "dot2")
        assert both("split") == ("split", "split")
        with port_ff.use(matmul="ozaki"), ref_ff.use(matmul="ozaki"):
            assert both() == ("ozaki", "ozaki")
            assert both("compensated") == ("compensated", "compensated")
    for pol in ("tuned", "tuned_accurate"):
        with port_ff.policy(matmul=pol), ref_ff.policy(matmul=pol):
            assert both() == (("hybrid",) * 2 if pol == "tuned"
                              else ("f64",) * 2)
    with pytest.raises(KeyError, match="available.*hybrid"):
        dispatch.resolve_name("matmul", "nope")
    with pytest.raises(KeyError, match="unknown ff op"):
        dispatch.resolve_name("no_such_op")


def test_matmul_routes_by_policy_and_scope():
    A, B, _, _ = _random((24, 700, 16), 76)
    a, b = _t(A), _t(B)

    def same(x, y):
        return torch.equal(x.hi, y.hi) and torch.equal(x.lo, y.lo)

    dot2 = port_ff.matmul(a, b, impl="dot2")
    ozaki = port_ff.matmul(a, b, impl="ozaki")
    assert not same(dot2, ozaki)
    with port_ff.policy("ff_full", matmul="dot2"):
        assert same(port_ff.matmul(a, b), dot2)
        with port_ff.use(matmul="ozaki"):
            assert same(port_ff.matmul(a, b), ozaki)
            assert same(port_ff.matmul(a, b, impl="dot2"), dot2)


def test_matmul_block_k_options():
    """``bk`` is ``block_k`` for the blocked-K impls, the policy's
    ``ff_matmul_block_k`` fills it in, and an explicit value wins."""
    A, B, _, _ = _random((16, 700, 8), 77)
    a, b = _t(A), _t(B)

    def same(x, y):
        return torch.equal(x.hi, y.hi) and torch.equal(x.lo, y.lo)

    c128 = port_mm.matmul_compensated(a, b, block_k=128)
    c512 = port_mm.matmul_compensated(a, b, block_k=512)
    assert not same(c128, c512)
    assert same(port_ff.matmul(a, b), c512)
    assert same(port_ff.matmul(a, b, impl="hybrid", bk=128), c128)
    assert same(port_ff.matmul(a, b, impl="compensated", bk=128), c128)
    with port_ff.policy(ff_matmul_block_k=128):
        assert same(port_ff.matmul(a, b), c128)
        assert same(port_ff.matmul(a, b, block_k=512), c512)
        assert same(port_ff.matmul(a, b, impl="split"),
                    port_mm.matmul_split(a, b, block_k=128))
    # the kernels keep their own knob name
    assert same(port_ff.matmul(a, b, impl="pallas_hybrid", bk=128),
                FF(*port_kernels.ff_matmul(a, b, bk=128)))


# ---------------------------------------------------------------------------
# FF operands and the gradient
# ---------------------------------------------------------------------------

def _ff_operand(x, seed):
    """The FF pairs nearest ``x`` perturbed at 2^-30 in float64, in both
    packages (``FF.from_f64``: hi = fl32(v), lo = fl32(v - hi))."""
    rng = np.random.default_rng(seed)
    v = _f64(x) * (1 + 2.0 ** -30 * rng.standard_normal(x.shape))
    port, ref = FF.from_f64(v), RefFF.from_f64(v)
    assert _same(ref.hi, port.hi) and _same(ref.lo, port.lo)
    return port, ref


@pytest.mark.parametrize("kinds", ["ff_f32", "f32_ff", "ff_ff"])
def test_ff_operands_match_reference(kinds):
    A, B, _, _ = _random((30, 600, 20), 78)
    ops_p, ops_r, vals = [], [], []
    for kind, x, seed in zip(kinds.split("_"), (A, B), (79, 80)):
        if kind == "ff":
            port, ref = _ff_operand(x, seed)
            ops_p.append(port)
            ops_r.append(ref)
            vals.append(port.to_f64())
        else:
            ops_p.append(_t(x))
            ops_r.append(jnp.asarray(x))
            vals.append(_f64(x))
    E = vals[0] @ vals[1]
    S = np.abs(vals[0]) @ np.abs(vals[1])
    for impl in ("dot2", "ozaki"):
        got = _pair64(*port_ff.matmul(*ops_p, impl=impl).astuple())
        want = ref_ff.matmul(*ops_r, impl=impl).to_f64()
        assert np.all(np.abs(got - want) <= 2.0 ** -44 * S), impl
        assert np.all(np.abs(got - E) <= 2.0 ** -42 * S), impl


@pytest.mark.parametrize("kinds", ["f32", "ff"])
@pytest.mark.parametrize("impl", ["hybrid", "dot2", "ozaki"])
def test_matmul_grad_matches_reference(impl, kinds):
    """Through the autograd Function against ``jax.grad`` of the reference
    (loss = sum(hi * w1 + lo * w2), so the cotangent has both limbs): the
    same impl runs the two backward products, so the gradients agree to
    the impl's class, 2^-40 of |g| @ |b^T| (accurate) or 2 K u of it
    (hybrid; K-blocks of 512)."""
    M, K, N = 12, 700, 9
    A, B, _, _ = _random((M, K, N), 81)
    rng = np.random.default_rng(82)
    w1 = rng.standard_normal((M, N)).astype(np.float32)
    w2 = rng.standard_normal((M, N)).astype(np.float32)
    if kinds == "ff":
        ra, rb = (_ff_operand(x, s)[1] for x, s in ((A, 83), (B, 84)))
    else:
        ra, rb = jnp.asarray(A), jnp.asarray(B)
    def ref_loss(x, y):
        out = ref_ff.matmul(x, y, impl=impl)
        return jnp.sum(out.hi * w1 + out.lo * w2)

    want = jax.grad(ref_loss, argnums=(0, 1))(ra, rb)

    def leaf(x):
        return torch.from_numpy(np.array(x)).requires_grad_()

    if kinds == "ff":
        pa, pb = (FF(leaf(x.hi), leaf(x.lo)) for x in (ra, rb))
        leaves = [pa.hi, pa.lo, pb.hi, pb.lo]
    else:
        pa, pb = leaf(ra), leaf(rb)
        leaves = [pa, pb]
    out = port_ff.matmul(pa, pb, impl=impl)
    (out.hi * _t(w1) + out.lo * _t(w2)).sum().backward()
    if kinds == "ff":
        got = [_f64(pa.hi.grad) + _f64(pa.lo.grad),
               _f64(pb.hi.grad) + _f64(pb.lo.grad)]
        want = [_f64(w.hi) + _f64(w.lo) for w in want]
    else:
        got = [_f64(x.grad) for x in leaves]
        want = [_f64(w) for w in want]
    g = np.abs(_f64(w1) + _f64(w2))
    scales = (g @ np.abs(B).T, np.abs(A).T @ g)
    for gt, wt, sc, k in zip(got, want, scales, (N, M)):
        rel = 2.0 ** -40 if impl != "hybrid" else 2 * min(k, 512) * U
        assert np.all(np.abs(gt - wt) <= rel * sc + 1e-30)
