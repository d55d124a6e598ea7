"""The fused-composite slice of the port against the reference.

  * the ``ff.fusion`` tracer: the port's Programs equal the reference's
    field by field;
  * the CPU executor ``run_torch`` is bitwise the reference's jnp executor
    (``fused(..., interpret=False)``);
  * the plain versions of the three new CUDA kernels against the
    reference's Pallas kernels in interpret mode: ``run_program_plain``
    bitwise ``run_pallas`` (chains of the f32 builtins exp/log within
    2 ulp: XLA's and torch's builtins differ), ``ff_softmax_plain`` bitwise
    in accurate mode and within 4 ulp with the builtin exp,
    ``ff_norm_stats_plain`` bitwise the reference's op sequence and within
    1 ulp of its interpret-mode result (XLA rewrites the division by C);
  * ``sqrt22``, ``fma22``, ``expm122``, ``tanh22``, ``sigmoid22`` bitwise;
  * dispatch resolution and routing by shape, the ``ff`` tiers,
    ``token_logprob`` under ``ff_math``, and ``table_elementwise`` on the
    CPU.

The reference is called with explicit non-f64 impls (its CPU default for
softmax/logsumexp is an f64 tier that the installed JAX cannot run).  The
kernels themselves run only on the card (``chip_smoke.py`` holds them to
these plain versions there).
"""

import re
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ff as ref_ff
import repro_torch.ff as port_ff
from repro.core import ff as ref_core
from repro.core import ffmath as ref_math
from repro.core.ff import FF as RFF
from repro.ff import dispatch as ref_dispatch
from repro.ff import fusion as ref_fusion
from repro.kernels import ff_fused as ref_fused
from repro.train.serve_step import token_logprob as ref_token_logprob
from repro_torch.core import ff as port_core
from repro_torch.core import ffmath as port_math
from repro_torch.core.ff import FF as PFF
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.ff import dispatch as port_dispatch
from repro_torch.ff import fusion as port_fusion
from repro_torch.kernels import ff_fused as port_fused
from repro_torch.train.serve_step import token_logprob

T = torch.from_numpy
CSRC = Path(port_fused.__file__).resolve().parents[1] / "csrc"


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32).astype(np.int64)


def _ulp(a, b) -> int:
    """Largest distance in f32 steps (0: the same bits)."""
    a, b = _bits(a), _bits(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return int(np.abs(a - b).max()) if a.size else 0


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _cmp(ref_outs, port_outs, builtin=False) -> bool:
    """Every output the same bits, shapes included; with the f32 builtins
    (``builtin``) each f32 output and each FF output's hi limb within
    2 ulp (an FF value's lo limb then carries no comparable bits)."""
    assert len(ref_outs) == len(port_outs)
    for r, p in zip(ref_outs, port_outs):
        assert isinstance(r, RFF) == isinstance(p, PFF)
        limbs = ((r.hi, p.hi), (r.lo, p.lo)) if isinstance(r, RFF) \
            else ((r, p),)
        if builtin:
            limbs = limbs[:1]
        if max(_ulp(a, _np(b)) for a, b in limbs) > (2 if builtin else 0):
            return False
    return True


# -- the chains: one factory per case, over either package's fusion module

def _pair(rng, shape, scale=1.0):
    h = (rng.standard_normal(shape) * scale).astype(np.float32)
    return (h, (h * 1e-8 * rng.standard_normal(shape)).astype(np.float32))


def _adamw(m, eps=1e-8, wd=0.1):
    return lambda *a: ref_dispatch._adamw_chain(
        m.sqrt, m.pack, (lambda x, y: x + y), *a, eps, wd)


def _adamw_xla(m, eps=1e-8, wd=0.1):
    """``_adamw_chain`` as XLA compiles it in the interpret-mode kernel:
    its algebraic simplifier turns ``(m2 / bc1) / den`` into
    ``m2 / (bc1 * den)`` (ROADMAP, caveats on the reference)."""
    def fn(g, mom, v, w, wlo, lr, b1, b2, bc1, bc2):
        m2 = b1 * mom + (1.0 - b1) * g
        v2 = b2 * v + (1.0 - b2) * g * g
        upd = m2 / (bc1 * (m.sqrt(v2 / bc2) + eps)) + wd * w
        return m.pack(w, wlo) + (-lr * upd), m2, v2
    return fn


def _ops(rng):
    """(name, chain factory, operands as numpy / pairs / floats, holds
    f32 builtins)."""
    R, C = 6, 300
    x, y = _pair(rng, (R, C)), _pair(rng, (R, C))
    f = rng.standard_normal((R, C)).astype(np.float32)
    pos = (np.abs(rng.standard_normal((R, C))) + 0.1).astype(np.float32)
    col = rng.standard_normal((R, 1)).astype(np.float32)
    row = rng.standard_normal((C,)).astype(np.float32)
    g = rng.standard_normal((R, C)).astype(np.float32)
    mom = (rng.standard_normal((R, C)) * 0.1).astype(np.float32)
    v = np.abs(rng.standard_normal((R, C)) * 0.01).astype(np.float32)
    w, wlo = _pair(rng, (R, C))

    def every_op(m):
        def fn(a, x, y, f, p):
            t = x * y + a
            u = t / y
            s = m.sqrt(u * u + 1.0)
            z = -m.fma(x, y, s) - x
            f2 = (f * f - f / p) + m.sqrt(p)
            q = m.pack(f2, -f) * 2.0
            return (z, s.hi, -f2, q, q.hi + z.lo, m.scale(x, 0.5) - 1.0,
                    m.exp(x * 0.5), m.log(m.pack(p, p * 0.0)), m.tanh(x),
                    m.sigmoid(y), m.tanh(f * 0.3), (f2 * f).sum(), f.sum())
        return fn

    def builtins(m):
        return lambda f, p: (m.exp(f * 0.5), m.log(p + 1.0),
                             m.exp(-f).sum())

    def bcast(m):
        return lambda x, c, r, s: (x * c + r, (c * r).sum(), c.sum(),
                                   (x.hi * s).sum(), r * s)

    ragged = (rng.standard_normal((3, 1000)).astype(np.float32),
              rng.standard_normal((1000,)).astype(np.float32))
    return [
        ("axpy", lambda m: (lambda a, x, y: a * x + y), (1.618, x, y), False),
        ("adamw_chain", _adamw, (g, mom, v, w, wlo, 1e-3, 0.9, 0.95, 0.1,
                                 0.05), False),
        ("mean_sq", lambda m: (lambda v: (v * v).sum()), (f,), False),
        ("every_op", every_op, (1.5, x, y, f, pos), False),
        ("builtins", builtins, (f, pos), True),
        ("broadcast", bcast, (x, col, row, 2.5), False),
        ("ragged_rowsum", lambda m: (lambda v, w: ((v * w).sum(), v + w)),
         ragged, False),
        ("deep", lambda m: (lambda x: (m.exp(x), m.log(m.sigmoid(x)),
                                       m.tanh(x))), (_pair(rng, (4, 130),
                                                           3.0),), False),
    ]


CASES = [c[0] for c in _ops(np.random.default_rng(0))]


def _case(name):
    (case,) = [c for c in _ops(np.random.default_rng(70)) if c[0] == name]
    return case


def _operands(ops, side):
    out = []
    for o in ops:
        if isinstance(o, tuple):
            out.append(RFF(jnp.asarray(o[0]), jnp.asarray(o[1]))
                       if side == "ref" else PFF(T(o[0]), T(o[1])))
        elif isinstance(o, float):
            out.append(o)
        else:
            out.append(jnp.asarray(o) if side == "ref" else T(o))
    return out


@pytest.mark.parametrize("name", CASES)
def test_trace_programs_equal_reference(name):
    _, mk, ops, _ = _case(name)
    want = ref_fusion.fused(mk(ref_fusion)).program(*_operands(ops, "ref"))
    got = port_fusion.fused(mk(port_fusion)).program(*_operands(ops, "port"))
    assert got.leaf_kinds == want.leaf_kinds
    assert got.out_ids == want.out_ids
    assert len(got.instrs) == len(want.instrs)
    for gi, wi in zip(got.instrs, want.instrs):
        assert (gi.op, gi.args, gi.imm, gi.dtype) == \
            (wi.op, wi.args, wi.imm, wi.dtype)
    assert got.plane_count() == want.plane_count()
    assert got.reductions == want.reductions


@pytest.mark.parametrize("name", CASES)
def test_run_torch_bitwise_reference(name):
    """The CPU executor against the reference's jnp executor: bitwise,
    f32 builtins within 2 ulp."""
    _, mk, ops, builtin = _case(name)
    want = ref_fusion.fused(mk(ref_fusion))(*_operands(ops, "ref"),
                                            interpret=False)
    got = port_fusion.fused(mk(port_fusion))(*_operands(ops, "port"))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert _cmp(want, got, builtin)


@pytest.mark.parametrize("name", CASES)
def test_run_program_plain_bitwise_pallas_interpret(name):
    """The Program kernel's plain version against the reference's TPU
    executor in interpret mode: same bits and shapes (the lane order of
    every rowsum, ragged C and column-broadcast values included).  The
    AdamW chain is held to it with XLA's rewrite of its division applied
    (the written order is bitwise the jnp executor, above)."""
    _, mk, ops, builtin = _case(name)
    ref_ops, port_ops = _operands(ops, "ref"), _operands(ops, "port")
    port_mk = _adamw_xla if name == "adamw_chain" else mk
    prog = port_fusion.fused(port_mk(port_fusion)).program(*port_ops)
    want = ref_fused.run_pallas(
        ref_fusion.fused(mk(ref_fusion)).program(*ref_ops), ref_ops,
        interpret=True)
    n0 = port_fused.run_program.launches
    got = port_fused.run_program(prog, port_ops)   # CPU: the plain version
    assert port_fused.run_program.launches == n0
    assert _cmp(want, got, builtin)
    assert _cmp(want, port_fused.run_program_plain(prog, port_ops),
                builtin)


def test_run_program_plain_keeps_the_written_adamw_order():
    """On the AdamW chain as written, the Program kernel's plain version is
    bitwise the CPU executor (elementwise: no summation order), so the
    kernel keeps the reference's written op order, as its jnp impl and
    the dedicated AdamW kernel do."""
    _, mk, ops, _ = _case("adamw_chain")
    fn = port_fusion.fused(mk(port_fusion))
    port_ops = _operands(ops, "port")
    got = port_fused.run_program_plain(fn.program(*port_ops), port_ops)
    want = fn(*port_ops)
    for g, w in zip(got, want):
        for a, b in ((g.hi, w.hi), (g.lo, w.lo)) if isinstance(g, PFF) \
                else ((g, w),):
            assert torch.equal(a, b)


def test_program_rowsum_lane_order_differs_from_blocked_sum_by_one_ulp():
    """The kernel's 128-lane rowsum and ``ff_sum_blocked`` (the op-by-op
    sum) are two compensated orders: within 1 ulp of the f32 result."""
    rng = np.random.default_rng(71)
    x = (rng.standard_normal((16, 2000))
         * 10.0 ** rng.uniform(-3, 3, (16, 2000))).astype(np.float32)
    fn = port_fusion.fused(lambda v: (v * v).sum())
    lane = port_fused.run_program(fn.program(T(x)), [T(x)])[0]
    blocked = fn(T(x))
    assert _ulp(lane.hi.numpy(), blocked.hi.numpy()) <= 1


def test_program_tape_matches_kernel_source():
    """The op codes and tape capacity of the wrapper are the CUDA
    source's (its enum order, its constants)."""
    src = (CSRC / "ff_program.cu").read_text()
    body = re.search(r"enum Op : int \{([^}]*)\}", src).group(1)
    names = [n.strip().lower() for n in body.split(",") if n.strip()]
    assert tuple(names) == port_fused.PROGRAM_OPS
    caps = re.search(r"kMaxInstrs = (\d+), kMaxPlanes = (\d+), "
                     r"kMaxOuts = (\d+)", src).groups()
    assert tuple(map(int, caps)) == (port_fused.MAX_INSTRS,
                                     port_fused.MAX_PLANES,
                                     port_fused.MAX_OUTS)
    traced = set()
    for _, mk, ops, _ in _ops(np.random.default_rng(0)):
        prog = port_fusion.fused(mk(port_fusion)).program(
            *_operands(ops, "port"))
        traced |= {ins.op for ins in prog.instrs}
    assert traced == set(port_fused.PROGRAM_OPS)     # every op is tested


# -- ff_softmax and ff_norm_stats --------------------------------------------

SOFTMAX_SHAPES = [(3, 1000), (8, 256), (5, 130), (2, 3, 300)]


@pytest.mark.parametrize("shape", SOFTMAX_SHAPES)
@pytest.mark.parametrize("mode", ["softmax", "logsumexp"])
@pytest.mark.parametrize("accurate", [True, False])
def test_ff_softmax_plain_matches_reference_kernel(shape, mode, accurate):
    """Accurate mode bitwise (exp22, FF sums, Div22 / log22 + Add212 are
    the reference's op sequences); the builtin exp within 4 ulp (XLA's and
    torch's f32 exp each carry ~1-2 ulp, and the quotient adds one
    rounding)."""
    rng = np.random.default_rng(72)
    x = (rng.standard_normal(shape) * 3.0).astype(np.float32)
    want = ref_fused.ff_softmax(jnp.asarray(x), mode=mode, accurate=accurate,
                                interpret=True)
    n0 = port_fused.ff_softmax.launches
    got = port_fused.ff_softmax(T(x), mode, accurate)
    assert port_fused.ff_softmax.launches == n0
    assert _ulp(want, got.numpy()) <= (0 if accurate else 4)


def test_ff_softmax_and_norm_stats_refuse_long_rows():
    x = np.zeros((2, port_fused.MAX_FUSED_COLS + 1), np.float32)
    assert port_fused.MAX_FUSED_COLS == ref_fused.MAX_FUSED_COLS == 16384
    for call in (lambda: port_fused.ff_softmax(T(x)),
                 lambda: port_fused.ff_softmax(T(x), "logsumexp", True),
                 lambda: port_fused.ff_norm_stats(T(x)),
                 lambda: ref_fused.ff_softmax(jnp.asarray(x),
                                              interpret=True),
                 lambda: ref_fused.ff_norm_stats(jnp.asarray(x),
                                                 interpret=True)):
        with pytest.raises(ValueError, match="MAX_FUSED_COLS"):
            call()


def _norm_stats_recip(x):
    """The plain version with each ``/ C`` as ``* fl32(1/C)``: what XLA's
    algebraic simplifier makes of the reference kernel's division by a
    constant when it compiles the interpret-mode kernel."""
    x2 = T(x).reshape(-1, x.shape[-1])
    inv = torch.tensor(np.float32(1.0 / x.shape[-1]))
    mu = port_fused._fold_lanes(port_fused._lane_cascade(x2)).hi * inv
    d = x2 - mu[:, None]
    var = port_fused._fold_lanes(port_fused._lane_cascade(d * d)).hi * inv
    return mu.numpy(), var.numpy()


@pytest.mark.parametrize("shape", SOFTMAX_SHAPES + [(64, 2048)])
def test_ff_norm_stats_plain_matches_reference_kernel(shape):
    """The lane cascades are the reference kernel's bits: with its division
    by C rewritten as XLA rewrites it, bitwise; as written (IEEE division,
    as the CUDA kernel), within 1 ulp of mu and 2 ulp of var (a 1-ulp
    shift of mu moves every centred term)."""
    rng = np.random.default_rng(73)
    x = (rng.standard_normal(shape) * 3.0 + 1.0).astype(np.float32)
    mu_r, var_r = ref_fused.ff_norm_stats(jnp.asarray(x), interpret=True)
    rmu, rvar = _norm_stats_recip(x)
    assert _ulp(mu_r, rmu.reshape(shape[:-1])) == 0
    assert _ulp(var_r, rvar.reshape(shape[:-1])) == 0
    mu, var = port_fused.ff_norm_stats(T(x))
    assert _ulp(mu_r, mu.numpy()) <= 1 and _ulp(var_r, var.numpy()) <= 2


# -- core ops -----------------------------------------------------------------

def test_sqrt22_fma22_neg_bitwise_reference():
    rng = np.random.default_rng(74)
    n = 20000
    a = (np.abs(rng.standard_normal(n))
         * np.exp(rng.uniform(-5, 5, n))).astype(np.float32)
    al = (a * 1e-8 * rng.standard_normal(n)).astype(np.float32)
    b, bl = _pair(rng, n)
    c, cl = _pair(rng, n)
    r = ref_core.sqrt22(RFF(jnp.asarray(a), jnp.asarray(al)))
    p = port_core.sqrt22(PFF(T(a), T(al)))
    assert _ulp(r.hi, p.hi.numpy()) == 0 and _ulp(r.lo, p.lo.numpy()) == 0
    r = ref_core.fma22(*(RFF(jnp.asarray(h), jnp.asarray(lo))
                         for h, lo in ((a, al), (b, bl), (c, cl))))
    p = port_core.fma22(*(PFF(T(h), T(lo))
                          for h, lo in ((a, al), (b, bl), (c, cl))))
    assert _ulp(r.hi, p.hi.numpy()) == 0 and _ulp(r.lo, p.lo.numpy()) == 0
    r, p = -RFF(jnp.asarray(b), jnp.asarray(bl)), -PFF(T(b), T(bl))
    assert _ulp(r.hi, p.hi.numpy()) == 0 and _ulp(r.lo, p.lo.numpy()) == 0


@pytest.mark.parametrize("name,scale", [("expm122", 30.0), ("tanh22", 10.0),
                                        ("sigmoid22", 40.0)])
def test_ffmath_deep_ops_bitwise_reference(name, scale):
    """Normal-range inputs over every branch: small, the identity band,
    the polynomial and the reconstructed ranges."""
    rng = np.random.default_rng(75)
    n = 20000
    x = (rng.uniform(-1, 1, n) * scale).astype(np.float32)
    x[:200] *= 1e-3
    x[200:400] *= 1e-12
    xl = (x * rng.uniform(-2 ** -25, 2 ** -25, n)).astype(np.float32)
    rh, rl = getattr(ref_math, name)(jnp.asarray(x), jnp.asarray(xl))
    ph, pl = getattr(port_math, name)(T(x), T(xl))
    assert _ulp(rh, ph.numpy()) == 0 and _ulp(rl, pl.numpy()) == 0


# -- dispatch ----------------------------------------------------------------

def test_composite_resolution_defaults():
    for op in ("softmax", "logsumexp", "norm_stats"):
        assert port_dispatch.resolve_name(op, device="cuda") == "pallas"
        assert port_dispatch.resolve_name(op, device="cpu") == "jnp"
    for op in ("softmax", "logsumexp"):
        assert set(port_dispatch.impls(op)) == {"jnp", "pallas", "ff",
                                                "f64"}
        assert port_dispatch.resolve_name(op, "tuned_accurate") == "ff"
    assert port_dispatch.impls("norm_stats") == ("jnp", "pallas")


@pytest.mark.parametrize("op", ["softmax", "logsumexp", "norm_stats"])
def test_pallas_routes_by_shape_with_a_warning(op):
    """Rows longer than MAX_FUSED_COLS (and, for softmax/logsumexp, a
    non-last axis) take the jnp formulation with one warning, as the
    reference's TPU default does; a row that fits takes the kernel (its
    plain version on the CPU) without one."""
    rng = np.random.default_rng(76)
    call = getattr(port_ff, op)
    long = T(rng.standard_normal((2, 16385)).astype(np.float32))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        got = call(long, impl="pallas")
    assert len(rec) == 1 and "falling back" in str(rec[0].message)
    want = call(long, impl="jnp")
    for g, w in zip(*(((v,) if isinstance(v, torch.Tensor) else v)
                      for v in (got, want))):
        assert torch.equal(g, w)
    if op != "norm_stats":
        x = T(rng.standard_normal((4, 6)).astype(np.float32))
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            call(x, axis=0, impl="pallas")
        assert len(rec) == 1
    fits = T(rng.standard_normal((3, 200)).astype(np.float32))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        call(fits, impl="pallas")
    assert not rec


@pytest.mark.parametrize("op", ["softmax", "logsumexp"])
@pytest.mark.parametrize("impl", ["jnp", "ff", "pallas"])
def test_softmax_tiers_match_reference(op, impl):
    """The port's tiers against the reference's on the CPU: the FF tier
    bitwise (FF exponentials, FF sums, Div22 / log22); the jnp tier within
    4 ulp (f32 builtin exp); the pallas tier (the kernel's plain version)
    against the reference's interpret-mode kernel within 4 ulp."""
    rng = np.random.default_rng(77)
    x = (rng.standard_normal((4, 700)) * 4.0).astype(np.float32)
    got = getattr(port_ff, op)(T(x), impl=impl)
    ref_impl = ref_dispatch.lookup(op, impl)
    want = ref_impl(jnp.asarray(x), axis=-1,
                    **({"interpret": True} if impl == "pallas" else {}))
    assert _ulp(want, got.numpy()) <= (0 if impl == "ff" else 4)


def test_f64_tiers_against_numpy():
    rng = np.random.default_rng(78)
    x = (rng.standard_normal((3, 500)) * 4.0).astype(np.float32)
    x64 = x.astype(np.float64)
    m = x64.max(-1, keepdims=True)
    p = np.exp(x64 - m)
    lse = port_ff.logsumexp(T(x), impl="f64").double().numpy()
    sm = port_ff.softmax(T(x), impl="f64").double().numpy()
    assert np.abs(lse - (m[:, 0] + np.log(p.sum(-1)))).max() <= 1e-5
    assert np.abs(sm - p / p.sum(-1, keepdims=True)).max() <= 1e-6


def test_norm_stats_jnp_bitwise_reference():
    rng = np.random.default_rng(79)
    x = (rng.standard_normal((5, 777)) * 2.0 + 3.0).astype(np.float32)
    mu, var = port_ff.norm_stats(T(x))
    rmu, rvar = ref_ff.norm_stats(jnp.asarray(x), impl="jnp")
    assert _ulp(rmu, mu.numpy()) == 0 and _ulp(rvar, var.numpy()) == 0


def test_mul_matches_reference():
    rng = np.random.default_rng(80)
    (ah, al), (bh, bl) = _pair(rng, (7, 9)), _pair(rng, (7, 9))
    s = rng.standard_normal((7, 9)).astype(np.float32)
    for ra, rb, pa, pb in (
            (RFF(jnp.asarray(ah), jnp.asarray(al)),
             RFF(jnp.asarray(bh), jnp.asarray(bl)),
             PFF(T(ah), T(al)), PFF(T(bh), T(bl))),
            (RFF(jnp.asarray(ah), jnp.asarray(al)), jnp.asarray(s),
             PFF(T(ah), T(al)), T(s)),
            (jnp.asarray(s), RFF(jnp.asarray(bh), jnp.asarray(bl)),
             T(s), PFF(T(bh), T(bl)))):
        r, p = ref_ff.mul(ra, rb, impl="jnp"), port_ff.mul(pa, pb)
        assert _ulp(r.hi, p.hi.numpy()) == 0 and _ulp(r.lo, p.lo.numpy()) == 0


def test_softmax_and_norm_stats_gradients_match_reference():
    """The calls that refused a gradient give the reference's: softmax
    with the accurate impl ``ff`` (the same bits forward) within 4 ulps
    of max |g| |y| (``sum(g y)`` adds in another order), norm_stats
    bitwise; under no_grad the call runs without a graph."""
    import jax
    rng = np.random.default_rng(83)
    x = rng.standard_normal((2, 8)).astype(np.float32)
    w = rng.standard_normal((2, 8)).astype(np.float32)
    want = np.asarray(jax.grad(lambda a: jnp.sum(
        ref_ff.softmax(a, impl="ff") * w))(jnp.asarray(x)))
    t = T(x).requires_grad_()
    (port_ff.softmax(t, impl="ff") * T(w)).sum().backward()
    assert np.abs(want - t.grad.numpy()).max() <= \
        4 * 2.0 ** -24 * np.abs(w).max()
    want = np.asarray(jax.grad(lambda a: jnp.sum(
        ref_ff.norm_stats(a, impl="jnp")[1] * w[:, 0]))(jnp.asarray(x)))
    t = T(x).requires_grad_()
    (port_ff.norm_stats(t)[1] * T(w[:, 0])).sum().backward()
    assert _ulp(want, t.grad.numpy()) == 0
    with torch.no_grad():
        assert port_ff.softmax(t).grad_fn is None


def test_logsumexp_grad_on_every_impl():
    """logsumexp keeps its gradient, the softmax, whatever impl
    resolves."""
    for impl in ("jnp", "pallas", "ff", "f64"):
        y = torch.randn(2, 8, requires_grad=True)
        port_ff.logsumexp(y, impl=impl).sum().backward()
        assert torch.allclose(y.grad, torch.softmax(y.detach(), -1),
                              atol=1e-6)


def test_wrappers_take_plain_version_only_on_cpu():
    x = torch.randn(3, 300)
    n = (port_fused.ff_softmax.launches, port_fused.ff_norm_stats.launches,
         port_fused.run_program.launches)
    assert torch.equal(port_fused.ff_softmax(x, "logsumexp", True),
                       port_fused.ff_softmax_plain(x, "logsumexp", True))
    mu, var = port_fused.ff_norm_stats(x)
    assert torch.equal(var, port_fused.ff_norm_stats_plain(x)[1])
    assert (port_fused.ff_softmax.launches, port_fused.ff_norm_stats.launches,
            port_fused.run_program.launches) == n
    meta = torch.empty((2, 8), device="meta")
    for call in (lambda: port_fused.ff_softmax(meta),
                 lambda: port_fused.ff_norm_stats(meta),
                 lambda: port_ff.fused(lambda v: v * 2.0)(meta)):
        with pytest.raises(RuntimeError, match="no kernel"):
            call()


@pytest.mark.parametrize("first", [True, False])
def test_fused_device_ignores_a_cpu_scalar(first, monkeypatch):
    """A 0-d CPU tensor beside operands on another device goes with them,
    wherever it stands: the call takes the kernel, never ``run_torch``;
    tensors of one or more dims on two devices raise."""
    def no_replay(*a):
        raise AssertionError("run_torch reached")

    monkeypatch.setattr(port_fusion, "run_torch", no_replay)
    axpy = port_ff.fused(lambda a, x, y: a * x + y)
    a = torch.tensor(1.618)
    meta = PFF(torch.empty((2, 8), device="meta"),
               torch.empty((2, 8), device="meta"))
    ops = (a, meta, meta) if first else (meta, a, meta)
    assert port_fusion.operand_device(ops).type == "meta"
    assert all((v.hi if isinstance(v, PFF) else v).device.type == "meta"
               for v in port_fusion.leaf_values(ops, torch.device("meta")))
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        axpy(*ops)
    with pytest.raises(ValueError, match="operands on"):
        axpy(a, meta, torch.ones(2, 8))
    assert port_fusion.operand_device((a, 2.0)).type == "cpu"


# -- token_logprob under ff_math, and the table ------------------------------

def test_token_logprob_ff_math_matches_reference():
    """``token_logprob`` under ``ff_math`` runs the ``ff`` logsumexp tier,
    as the reference: bitwise at (4, 512) on the CPU."""
    rng = np.random.default_rng(81)
    logits = (rng.standard_normal((4, 512)) * 6.0).astype(np.float32)
    tok = rng.integers(0, 512, 4).astype(np.int32)
    pol = PrecisionPolicy(ff_math=True)
    from repro.core.policy import PrecisionPolicy as RefPolicy
    want = ref_token_logprob(jnp.asarray(logits), jnp.asarray(tok),
                             RefPolicy(ff_math=True))
    got = token_logprob(T(logits), T(tok), pol)
    assert _ulp(want, got.numpy()) == 0


def test_table_elementwise_runs_on_cpu(capsys):
    from repro_torch.benchmarks import table_elementwise as tab
    rows = tab.main(["--device", "cpu", "--shapes", "8x256", "--reps", "1",
                     "--rounds", "1"])
    assert [r["chain"] for r in rows] == list(tab.CHAINS)
    for r in rows:
        assert r["device"] == "cpu" and r["max_ulp_diff"] <= r["ulp_tol"]
        assert (r["us_library"] is None) == (r["chain"] == "axpy")
    assert {r["chain"]: r["resolved_impl"] for r in rows}["softmax"] == "jnp"
    assert "norm_stats" in capsys.readouterr().out


def test_cuda_ffmath_constants_match_port():
    """The device log22 and tanh22 constants (hex floats in
    csrc/ff_eft.cuh; tanh's series in its Maclaurin branch, tanh_small)
    are the f32 roundings of the port's Python ones."""
    src = (CSRC / "ff_eft.cuh").read_text()

    def floats(fn, name):
        body = src[src.index(fn):]
        m = re.search(name + r"(?:\[\d\])? = \{?([^;}]*)\}?;", body)
        return [float.fromhex(t.strip().rstrip("f"))
                for t in m.group(1).split(",")]

    f32 = lambda xs: [float(np.float32(x)) for x in xs]    # noqa: E731
    assert floats("ff2 log_core(", "S_F32") == f32(port_math._LOG_S_F32)
    assert floats("ff2 log_core(", "S_H") == f32(
        [c[0] for c in port_math._LOG_S_FF])
    assert floats("ff2 log_core(", "S_L") == f32(
        [c[1] for c in port_math._LOG_S_FF])
    assert floats("ff2 log_core(", "LN2_H") == f32([port_math._LN2_H])
    assert floats("ff2 log_core(", "LN2_L") == f32([port_math._LN2_L])
    assert floats("ff2 tanh_small(", "C_F32") == f32(port_math._TANH_C_F32)
    assert floats("ff2 tanh_small(", "C_H") == f32(
        [c[0] for c in port_math._TANH_C_FF])
    assert floats("ff2 tanh_small(", "C_L") == f32(
        [c[1] for c in port_math._TANH_C_FF])
    assert "mh > 0x1.6a09e6p+0f" in src          # _SQRT2_F32
    assert float.fromhex("0x1.6a09e6p+0") == f32([port_math._SQRT2_F32])[0]
    assert "fabsf(xh) <= 0x1.666666p-2f" in src  # _TANH_SMALL
    assert float.fromhex("0x1.666666p-2") == f32([port_math._TANH_SMALL])[0]
