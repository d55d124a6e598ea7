"""The FF elementary functions, ``ff.math``, the ``ff_math`` model switch
and ``ff.tune`` in the port, against the reference.

  * ``core.ffmath``'s functions are bitwise the reference's jnp forms in
    every branch (erf's three bands, log1p near and far, tanh's Maclaurin
    and expm1 forms, pow's edge rules) on inputs whose limbs and results
    stay normal: in the subnormal band XLA:CPU flushes and torch does not
    (ROADMAP's FTZ policy), so those inputs are left out;
  * ``math_elementwise_plain`` (the CUDA kernel's plain version) is
    bitwise the reference's Pallas kernel in interpret mode, for the ten
    functions; tanh evaluated branch by branch (each element only on the
    branch ``tanh_band`` picks, as the kernel does) is ``tanh22``'s and
    the reference's bits;
  * the ``f64`` tier is within each function's NUMERICS.md contract of
    numpy's float64, the ``fast`` tier within 2^-20 (the f32 builtins);
  * the public calls are bitwise the reference's jnp impls; the
    registry's names are the reference's;
  * a reduced granite-3-2b served under ``ff_math=True`` gives the
    reference's greedy tokens, both with ``ff.use(silu="jnp")``; the
    soft-cap's ``ff.tanh`` branch is bitwise the reference's on exact
    logits; the functions' gradients and a training forward's under
    ``ff_math`` are the reference's;
  * ``ff.tune``: the tables equal the reference's, ``bucket_key`` gives
    its keys, and ``tests/test_tune.py``'s cases hold on the port (with
    ``impls=`` given and a ``tmp_path`` sidecar).

The reference is called with explicit non-f64 impls (its CPU default for
the ``ff.math`` functions is an f64 tier the installed JAX cannot run).
"""

import json
import math
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ff as ref_ff
import repro_torch.ff as port_ff
from repro.core import ffmath as ref_math
from repro.ff import dispatch as ref_dispatch
from repro.ff import tuning as ref_tuning
from repro.kernels import ff_math as ref_kmath
from repro_torch.core import ffmath as port_math
from repro_torch.core.ff import FF as PFF
from repro_torch.ff import dispatch as port_dispatch
from repro_torch.ff import tuning
from repro_torch.kernels import ff_math as port_kmath

_ERF64 = np.vectorize(math.erf)
ORACLE = {
    "exp": np.exp, "expm1": np.expm1, "log": np.log, "log1p": np.log1p,
    "tanh": np.tanh, "sigmoid": lambda t: 1.0 / (1.0 + np.exp(-t)),
    "erf": _ERF64,
    "gelu": lambda t: 0.5 * t * (1.0 + _ERF64(t / np.sqrt(2.0))),
    "silu": lambda t: t / (1.0 + np.exp(-t)),
}


def T(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x))


def _same(a, b) -> bool:
    """The same bits, shapes included; a NaN matches any NaN (its sign and
    payload are the arithmetic's, not the algorithm's)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    if a.shape != b.shape or not np.array_equal(np.isnan(a), np.isnan(b)):
        return False
    keep = ~np.isnan(a)
    return np.array_equal(a[keep].view(np.int32), b[keep].view(np.int32))


def _limbs(x64):
    """FF limbs of float64 values: hi = fl32(x), lo = fl32(x - hi)."""
    x64 = np.asarray(x64, np.float64)
    hi = x64.astype(np.float32)
    with np.errstate(invalid="ignore"):
        lo = np.where(np.isfinite(x64), x64 - hi.astype(np.float64),
                      0.0).astype(np.float32)
    return hi, lo


def _branch_inputs(op: str, rng) -> np.ndarray:
    """Inputs that cover every branch of ``op`` with normal limbs and
    normal results."""
    u = lambda a, b, n=300: rng.uniform(a, b, n)        # noqa: E731
    tiny = u(-1, 1, 100) * 10.0 ** u(-30, -14, 100)     # identity bands
    specials = [0.0, -0.0, np.inf, -np.inf, np.nan]
    return np.concatenate({
        "exp": [u(-0.34, 0.34), u(-60, 88), [89.5, -106.0]],
        "expm1": [u(-0.34, 0.34), u(-20, 20), u(-85, 88), tiny],
        "log": [u(0.7, 1.42), np.exp(u(-50, 50)), [-1.0]],
        "log1p": [u(-0.29, 0.41), np.exp(u(-30, 4)), u(-0.99, -0.3), tiny,
                  [-0.2928932, 0.41421354, -1.5]],
        "tanh": [u(-0.35, 0.35), u(-20, 20), tiny, [0.35, -0.35]],
        "sigmoid": [u(-30, 30), u(-65, -30)],
        "erf": [u(-1, 1), u(-4, 4), u(-8.2, 8.2), u(31, 1e6, 20),
                [1.0, -1.0, 4.0, -4.0, 30.0]],
        "gelu": [u(-1, 11.5), u(-8, -1), u(-0.5, 0.5)],
        "silu": [u(-30, 30), u(-65, 80)],
    }[op] + [specials])


def _pow_inputs(rng):
    a = np.exp(rng.uniform(-3, 3, 600))
    b = rng.uniform(-8, 8, 600)
    edges_a = [0.0, 0.0, 0.0, np.inf, np.inf, np.inf, -2.0, -2.0, 2.0, 0.0]
    edges_b = [1.5, -1.5, 0.0, 2.0, -2.0, 0.0, 0.5, 0.0, 0.0, np.nan]
    return np.concatenate([a, edges_a]), np.concatenate([b, edges_b])


MATH_OPS = port_kmath.MATH_OPS


def _operands(op, rng):
    if op == "pow":
        a, b = _pow_inputs(rng)
        return _limbs(a) + _limbs(b)
    return _limbs(_branch_inputs(op, rng))


# -- core.ffmath and the kernel's plain version -------------------------------

@pytest.mark.parametrize("op", MATH_OPS)
def test_ffmath_matches_reference_in_every_branch(op):
    rng = np.random.default_rng(101)
    planes = _operands(op, rng)
    ref_fn = ref_math.pow22 if op == "pow" else ref_math.UNARY22[op]
    port_fn = port_math.pow22 if op == "pow" else port_math.UNARY22[op]
    rh, rl = ref_fn(*(jnp.asarray(p) for p in planes))
    ph, pl = port_fn(*(T(p) for p in planes))
    assert _same(rh, ph) and _same(rl, pl)


@pytest.mark.parametrize("op", MATH_OPS)
def test_math_plain_matches_reference_kernel(op):
    """The plain version against the interpret-mode Pallas kernel, on a
    ragged 2-D layout of the branch inputs (and a row-broadcast exponent
    for pow)."""
    rng = np.random.default_rng(103)
    planes = [p[:390].reshape(3, 130) for p in _operands(op, rng)]
    if op == "pow":
        planes[2], planes[3] = planes[2][:1], planes[3][:1]
    rh, rl = ref_kmath.math_elementwise(
        op, *(jnp.asarray(p) for p in planes), interpret=True)
    ph, pl = port_kmath.math_elementwise_plain(op, *(T(p) for p in planes))
    assert _same(rh, ph) and _same(rl, pl)
    n0 = port_kmath.math_elementwise.launches
    wh, wl = port_kmath.math_elementwise(op, *(T(p) for p in planes))
    assert _same(wh, ph) and _same(wl, pl)
    assert port_kmath.math_elementwise.launches == n0
    assert port_kmath.DEFAULT_BLOCK == ref_kmath.DEFAULT_BLOCK


def _tanh_inputs(kind: str, rng):
    """tanh's band edges (0.35 = 0x1.666666p-2 and 2^-45 with their f32
    neighbours, 17-20, both signs, lo 0, -0 or +-hi 2^-25, then +-0,
    +-inf, nan), x uniform in (-1, 1) (about 35% in the small band), or
    the branch inputs."""
    if kind == "branches":
        return _limbs(_branch_inputs("tanh", rng))
    if kind == "uniform":
        return _limbs(rng.uniform(-1, 1, 2000))
    e = np.array([0.35, 2.0 ** -45], np.float32)
    h = np.concatenate([e, np.nextafter(e, np.float32(np.inf)),
                        np.nextafter(e, np.float32(0)),
                        np.array([17, 17.5, 18, 19, 20], np.float32)])
    h = np.concatenate([h, -h])
    z = np.zeros_like(h)
    spec = np.array([0.0, -0.0, np.inf, -np.inf, np.nan], np.float32)
    return (np.concatenate([h, h, h, h, spec]),
            np.concatenate([z, -z, h * np.float32(2.0 ** -25),
                            -h * np.float32(2.0 ** -25), np.zeros(5,
                                                                  np.float32)]))


@pytest.mark.parametrize("kind", ["edges", "uniform", "branches"])
def test_tanh_branch_only_matches_tanh22_and_reference(kind):
    """The ff_math kernel's tanh evaluates only the branch each element
    takes (its band by tanh_band: identity, the Maclaurin kernel, the
    expm1 form): that branch-only evaluation in torch, each branch run on
    its band's elements alone, is ffmath.tanh22's bits (both branches,
    then the selection) and the reference's tanh22's."""
    xh, xl = (T(p) for p in _tanh_inputs(kind, np.random.default_rng(107)))
    band = port_math.tanh_band(xh)
    assert set(band.unique().tolist()) <= {
        port_math.TANH_LARGE, port_math.TANH_SMALL, port_math.TANH_IDENTITY}
    gh, gl = torch.empty_like(xh), torch.empty_like(xl)
    for code, branch in ((port_math.TANH_LARGE, port_math.tanh_large22),
                         (port_math.TANH_SMALL, port_math.tanh_small22),
                         (port_math.TANH_IDENTITY, lambda h, lo: (h, lo))):
        sel = band == code
        if sel.any():
            gh[sel], gl[sel] = branch(xh[sel], xl[sel])
    ph, pl = port_math.tanh22(xh, xl)
    rh, rl = ref_math.tanh22(jnp.asarray(xh.numpy()), jnp.asarray(xl.numpy()))
    assert _same(ph, gh) and _same(pl, gl)
    # the reference's bits, but where a limb is subnormal (tanh's Maclaurin
    # lo near 2^-45), which XLA:CPU may flush to zero (ROADMAP's FTZ policy)
    tiny = np.finfo(np.float32).tiny
    for r, g in ((rh, gh), (rl, gl)):
        r, g = np.asarray(r), g.numpy()
        sub = (g != 0) & (np.abs(g) < tiny)
        assert _same(r[~sub], g[~sub])
        assert np.all((r[sub] == 0) | (r[sub] == g[sub]))
    if kind == "edges":       # each edge on its side, nan in the large band
        a, edge = xh.abs(), float(np.float32(0.35))
        want = torch.where(a < 2.0 ** -45, port_math.TANH_IDENTITY,
                           torch.where(a <= edge, port_math.TANH_SMALL,
                                       port_math.TANH_LARGE))
        assert torch.equal(band, want)
        assert set(band.tolist()) == {port_math.TANH_LARGE,
                                      port_math.TANH_SMALL,
                                      port_math.TANH_IDENTITY}


def test_cuda_constants_match_port():
    """The device twins' constants (hex floats in csrc/ff_eft.cuh) are the
    f32 roundings of the port's Python ones."""
    import re
    from pathlib import Path
    src = (Path(port_kmath.__file__).resolve().parents[1] / "csrc"
           / "ff_eft.cuh").read_text()

    def floats(fn):
        body = src[src.index(fn):]
        body = body[:body.index("\n}\n")]
        return {float.fromhex(t[:-1]) for t in
                re.findall(r"-?0x[0-9a-f.]+p[-+]\d+f", body)}

    f32 = lambda xs: {float(np.float32(x)) for x in xs}    # noqa: E731
    assert f32(port_math._ERFC_ASY) | f32(port_math._SQRTPI) \
        <= floats("ff2 erf_big(")
    assert f32(port_math._TWO_OVER_SQRTPI) \
        <= {float.fromhex(t) for t in re.findall(
            r"kTwoOverSqrtPi[HL] =\s*(-?0x[0-9a-f.]+p[-+]\d+)", src)}
    assert f32(port_math._INV_SQRT2) <= floats("ff2 gelu22(")
    assert f32(port_math._LOG1P_NEAR) <= floats("ff2 log1p22(")
    assert "fminf(axh, 30.0f)" in src and port_math._ERF_CLAMP == 30.0
    # the series' term counts (n = 1..16 and 1..59 after the n = 0 seed):
    # compile-time constants that bound the unrolled terms
    assert "kErfAltTerms = 17;" in src and "n < kErfAltTerms" in src
    assert port_math._ERF_ALT_TERMS == 17
    assert "kErfPosTerms = 60;" in src and "n < kErfPosTerms" in src
    assert port_math._ERF_POS_TERMS == 60


# -- the f64 and fast tiers ----------------------------------------------------

# (op, sampler, bound): NUMERICS.md's full-domain contracts
CONTRACT = [("exp", (-55, 88), 2.0 ** -42), ("expm1", (-20, 20), 2.0 ** -41),
            ("log", (0.01, 1e6), 2.0 ** -42), ("log1p", (-0.29, 0.41),
                                               2.0 ** -43),
            ("tanh", (-20, 20), 2.0 ** -41), ("sigmoid", (-30, 30),
                                              2.0 ** -42),
            ("erf", (-6, 6), 2.0 ** -42), ("gelu", (-1, 20), 2.0 ** -42),
            ("silu", (-30, 30), 2.0 ** -42)]


def _rel(got: PFF, want: np.ndarray) -> float:
    g = got.hi.numpy().astype(np.float64) + got.lo.numpy().astype(np.float64)
    return float((np.abs(g - want) / np.maximum(np.abs(want), 1e-300)).max())


@pytest.mark.parametrize("op,dom,bound", CONTRACT, ids=[c[0] for c in CONTRACT])
def test_f64_and_jnp_tiers_hold_the_contract(op, dom, bound):
    rng = np.random.default_rng(107)
    h, lo = _limbs(rng.uniform(*dom, 4000))
    x = h.astype(np.float64) + lo.astype(np.float64)
    want = ORACLE[op](x)
    for impl in ("f64", "jnp"):
        got = getattr(port_ff, op)(PFF(T(h), T(lo)), impl=impl)
        assert _rel(got, want) <= bound, impl
    # the fast tier: the f32 builtin of the f32-rounded argument
    fast = getattr(port_ff, op)(PFF(T(h), T(lo)), impl="fast")
    assert not fast.lo.any()
    x32 = (h + lo).astype(np.float64)
    assert _rel(fast, ORACLE[op](x32)) <= 2.0 ** -20


def test_pow_tiers_hold_the_contract():
    rng = np.random.default_rng(109)
    a, b = np.exp(rng.uniform(-3, 3, 4000)), rng.uniform(-8, 8, 4000)
    (ah, al), (bh, bl) = _limbs(a), _limbs(b)
    a = ah.astype(np.float64) + al
    b = bh.astype(np.float64) + bl
    want = np.power(a, b)
    bound = (1.0 + np.abs(b * np.log(a))) * 2.0 ** -42
    for impl in ("f64", "jnp"):
        got = port_ff.pow(PFF(T(ah), T(al)), PFF(T(bh), T(bl)), impl=impl)
        g = got.hi.numpy().astype(np.float64) + got.lo.numpy()
        assert (np.abs(g - want) <= bound * np.abs(want)).all(), impl
    # the kernel's domain rule in every tier: a < 0 -> nan, b == 0 -> 1
    edge = [port_ff.pow(PFF(T(np.float32([-2.0, -2.0])), T(np.zeros(2,
                        np.float32))), PFF(T(np.float32([0.5, 0.0])),
                        T(np.zeros(2, np.float32))), impl=i).hi.numpy()
            for i in ("jnp", "f64", "fast")]
    for e in edge:
        assert np.isnan(e[0]) and e[1] == 1.0


# -- dispatch and the public calls ---------------------------------------------

@pytest.mark.parametrize("op", MATH_OPS)
def test_math_registry_matches_reference(op):
    """Names are the reference's; ``jnp`` is the default everywhere (the
    reference's CPU default, ``f64``, is a real tier here but no
    default); an untuned ``tuned_accurate`` request takes ``f64``."""
    assert port_dispatch.impls(op) == ref_dispatch.impls(op)
    assert port_dispatch._DEFAULTS[op] == {"*": "jnp"}
    assert ref_dispatch._DEFAULTS[op] == {"*": "jnp", "cpu": "f64"}
    assert port_dispatch.resolve_name(op, "tuned_accurate", "cuda",
                                      (7, 9)) == "f64"


@pytest.mark.parametrize("op", MATH_OPS)
@pytest.mark.parametrize("impl", ["jnp", "pallas"])
def test_math_calls_match_reference(op, impl):
    rng = np.random.default_rng(113)
    planes = [p[:200].reshape(2, 100) for p in _operands(op, rng)]
    if op == "pow":
        rargs = (ref_ff.FF(*map(jnp.asarray, planes[:2])),
                 ref_ff.FF(*map(jnp.asarray, planes[2:])))
        pargs = (PFF(*map(T, planes[:2])), PFF(*map(T, planes[2:])))
    else:
        rargs = (ref_ff.FF(*map(jnp.asarray, planes)),)
        pargs = (PFF(*map(T, planes)),)
    want = getattr(ref_ff, op)(*rargs, impl="jnp")
    got = getattr(port_ff, op)(*pargs, impl=impl)
    assert _same(want.hi, got.hi) and _same(want.lo, got.lo)
    if op != "pow":                          # an f32 operand is lifted
        want = getattr(ref_ff, op)(jnp.asarray(planes[0]), impl="jnp")
        got = getattr(port_ff, op)(T(planes[0]), impl=impl)
        assert _same(want.hi, got.hi) and _same(want.lo, got.lo)


def test_math_calls_give_reference_gradients():
    """The calls that refused a gradient give the reference's: each of the
    ten functions at x = (0.5, 1, 1.5) (pow at (x, x)), the hi limb as
    the loss, bitwise on the jnp and kernel tiers (the kernel's plain
    version here).  ``tests/test_torch_grad.py`` covers the branches and
    the operand forms."""
    x = np.float32([0.5, 1.0, 1.5])
    for op in port_dispatch.MATH_OPS:
        def call(f, impl, op=op):
            if op == "pow":
                return lambda t: f.pow(t, t, impl=impl)
            return lambda t: getattr(f, op)(t, impl=impl)
        want = jax.grad(lambda t: jnp.sum(call(ref_ff, "jnp")(t).hi))(
            jnp.asarray(x))
        for impl in ("jnp", "pallas"):
            t = T(x.copy()).requires_grad_()
            call(port_ff, impl)(t).hi.sum().backward()
            assert _same(want, t.grad), (op, impl)
    with torch.no_grad():
        assert port_ff.silu(T(x).requires_grad_()).hi.grad_fn is None


# -- the ff_math model switch ----------------------------------------------------

def _granite_cfgs(**over):
    from repro.models.config import ModelConfig as RefConfig
    from repro_torch.configs.granite_3_2b import CONFIG
    port = CONFIG.reduced(compute_dtype="float32", **over)
    fields = {f: getattr(port, f) for f in port.__dataclass_fields__}
    return RefConfig(**fields), port


def test_granite_ff_math_serving_matches_reference():
    """A reduced granite-3-2b served under ff_math=True: the port's engine
    (CPU, plain versions) gives the reference engine's greedy tokens, both
    with ff.use(silu="jnp"); the port's pallas silu (its plain version
    here) gives the same tokens."""
    from repro.models import init_params as ref_init
    from repro.serve import Request as RefRequest
    from repro.serve import ServeEngine as RefEngine
    from repro_torch.interop import params_from_numpy
    from repro_torch.serve import Request, ServeEngine
    ref_cfg, port_cfg = _granite_cfgs()
    ref_w = ref_init(ref_cfg, jax.random.PRNGKey(3))
    port_w = params_from_numpy(jax.tree_util.tree_map(np.asarray, ref_w),
                               device="cpu")
    rng = np.random.default_rng(127)
    prompts = [rng.integers(1, port_cfg.vocab_size, size=n).astype(np.int32)
               for n in (6, 11, 9)]
    eng_kw = dict(max_batch=2, page_size=8, max_ctx=32)
    with ref_ff.policy("ff_reduce", attention="pallas", ff_math=True), \
            ref_ff.use(silu="jnp", logsumexp="jnp"):
        ref = RefEngine(ref_w, ref_cfg, **eng_kw)
        for i, p in enumerate(prompts):
            ref.submit(RefRequest(uid=i, prompt=p, max_new=5))
        want = ref.run()
    for silu in ("jnp", "pallas"):
        with port_ff.policy("ff_reduce", attention="pallas", ff_math=True):
            eng = ServeEngine(port_w, port_cfg, device="cpu", **eng_kw)
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=p, max_new=5))
        with port_ff.use(silu=silu):
            got = eng.run()
        for uid in range(len(prompts)):
            assert got[uid].status == "OK"
            assert np.array_equal(got[uid].tokens, want[uid].tokens), \
                (silu, uid)


def test_ff_math_gate_is_the_ff_silu():
    """mlp_apply(ff_math=True) is the reference's gate: the FF silu of the
    f32 pre-activation, rounded to f32.  Small integer weights and a
    one-hot w_down make both packages' products exact, so the outputs are
    the gates' bits."""
    from repro.models.layers import mlp_apply as ref_mlp
    from repro_torch.models.layers import mlp_apply
    rng = np.random.default_rng(131)
    p = {"w_gate": rng.integers(-2, 3, (8, 16)).astype(np.float32),
         "w_up": rng.integers(-2, 3, (8, 16)).astype(np.float32),
         "w_down": np.eye(16, 8, dtype=np.float32)}
    x = rng.integers(-3, 4, (2, 5, 8)).astype(np.float32) * 0.25
    with ref_ff.use(silu="jnp"):
        want = ref_mlp({k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(x), ff_math=True)
    got = mlp_apply({k: T(v) for k, v in p.items()}, T(x), ff_math=True)
    with port_ff.use(silu="pallas"):            # its plain version here
        kern = mlp_apply({k: T(v) for k, v in p.items()}, T(x),
                         ff_math=True)
    plain = mlp_apply({k: T(v) for k, v in p.items()}, T(x))
    assert _same(want, got) and _same(got, kern)
    assert not torch.equal(got, plain)          # the builtin differs


def test_softcap_branch_takes_ff_tanh():
    """unembed_apply's soft-cap under ff_math is the reference's ff.tanh
    cap bit for bit (exact logits: small integers), and the f32 tanh cap
    without it."""
    from repro.models.layers import unembed_apply as ref_unembed
    from repro_torch.models.layers import unembed_apply
    ref_cfg, port_cfg = _granite_cfgs(logit_softcap=30.0)
    rng = np.random.default_rng(137)
    p = {"tok": rng.integers(-3, 4, (40, 16)).astype(np.float32),
         "unembed": rng.integers(-3, 4, (16, 40)).astype(np.float32)}
    x = rng.integers(-4, 5, (2, 3, 16)).astype(np.float32)
    with ref_ff.use(tanh="jnp"):
        want = ref_unembed({k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(x), ref_cfg, ff_math=True)
    got = unembed_apply({k: T(v) for k, v in p.items()}, T(x), port_cfg,
                        ff_math=True)
    assert _same(want, got)
    plain = unembed_apply({k: T(v) for k, v in p.items()}, T(x), port_cfg)
    np.testing.assert_allclose(plain.numpy(), np.asarray(want), rtol=2e-6)


def test_training_under_ff_math_gives_reference_gradients():
    """The call that raised: train_forward of a one-layer granite under
    ``PrecisionPolicy(ff_math=True)`` now gives the reference's loss
    within 1e-6 relative and its parameter gradients within 1e-5 of each
    leaf's largest element (f32; the matrix products add in other
    orders), both with the FF silu gate (``silu="jnp"``)."""
    from repro.models import init_params as ref_init
    from repro.models.model import train_forward as ref_train_forward
    from repro_torch.interop import params_from_numpy
    from repro_torch.models.model import train_forward
    from repro_torch.optim.adamw import tree_leaves
    ref_cfg, cfg = _granite_cfgs(num_layers=1)
    ref_w = ref_init(ref_cfg, jax.random.PRNGKey(5))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, ref_w),
                               device="cpu")
    rng = np.random.default_rng(139)
    tokens = rng.integers(1, cfg.vocab_size, (2, 6)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1)
    with ref_ff.use(silu="jnp", logsumexp="jnp"):
        (want_loss, _), want = jax.value_and_grad(
            lambda w: ref_train_forward(
                w, {"tokens": jnp.asarray(tokens),
                    "targets": jnp.asarray(targets)}, ref_cfg,
                ref_ff.PrecisionPolicy(ff_math=True)), has_aux=True)(ref_w)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    with port_ff.use(silu="jnp"):
        loss, _ = train_forward(
            params, {"tokens": torch.from_numpy(tokens).long(),
                     "targets": torch.from_numpy(targets).long()}, cfg,
            port_ff.PrecisionPolicy(ff_math=True))
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss) - float(want_loss)) <= 1e-6 * abs(float(want_loss))
    for a, b in zip(jax.tree_util.tree_leaves(want), grads):
        a = np.asarray(a)
        assert np.abs(a - b.numpy()).max() <= 1e-5 * np.abs(a).max()


# -- ff.tune -----------------------------------------------------------------------

def test_tuning_tables_equal_the_reference():
    assert tuning.ACCURACY_CLASS == ref_tuning.ACCURACY_CLASS
    assert tuning._OP_ACCURACY == ref_tuning._OP_ACCURACY
    assert tuning._FAST_ELIGIBLE == ref_tuning._FAST_ELIGIBLE
    assert tuning.SWEEP_CONFIGS == ref_tuning.SWEEP_CONFIGS
    assert tuning.SWEEP_CONFIGS_BY_OP == ref_tuning.SWEEP_CONFIGS_BY_OP
    assert set(tuning._TUNE_ARGS) == set(ref_tuning._TUNE_ARGS)
    for shape in ((3, 130), (512, 8192), (1, 1), (100, 300, 50), (49155,)):
        assert tuning.bucket_key(shape) == ref_tuning.bucket_key(shape)


@pytest.mark.parametrize("op", sorted(ref_tuning._TUNE_ARGS))
def test_tuning_operands_equal_the_reference(op):
    """Each builder gives the reference's operands from the same stream."""
    dims = (3, 5, 4) if op == "matmul" else (4, 6)
    r_args, r_kw = ref_tuning._TUNE_ARGS[op](np.random.default_rng(0), dims)
    p_args, p_kw = tuning._TUNE_ARGS[op](np.random.default_rng(0), dims,
                                         torch.device("cpu"))
    assert r_kw == p_kw
    flat = lambda xs: [t for x in xs for t in (  # noqa: E731
        (x.hi, x.lo) if hasattr(x, "lo") else (x,))]
    for r, p in zip(flat(r_args), flat(p_args)):
        assert _same(r, p.numpy())


@pytest.fixture
def tune_cache(tmp_path, monkeypatch):
    """An isolated table and sidecar, restored afterwards."""
    path = str(tmp_path / "FF_TUNE_torch.json")
    monkeypatch.setenv(tuning.CACHE_ENV, path)
    tuning.clear()
    yield path
    tuning.clear()


SHAPE = (32, 256, 32)


def _tune_mm(**kw):
    return port_ff.tune("matmul", shapes=[SHAPE], reps=1, device="cpu",
                        impls=("hybrid", "compensated", "ozaki"), **kw)


def test_tune_roundtrips_through_cache(tune_cache, monkeypatch):
    out = _tune_mm()
    assert out["cache"] == tune_cache and os.path.exists(tune_cache)
    key = tuning.bucket_key(SHAPE)
    rec = out["table"][key]
    assert rec["fast"]["impl"] in ("hybrid", "compensated", "ozaki")
    assert rec["accurate"]["impl"] == "ozaki"
    assert rec["fast"]["us"] == min(v["us"] for v in rec["impls"].values())

    def boom(*a, **k):
        raise AssertionError("tune() re-timed a cached bucket")

    monkeypatch.setattr(tuning, "_time_candidates", boom)
    assert _tune_mm()["table"][key]["fast"] == rec["fast"]
    tuning.clear()                              # a cold process
    assert tuning.lookup_impl("matmul", SHAPE, device="cpu") \
        == rec["fast"]["impl"]
    with pytest.raises(AssertionError, match="re-timed"):
        _tune_mm(force=True)
    with open(tune_cache) as f:
        meta = json.load(f)["meta"]
    assert meta["device"] == "cpu" and meta["torch"] == torch.__version__
    assert "cpu/matmul" in json.load(open(tune_cache))["table"]


def test_resolution_consults_tuned_table(tune_cache):
    _tune_mm()
    rec = tuning.lookup("matmul", SHAPE, device="cpu")
    res = port_dispatch.resolve_name
    assert res("matmul", None, "cpu", SHAPE) == rec["impl"]
    assert res("matmul", None, "cpu", (8, 8, 8)) == res("matmul")
    # the table is per device: the card's bucket is untuned
    assert res("matmul", None, "cuda", SHAPE) == "hybrid"
    assert res("matmul", "tuned", "cpu", SHAPE) == rec["impl"]
    acc = tuning.lookup("matmul", SHAPE, "accurate", device="cpu")
    assert res("matmul", "tuned_accurate", "cpu", SHAPE) == acc["impl"]
    with port_ff.use(matmul="tuned_accurate"):
        assert res("matmul", None, "cpu", SHAPE) == acc["impl"]
    assert res("matmul", "dot2", "cpu", SHAPE) == "dot2"
    assert res("matmul", "tuned_accurate", "cpu", (8, 8, 8)) == "f64"
    assert port_dispatch.resolve_opts("matmul", rec["impl"], SHAPE,
                                      "cpu") == rec["opts"]
    key = ("matmul", rec["impl"], "tuned_default", "cpu",
           tuning.bucket_key(SHAPE))
    n0 = port_dispatch.RESOLUTIONS[key]
    a = torch.randn(SHAPE[:2])
    b = torch.randn(SHAPE[1:])
    got = port_ff.matmul(a, b)                  # the tuned default
    want = port_ff.matmul(a, b, impl=rec["impl"], **rec["opts"])
    assert port_dispatch.RESOLUTIONS[key] == n0 + 1
    assert torch.equal(got.hi, want.hi) and torch.equal(got.lo, want.lo)


def test_stale_sidecar_never_breaks_dispatch(tune_cache):
    key = tuning.bucket_key(SHAPE)
    payload = {"meta": {"device": "cpu", "format": 1}, "table": {
        "cpu/matmul": {key: {
            "fast": {"impl": "gone_impl", "opts": {}, "us": 1.0},
            "accurate": {"impl": "gone_impl", "opts": {}, "us": 1.0},
            "impls": {}}}}}
    with open(tune_cache, "w") as f:
        json.dump(payload, f)
    tuning.clear()
    res = port_dispatch.resolve_name
    assert res("matmul", None, "cpu", SHAPE) == res("matmul")
    assert res("matmul", "tuned", "cpu", SHAPE) == res("matmul")
    assert res("matmul", "tuned_accurate", "cpu", SHAPE) == "f64"
    with open(tune_cache, "w") as f:
        f.write("{not json")
    tuning.clear()
    with pytest.warns(port_ff.FFTuneWarning, match="unreadable"):
        assert res("matmul", None, "cpu", SHAPE) == res("matmul")


def test_tune_elementwise_and_math_families(tune_cache):
    shape = (16, 128)
    key = tuning.bucket_key(shape)
    out = port_ff.tune("add", shapes=[shape], reps=1, device="cpu")
    rec = out["table"][key]
    assert set(rec["impls"]) == {"jnp", "accurate"}   # no kernel off card
    assert rec["accurate"]["impl"] == "accurate"
    assert port_dispatch.resolve_name("add", None, "cpu", shape) \
        == rec["fast"]["impl"]
    out = port_ff.tune("silu", shapes=[shape], reps=1, device="cpu",
                       impls=("jnp", "pallas", "f64", "fast"))
    rec = out["table"][key]
    assert set(rec["impls"]) == {"jnp", "pallas", "f64", "fast"}
    assert rec["fast"]["impl"] != "fast"        # never crowned
    assert rec["impls"]["pallas"]["opts"]["block"] in (
        (64, 512), (128, 512), (256, 512))
    rng = np.random.default_rng(139)
    x = PFF(T(rng.standard_normal(shape).astype(np.float32)),
            torch.zeros(shape))
    name = rec["fast"]["impl"]
    want = port_ff.silu(x, impl=name)
    got = port_ff.silu(x)                       # tuned default, tuned opts
    assert torch.equal(got.hi, want.hi) and torch.equal(got.lo, want.lo)
    assert port_dispatch.RESOLUTIONS[("silu", name, "tuned_default", "cpu",
                                      key)] >= 1


def test_fast_winner_respects_bit_contract(tune_cache):
    out = port_ff.tune("sum", shapes=[(32, 256)], reps=1, device="cpu",
                       impls=("blocked", "cascade"))
    assert out["table"]["32x256"]["fast"]["impl"] == "blocked"
    assert "cascade" in out["table"]["32x256"]["impls"]
    out = port_ff.tune("sum", shapes=[(64, 128)], reps=1, device="cpu",
                       impls=("cascade",))
    rec = out["table"]["64x128"]
    assert "fast" not in rec and "cascade" in rec["impls"]
    assert port_dispatch.resolve_name("sum", None, "cpu", (64, 128)) \
        == "blocked"


def test_elementwise_buckets_hit_from_nd_shapes(tune_cache):
    from repro_torch.ff.autodiff import bucket2d
    assert bucket2d((2, 16, 256)) == (32, 256)
    assert bucket2d((256,)) == (1, 256)
    assert bucket2d(()) == (1, 1)
    out = port_ff.tune("exp", shapes=[(32, 256)], reps=1, device="cpu",
                       impls=("jnp", "f64"))
    winner = out["table"]["32x256"]["fast"]["impl"]
    x = torch.randn(2, 16, 256) * 0.1
    n0 = port_dispatch.RESOLUTIONS[("exp", winner, "tuned_default", "cpu",
                                    "32x256")]
    got = port_ff.exp(x)
    assert port_dispatch.RESOLUTIONS[("exp", winner, "tuned_default", "cpu",
                                      "32x256")] == n0 + 1
    want = port_ff.exp(x, impl=winner)
    assert torch.equal(got.hi, want.hi) and torch.equal(got.lo, want.lo)


def test_sum_tuned_rowsum_winner_never_breaks_other_axes(tune_cache):
    payload = {"meta": {"device": "cpu", "format": 1}, "table": {
        "cpu/sum": {"32x256": {
            "fast": {"impl": "pallas_rowsum", "opts": {}, "us": 1.0},
            "impls": {"pallas_rowsum": {"opts": {}, "us": 1.0}}}}}}
    with open(tune_cache, "w") as f:
        json.dump(payload, f)
    tuning.clear()
    x = torch.randn(32, 256)
    assert port_dispatch.resolve_name("sum", None, "cpu", (32, 256)) \
        == "pallas_rowsum"
    for axis in (None, 0, -1, (0, 1)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            got = port_ff.sum(x, axis=axis)
        want = x.double().sum(dim=axis) if axis is not None \
            else x.double().sum()
        np.testing.assert_allclose(got.hi.double() + got.lo.double(), want,
                                   rtol=1e-7)


def test_tune_unknown_op_raises_and_needs_a_card_by_default(monkeypatch):
    with pytest.raises(NotImplementedError, match="operand builder"):
        port_ff.tune("not_an_op", shapes=[(8, 8)])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_ff.tune("add", shapes=[(8, 8)])


def test_lookup_opts_detuples_json_lists(tune_cache):
    payload = {"meta": {"device": "cpu", "format": 1}, "table": {
        "cpu/add": {"32x256": {
            "fast": {"impl": "pallas", "opts": {"block": [256, 512]},
                     "us": 1.0},
            "impls": {"pallas": {"opts": {"block": [256, 512]},
                                 "us": 1.0}}}}}}
    with open(tune_cache, "w") as f:
        json.dump(payload, f)
    tuning.clear()
    assert tuning.lookup_opts("add", "pallas", (32, 256), "cpu") == {
        "block": (256, 512)}
    x = PFF(torch.randn(32, 256), torch.zeros(32, 256))
    got = port_ff.add(x, x)             # resolves to the tuned pallas row
    want = port_ff.add(x, x, impl="jnp")
    assert torch.equal(got.hi, want.hi) and torch.equal(got.lo, want.lo)


def test_sidecar_is_the_ports_own(monkeypatch):
    monkeypatch.delenv(tuning.CACHE_ENV, raising=False)
    path = tuning.default_cache_path()
    assert os.path.basename(path) == "FF_TUNE_torch.json"
    assert path != ref_tuning.default_cache_path()
