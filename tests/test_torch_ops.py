"""The paper's operators in the port against the reference: the
elementwise kernel (Add22, Mul22, Div22, Sqrt22, TwoSum, TwoProd), the
compensated row sum, and their dispatch.

  * ``elementwise_plain`` (the CUDA kernel's plain version) is bitwise the
    reference's Pallas kernel in interpret mode, for all six ops, under
    every broadcast form (full, row, column, scalar, a rank-mismatched
    operand, one plane used twice) and at the ragged (3, 130);
  * ``ff_rowsum_plain`` is bitwise the interpret-mode ``ff_rowsum`` and
    ``ref_ff_rowsum`` at C < 128 (the clamped lane count), ragged and
    multi-block widths, and within 2^-44 of sum |x| of the exactly
    rounded sum (``math.fsum``);
  * the registry's names and defaults are the reference's for these ops,
    the public calls are bitwise the reference's jnp impls, and
    ``pallas_rowsum`` on a non-last axis warns and equals ``blocked``.

Inputs come from a local numpy seed with normal-range limbs; the CUDA
kernels run only on the card (``chip_smoke.py`` holds them to these
plain versions bit for bit).
"""

import math
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ff as ref_ff
import repro_torch.ff as port_ff
from repro.ff import dispatch as ref_dispatch
from repro.kernels import ff_elementwise as ref_ew
from repro.kernels import ff_reduce as ref_reduce
from repro.kernels import ref as ref_ref
from repro_torch.core.ff import FF as PFF
from repro_torch.ff import dispatch as port_dispatch
from repro_torch.kernels import ff_elementwise as port_ew
from repro_torch.kernels import ff_reduce as port_reduce
from repro_torch.kernels import ref as port_ref

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


def _pair(rng, shape, positive=False):
    h = rng.standard_normal(shape).astype(np.float32)
    if positive:
        h = np.abs(h) + 0.5
    lo = (h * 1e-8 * rng.standard_normal(shape)).astype(np.float32)
    return h, lo


# -- elementwise: the plain version against the interpret-mode kernel ---------

R, C = 3, 130
# (first operand's shape, second operand's shape) per broadcast form
FORMS = {"full": ((R, C), (R, C)), "row": ((R, C), (1, C)),
         "col": ((R, C), (R, 1)), "scalar": ((R, C), ()),
         "rank": ((2, 3, C), (3, C)),        # a (3, C) against (2, 3, C)
         "bcast3": ((2, 3, C), (2, 1, C)),   # a middle-axis broadcast
         "alias": ((R, C), None)}            # one plane used twice
BINARY = ("add22", "mul22", "div22")


def _ew_operands(op, form, rng):
    ashape, bshape = FORMS[form]
    positive = op in ("div22", "sqrt22")
    ah, al = _pair(rng, ashape, positive)
    bh, bl = (ah, al) if bshape is None else _pair(rng, bshape, positive)
    if op in BINARY:
        return ah, al, bh, bl
    if op == "sqrt22":
        return ah, al
    return ah, bh                        # two_sum / two_prod: f32 operands


CASES = [(op, form) for op in port_ew.EW_OPS for form in FORMS
         if op != "sqrt22" or form in ("full", "rank")]


@pytest.mark.parametrize("op,form", CASES,
                         ids=[f"{o}-{f}" for o, f in CASES])
def test_elementwise_plain_matches_reference_kernel(op, form):
    rng = np.random.default_rng(7)
    ops = _ew_operands(op, form, rng)
    rh, rl = ref_ew.elementwise(op, *(jnp.asarray(x) for x in ops),
                                interpret=True)
    ph, pl = port_ew.elementwise_plain(op, *(T(x) for x in ops))
    assert _same(rh, ph) and _same(rl, pl)
    # the wrapper takes the plain version on the CPU and launches nothing
    n0 = port_ew.elementwise.launches
    wh, wl = port_ew.elementwise(op, *(T(x) for x in ops))
    assert _same(wh, ph) and _same(wl, pl)
    assert port_ew.elementwise.launches == n0


def test_elementwise_two_prod_outside_the_fma_domain():
    """TwoProd is Dekker's split, as the reference kernel's: where the split
    overflows (|a| > 2^115) the FMA form would give other bits, the plain
    version gives the reference kernel's."""
    a = np.array([[3.0e37, 1.5, -2.0e36]], np.float32)
    b = np.array([[1.0e-30, 3.25, 7.0e-31]], np.float32)
    rh, rl = ref_ew.elementwise("two_prod", jnp.asarray(a), jnp.asarray(b),
                                interpret=True)
    ph, pl = port_ew.elementwise_plain("two_prod", T(a), T(b))
    assert _same(rh, ph) and _same(rl, pl)


@pytest.mark.parametrize("shape,block,want", [
    ((3, 130), (256, 512), (8, 256)), ((4096, 4096), (256, 512), (256, 512)),
    ((1, 1), (128, 512), (8, 128)), ((100, 700), (64, 100), (64, 128))])
def test_pick_block_matches_reference(shape, block, want):
    assert port_ew.pick_block(*shape, block) == want
    assert ref_ew.pick_block(*shape, block) == want
    assert port_ew.DEFAULT_BLOCK == ref_ew.DEFAULT_BLOCK


def test_elementwise_rejects_wrong_plane_counts_and_ops():
    x = torch.ones(2, 3)
    with pytest.raises(ValueError, match="takes 4 planes"):
        port_ew.elementwise("add22", x, x)
    with pytest.raises(KeyError, match="ops"):
        port_ew.elementwise("fma22", x, x)
    with pytest.raises(RuntimeError, match="no kernel"):
        port_ew.elementwise("two_sum", torch.empty(2, device="meta"),
                            torch.empty(2, device="meta"))


# -- ff_rowsum: the plain version against the interpret-mode kernel ------------

ROWSUM = [((3, 64), {}), ((5, 300), {}), ((4, 1100), {}), ((2, 128), {}),
          ((3, 200), {"lane": 64}), ((4, 700), {"bc": 256}),
          ((2, 90), {"bc": 32, "lane": 16}), ((1, 1), {})]


@pytest.mark.parametrize("shape,kw", ROWSUM,
                         ids=[f"{s[0]}x{s[1]}-{k}" for s, k in ROWSUM])
def test_rowsum_plain_matches_reference_kernel(shape, kw):
    rng = np.random.default_rng(11)
    x = (rng.standard_normal(shape)
         * 10.0 ** rng.uniform(-4, 4, shape)).astype(np.float32)
    rh, rl = ref_reduce.ff_rowsum(jnp.asarray(x), interpret=True, **kw)
    ph, pl = port_reduce.ff_rowsum_plain(T(x), **kw)
    assert _same(rh, ph) and _same(rl, pl)
    lane = port_reduce.lanes_for(shape[1], kw.get("bc", 512),
                                 kw.get("lane", 128))
    oh, ol = ref_ref.ref_ff_rowsum(jnp.asarray(x), lane=lane)
    assert _same(oh, ph) and _same(ol, pl)
    qh, ql = port_ref.ref_ff_rowsum(T(x), lane=lane)
    assert _same(qh, ph) and _same(ql, pl)
    got = ph.numpy().astype(np.float64) + pl.numpy().astype(np.float64)
    for r in range(shape[0]):
        exact = math.fsum(x[r].astype(np.float64))
        mag = float(np.abs(x[r].astype(np.float64)).sum())
        assert abs(got[r] - exact) <= 2.0 ** -44 * mag, r


def test_rowsum_lane_count_is_clamped_to_the_row():
    """A row shorter than 128 has C lanes, not 128, as in the reference."""
    assert port_reduce.lanes_for(64) == 64
    assert port_reduce.lanes_for(300) == 128
    assert port_reduce.lanes_for(300, bc=96) == 96
    assert port_reduce.lanes_for(1000, lane=256) == 256


def test_rowsum_negative_zero_rows_sum_to_plus_zero():
    """The cascade starts from +0, so a row of -0.0 sums to +0.0 on both
    (the reference's zero padding adds nothing beyond that)."""
    x = np.full((2, 200), -0.0, np.float32)
    rh, rl = ref_reduce.ff_rowsum(jnp.asarray(x), interpret=True)
    ph, pl = port_reduce.ff_rowsum_plain(T(x))
    assert _same(rh, ph) and _same(rl, pl)
    assert not np.signbit(ph.numpy()).any()


# -- dispatch ------------------------------------------------------------------

EW_OPS = ("add", "mul", "div", "sqrt", "two_sum", "two_prod", "sum")


@pytest.mark.parametrize("op", EW_OPS)
def test_registry_names_and_defaults_match_reference(op):
    ref_names = tuple(n for n in ref_dispatch.impls(op)
                      if not n.startswith("sharded"))
    assert port_dispatch.impls(op) == ref_names
    assert port_dispatch._DEFAULTS[op] == ref_dispatch._DEFAULTS[op]
    assert port_dispatch.resolve_name(op, device="cuda") \
        == port_dispatch.resolve_name(op, device="cpu") \
        == ref_dispatch._DEFAULTS[op]["*"]


def _ff_both(rng, shape, positive=False):
    h, lo = _pair(rng, shape, positive)
    return (ref_ff.FF(jnp.asarray(h), jnp.asarray(lo)), PFF(T(h), T(lo)))


@pytest.mark.parametrize("op", ["add", "sub", "mul", "div", "sqrt"])
@pytest.mark.parametrize("impl", ["jnp", "pallas"])
def test_public_calls_match_reference(op, impl):
    """ff.add/sub/mul/div/sqrt on FF operands (and an FF with an f32
    operand) are bitwise the reference's jnp impl, through either port
    impl (the pallas tier's plain version on the CPU)."""
    rng = np.random.default_rng(13)
    ra, pa = _ff_both(rng, (4, 33), positive=True)
    rb, pb = _ff_both(rng, (1, 33), positive=True)
    if op == "sqrt":
        want = ref_ff.sqrt(ra, impl="jnp")
        got = port_ff.sqrt(pa, impl=impl)
    else:
        want = getattr(ref_ff, op)(ra, rb, impl="jnp")
        got = getattr(port_ff, op)(pa, pb, impl=impl)
    assert _same(want.hi, got.hi) and _same(want.lo, got.lo)
    if op in ("add", "mul") and impl == "jnp":     # FF with f32: x12 forms
        f = rng.standard_normal((4, 33)).astype(np.float32)
        want = getattr(ref_ff, op)(ra, jnp.asarray(f), impl="jnp")
        got = getattr(port_ff, op)(pa, T(f), impl=impl)
        assert _same(want.hi, got.hi) and _same(want.lo, got.lo)


@pytest.mark.parametrize("op", ["two_sum", "two_prod"])
def test_eft_calls_match_reference(op):
    rng = np.random.default_rng(17)
    a = rng.standard_normal((5, 40)).astype(np.float32)
    b = (rng.standard_normal((5, 40)) * 1e3).astype(np.float32)
    want = getattr(ref_ff, op)(jnp.asarray(a), jnp.asarray(b), impl="jnp")
    for impl in ("jnp", "pallas"):
        got = getattr(port_ff, op)(T(a), T(b), impl=impl)
        assert _same(want.hi, got.hi) and _same(want.lo, got.lo), impl


def test_div_sqrt_eft_gradients_match_reference():
    """The calls that refused a gradient give the reference's: div(x, x),
    sqrt(x), two_sum(x, x) and two_prod(x, x) at x = 1 + i/4 on both
    tiers, the hi limb as the loss (bitwise; the gradients of one operand
    used twice add up).  ``tests/test_torch_grad.py`` covers every operand
    form."""
    import jax
    x = (1.0 + np.arange(3) / 4.0).astype(np.float32)
    calls = {"div": lambda f, i: lambda t: f.div(t, t, impl=i),
             "sqrt": lambda f, i: lambda t: f.sqrt(t, impl=i),
             "two_sum": lambda f, i: lambda t: f.two_sum(t, t, impl=i),
             "two_prod": lambda f, i: lambda t: f.two_prod(t, t, impl=i)}
    for name, call in calls.items():
        want = jax.grad(lambda t: jnp.sum(call(ref_ff, "jnp")(t).hi))(
            jnp.asarray(x))
        for impl in ("jnp", "pallas"):
            t = T(x.copy()).requires_grad_()
            call(port_ff, impl)(t).hi.sum().backward()
            assert _same(want, t.grad), (name, impl)


@pytest.mark.parametrize("impl", ["cascade", "pallas_rowsum", "blocked"])
def test_sum_impls_match_reference(impl):
    """ff.sum's three tiers are bitwise the reference's on a 3-D input's
    last axis (pallas_rowsum flattens to (prod(leading), last))."""
    rng = np.random.default_rng(19)
    x = (rng.standard_normal((2, 3, 300))
         * 10.0 ** rng.uniform(-3, 3, (2, 3, 300))).astype(np.float32)
    kw = {"interpret": True} if impl == "pallas_rowsum" else {}
    want = ref_ff.sum(jnp.asarray(x), axis=-1, impl=impl, **kw)
    got = port_ff.sum(T(x), axis=-1, impl=impl)
    assert got.hi.shape == (2, 3)
    assert _same(want.hi, got.hi) and _same(want.lo, got.lo)
    if impl == "cascade":
        want = ref_ff.sum(jnp.asarray(x), axis=(0, 2), impl=impl)
        got = port_ff.sum(T(x), axis=(0, 2), impl=impl)
        assert _same(want.hi, got.hi) and _same(want.lo, got.lo)


@pytest.mark.parametrize("axis", [None, 0, (0, 1)])
def test_pallas_rowsum_on_other_axes_warns_and_equals_blocked(axis):
    rng = np.random.default_rng(23)
    x = T(rng.standard_normal((6, 40)).astype(np.float32))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        got = port_ff.sum(x, axis=axis, impl="pallas_rowsum")
    assert len(rec) == 1 and "falling back" in str(rec[0].message)
    want = port_ff.sum(x, axis=axis, impl="blocked")
    assert _same(got.hi, want.hi) and _same(got.lo, want.lo)
