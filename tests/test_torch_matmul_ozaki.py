"""The Ozaki FF matmul's fp16 integer form (``kernels.ff_matmul.
ozaki_operands``, the operands of ``csrc/ff_matmul_ozaki.cu``) on the CPU.

  * The operands: every slice of ``extract_slices`` written as integers
    ``q = w 2^-g``, ``|q| <= 2^(beta-1)``, exact in fp16, ``q 2^g`` the
    slice bit for bit, for beta 7-12 and 3-5 slices on normal,
    power-of-two, zero-row, spread and ragged inputs; each K-block padded
    to a multiple of the kernel's K tile with zeros and no block added.
  * The kernel's arithmetic, emulated exactly: fp16 ``q``, integer block
    sums in float64 (exact), each scaled by ``2^(ga + gb)`` as the kernel's
    two halved powers, folded with ``fold_block_products`` in table order.
    It equals ``ozaki_accumulate_plain`` bit for bit, and with the residual
    fold the reference's ``ff_matmul_ozaki`` in interpret mode on integer
    operands.  Budget-edge block sums are exact.
  * The kernel's constants, parsed from its source, equal the wrapper's.

The kernel itself runs only on the card: ``chip_smoke.py`` holds it bit
for bit to ``ff_matmul_ozaki_plain`` there.  Inputs come from local numpy
generators.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ff_matmul as ref_kernels
from repro_torch.core import ffmatmul as port_mm
from repro_torch.kernels import build
from repro_torch.kernels import ff_matmul as km
from repro_torch.kernels.ref import fold_block_products


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32, copy=True))


def _inputs(kind: str, shape, seed: int, rows: bool = True) -> np.ndarray:
    """Normal, powers of two, with zero rows/columns, rows (``rows``, A's
    slicing axis) or columns (B's) spread over 2^+-40, or ragged magnitudes
    within a row."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if kind == "pow2":
        x = np.sign(x) * np.exp2(rng.integers(-6, 7, shape))
    elif kind == "zero_rows":
        x[::3] = 0.0
        x[:, ::4] = 0.0
    elif kind == "spread":
        x = x * np.exp2(rng.integers(-40, 41, (shape[0], 1) if rows
                                     else (1, shape[1])))
    elif kind == "ragged":
        x = x * np.exp2(rng.integers(-20, 21, shape))
    return x.astype(np.float32)


def _pow2(e: torch.Tensor) -> torch.Tensor:
    return ((e + 127) << 23).view(torch.float32)


def emulate(ops: km.OzakiOperands, pairs):
    """The kernel's arithmetic on its operands: per K-block and pair the
    integer block sum (float64, exact; asserted at most 2^24 and exact in
    f32), times 2^(e >> 1) times 2^(e - (e >> 1)), e = max(ga + gb, -252),
    in f32, folded in table order.  Where ga is in [-126, 103] and gb in
    [-126, 127] (the kernel's two-factor path), (S 2^ga) 2^gb is asserted
    to be the same value."""
    n, M, Kp = ops.qa.shape
    N = ops.gb.shape[1]

    def products():
        for kb in range(-(-ops.K // ops.bk)):
            k0, L = kb * ops.bkp, min(ops.bk, ops.K - kb * ops.bk)
            for i, j in pairs:
                S = (ops.qa[i, :, k0:k0 + L].double()
                     @ ops.qb[j, :, k0:k0 + L].double().T)
                assert bool((S.abs() <= 2.0 ** 24).all())
                S32 = S.float()
                assert torch.equal(S32.double(), S)
                ga, gb = ops.ga[i][:, None], ops.gb[j][None, :]
                e = (ga + gb).clamp(min=-252)
                h = e >> 1
                p = S32 * _pow2(h) * _pow2(e - h)
                two = ((ga >= -126) & (ga <= 103)) & ((gb >= -126)
                                                       & (gb <= 127))
                fast = S32 * _pow2(ga.clamp(-126, 127)) * _pow2(
                    gb.clamp(-126, 127))
                assert torch.equal(torch.where(two, fast, p), p)
                yield p

    return fold_block_products(products(), M, N, ops.qa.device)


def _operands(A, B, slices=0, beta=0, bk=512):
    a, b, n, beta, bk, pairs = km._ozaki_setup(_t(A), _t(B), slices, beta,
                                               bk)
    return a, b, n, beta, bk, pairs, km.ozaki_operands(a, b, n, beta, bk)


# ---------------------------------------------------------------------------
# the operands
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["normal", "pow2", "zero_rows", "spread",
                                  "ragged"])
@pytest.mark.parametrize("beta", [7, 8, 9, 10, 11, 12])
@pytest.mark.parametrize("n", [3, 4, 5])
def test_operands_are_exact_fp16_integers_of_the_slices(kind, beta, n):
    M, K, N = 13, 70, 11
    A = _inputs(kind, (M, K), 100 + beta)
    B = _inputs(kind, (K, N), 200 + n, rows=False)
    a, b = _t(A), _t(B)
    ops = km.ozaki_operands(a, b, n, beta, 64)
    pa, ra = port_mm.extract_slices(a, 1, n, beta)
    pb, rb = port_mm.extract_slices(b, 0, n, beta)
    assert torch.equal(ops.ra, ra) and torch.equal(ops.rb, rb)
    assert ops.qa.dtype == ops.qb.dtype == torch.float16
    assert ops.ga.dtype == ops.gb.dtype == torch.int32
    assert ops.ga.shape == (n, M) and ops.gb.shape == (n, N)
    # K = 70 in blocks of 64: [0, 64) at 0, [64, 70) at 64, padded to 72;
    # both K-major (B's slices transposed)
    assert ops.qa.shape == (n, M, 72) and ops.qb.shape == (n, N, 72)
    qa = ops.qa[:, :, :K].double()
    qb = ops.qb[:, :, :K].double().transpose(1, 2)
    for q in (qa, qb):
        assert torch.equal(q, q.round())
        assert float(q.abs().max()) <= 2.0 ** (beta - 1)
    for i in range(n):
        wa = qa[i] * torch.exp2(ops.ga[i].double())[:, None]
        wb = qb[i] * torch.exp2(ops.gb[i].double())[None, :]
        assert torch.equal(wa, pa[i].double())
        assert torch.equal(wb, pb[i].double())
        # g from the exact exponent: ie + 1 - beta (i + 1)
        ie = port_mm.slice_exponent(a, 1)[:, 0]
        assert torch.equal(ops.ga[i], ie + 1 - beta * (i + 1))


@pytest.mark.parametrize("K,bk", [(1000, 300), (513, 512), (70, 64),
                                  (2048, 512), (16, 16), (1, 1)])
def test_layout_pads_each_block_with_zeros_and_adds_no_block(K, bk):
    rng = np.random.default_rng(K + bk)
    A = rng.standard_normal((5, K)).astype(np.float32)
    B = rng.standard_normal((K, 3)).astype(np.float32)
    a, b = _t(A), _t(B)
    ops = km.ozaki_operands(a, b, 3, 8, bk)
    nkb = -(-K // bk)
    assert ops.bkp % km.OZAKI_TILE_K == 0 and ops.bkp - bk < km.OZAKI_TILE_K
    Kp = ops.qa.shape[2]
    assert Kp == ops.qb.shape[2] and Kp % 8 == 0 and ops.qb.shape[1] == 3
    last = K - (nkb - 1) * bk
    # the last block ends inside the layout, within 8 of its end: no room
    # for a block more
    assert (nkb - 1) * ops.bkp + last <= Kp < (nkb - 1) * ops.bkp + last + 8
    mask = torch.zeros(Kp, dtype=torch.bool)
    for kb in range(nkb):
        L = min(bk, K - kb * bk)
        mask[kb * ops.bkp:kb * ops.bkp + L] = True
        qa_blk = ops.qa[:, :, kb * ops.bkp:kb * ops.bkp + L]
        qb_blk = ops.qb[:, :, kb * ops.bkp:kb * ops.bkp + L].transpose(1, 2)
        pa, _ = port_mm.extract_slices(a, 1, 3, 8)
        pb, _ = port_mm.extract_slices(b, 0, 3, 8)
        for i in range(3):
            wa = qa_blk[i].double() * torch.exp2(ops.ga[i].double())[:, None]
            wb = qb_blk[i].double() * torch.exp2(ops.gb[i].double())[None, :]
            assert torch.equal(wa, pa[i][:, kb * bk:kb * bk + L].double())
            assert torch.equal(wb, pb[i][kb * bk:kb * bk + L].double())
    assert not ops.qa[:, :, ~mask].any() and not ops.qb[:, :, ~mask].any()


def test_operands_take_beta_up_to_the_fp16_bound():
    a, b = _t(np.ones((2, 4))), _t(np.ones((4, 2)))
    km.ozaki_operands(a, b, 3, km.OZAKI_MAX_BETA, 4)
    with pytest.raises(ValueError, match="beta"):
        km.ozaki_operands(a, b, 3, km.OZAKI_MAX_BETA + 1, 4)
    # every beta ozaki_params admits is within the bound
    for K in (1, 2, 3, 5, 16, 64, 100, 4096):
        assert port_mm.ozaki_params(K)[1] <= km.OZAKI_MAX_BETA


# ---------------------------------------------------------------------------
# the kernel's arithmetic, emulated
# ---------------------------------------------------------------------------

CASES = [  # (M, K, N), slices, bk, input kind
    ((8, 16, 8), 0, 512, "normal"), ((100, 300, 50), 0, 512, "normal"),
    ((257, 513, 129), 0, 512, "normal"), ((1, 2048, 1), 0, 512, "normal"),
    ((64, 1100, 8), 0, 512, "normal"), ((17, 100, 5), 0, 512, "normal"),
    ((20, 1000, 30), 0, 300, "normal"), ((9, 64, 7), 5, 512, "normal"),
    ((20, 100, 10), 9, 512, "normal"),
    ((12, 16, 10), 0, 512, "normal"), ((6, 2, 5), 0, 512, "normal"),
    ((30, 200, 20), 0, 512, "spread"), ((30, 200, 20), 0, 512, "zero_rows"),
    ((30, 600, 20), 0, 512, "ragged"), ((30, 600, 20), 0, 512, "pow2"),
]


@pytest.mark.parametrize("mkn,slices,bk,kind", CASES)
def test_integer_form_equals_plain_accumulation(mkn, slices, bk, kind):
    M, K, N = mkn
    A = _inputs(kind, (M, K), K + 1)
    B = _inputs(kind, (K, N), N + 2, rows=False)
    a, b, n, beta, bk, pairs, ops = _operands(A, B, slices, 0, bk)
    pa, _ = port_mm.extract_slices(a, 1, n, beta)
    pb, _ = port_mm.extract_slices(b, 0, n, beta)
    want = km.ozaki_accumulate_plain(torch.stack(pa), torch.stack(pb), pairs,
                                     bk)
    got = emulate(ops, pairs)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("mkn", [(8, 16, 8), (100, 300, 50), (257, 513, 129),
                                 (1, 2048, 1), (64, 1100, 8), (17, 100, 5)])
def test_integer_form_equals_reference_kernel_on_integers(mkn):
    M, K, N = mkn
    rng = np.random.default_rng(300 + K)
    A = rng.integers(-8, 9, (M, K)).astype(np.float32)
    B = rng.integers(-8, 9, (K, N)).astype(np.float32)
    want = ref_kernels.ff_matmul_ozaki(jnp.asarray(A), jnp.asarray(B),
                                       interpret=True)
    a, b, n, beta, bk, pairs, ops = _operands(A, B)
    oh, ol = emulate(ops, pairs)
    got = km._residual_fold(a, b, ops.ra, ops.rb, oh, ol)
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("K,beta", [(512, 8), (1024, 8), (100, 9), (64, 10),
                                    (16, 11), (2, 12)])
@pytest.mark.parametrize("signs", ["same", "alternating"])
def test_budget_edge_block_sums_are_exact(K, beta, signs):
    """Every |q| = 2^(beta-1): ones (and -1 where the signs alternate, so
    that every product is still positive) give each block sum bk 2^(2 beta
    - 2) exactly, the integer form's bound 2^(2 beta - 2 + t) where bk is
    2^t, and the plain version's bits."""
    M, N = 4, 3
    A = np.ones((M, K), np.float32)
    B = np.ones((K, N), np.float32)
    if signs == "alternating":
        A[:, 1::2] = -1.0
        B[1::2, :] = -1.0
    a, b, n, beta_, bk, pairs, ops = _operands(A, B)
    assert beta_ == beta
    t = int(np.ceil(np.log2(max(bk, 2))))
    assert float(ops.qa[0].abs().max()) == 2.0 ** (beta - 1)
    S = ops.qa[0, :, :bk].double() @ ops.qb[0, :, :bk].double().T
    assert torch.equal(S, torch.full_like(S, bk * 2.0 ** (2 * beta - 2)))
    assert float(S.max()) <= 2.0 ** (2 * beta - 2 + t) <= 2.0 ** 24
    if bk == 2 ** t:
        assert float(S.max()) == 2.0 ** (2 * beta - 2 + t)
    pa, _ = port_mm.extract_slices(a, 1, n, beta)
    pb, _ = port_mm.extract_slices(b, 0, n, beta)
    want = km.ozaki_accumulate_plain(torch.stack(pa), torch.stack(pb), pairs,
                                     bk)
    got = emulate(ops, pairs)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[0].double() + got[1].double(),
                       torch.full((M, N), float(K), dtype=torch.float64))


def test_scaling_keeps_products_whose_factors_leave_the_normal_range():
    """Rows near 2^60 against columns near 2^-100: the last slice of B has
    2^gb below the normal range (the kernel's two-factor path is off for
    it, its slices are not flushed); the halved powers of 2^(ga + gb) keep
    the exact, normal products."""
    rng = np.random.default_rng(7)
    A = (rng.standard_normal((6, 40)) * 2.0 ** 60).astype(np.float32)
    B = (rng.standard_normal((40, 5)) * 2.0 ** -100).astype(np.float32)
    a, b, n, beta, bk, pairs, ops = _operands(A, B)
    assert int(ops.gb.min()) < -126 and int(ops.gb.max()) > -126
    pa, _ = port_mm.extract_slices(a, 1, n, beta)
    pb, _ = port_mm.extract_slices(b, 0, n, beta)
    want = km.ozaki_accumulate_plain(torch.stack(pa), torch.stack(pb), pairs,
                                     bk)
    got = emulate(ops, pairs)
    assert torch.isfinite(got[0]).all()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---------------------------------------------------------------------------
# the wrapper and the source
# ---------------------------------------------------------------------------

def test_kernel_constants_match_the_source():
    src = (build.CSRC / "ff_matmul_ozaki.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kMaxPairs") == km.OZAKI_MAX_PAIRS
    assert const("kMaxBeta") == km.OZAKI_MAX_BETA
    assert const("kTileK") == km.OZAKI_TILE_K
    assert const("kTileN") == km.OZAKI_TILE_N
    assert "ff_matmul_ozaki" in build.SOURCES
    # the SIMT route is gone from the hybrid's source
    hybrid = (build.CSRC / "ff_matmul.cu").read_text()
    assert "ff_matmul_ozaki_f32" not in hybrid and "PairTable" not in hybrid


def test_accumulate_raises_off_the_card():
    A = np.ones((3, 8), np.float32)
    a, b, n, beta, bk, pairs, ops = _operands(A, A.T.copy())
    before = km.ff_matmul_ozaki.launches
    with pytest.raises(RuntimeError, match="no kernel"):
        km.ozaki_accumulate(ops, pairs)
    # the wrapper takes the plain version on CPU tensors, launching nothing
    got = km.ff_matmul_ozaki(a, b)
    want = km.ff_matmul_ozaki_plain(a, b)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert km.ff_matmul_ozaki.launches == before
