"""The FF attention kernel's design arguments, on the CPU.

``csrc/ff_attention.cu`` skips the causal / Skv-edge K/V tiles and
sub-tiles that a warp's rows cannot see, computes a bf16 score product as
one multiply, and its wrapper picks the tiles and the grid on the host
(``attention_plan``).  The kernel runs only on the card (``chip_smoke.py``
holds it to the float64 oracle there); these tests hold its arguments:

  * the tile-skip identity on the port's plain EFTs and the reference's:
    TwoSum(m, -m) = (+0, +0), exp22(+0, +0) = (1, 0), Mul22 by (1, 0) and
    Add22 of (+0, +0) return an FF value unchanged (a -0 limb as +0);
  * the bf16 product's exactness: TwoProd's low part 0 and its high part
    the float64 product for bf16 pairs whose product is normal;
  * the kernel's index arithmetic, mirrored: every pair a row can see is
    computed, in one tile and sub-tile, for every configuration;
  * the plan per shape, and its constants against the source;
  * new parity cases of the plain version against the reference's
    ``flash_attention_ff`` and its interpret-mode Pallas kernel, within
    2^-40: bf16 operands at hd 64 with G = 4, causal with q_offset > 0 and
    Sq < Skv, and a shape with wholly masked tiles.

Inputs come from ``np.random.default_rng`` with fixed seeds.
"""

import math
import re

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import ff as ref_ff
from repro.core import ffmath as ref_math
from repro.core import transforms as ref_T
from repro.kernels import ff_attention as ref_attn
from repro_torch.core import ff as port_ff
from repro_torch.core import ffmath as port_math
from repro_torch.core import transforms as port_T
from repro_torch.kernels import build
from repro_torch.kernels import ff_attention as port_attn

TOL = 2.0 ** -40
SRC = (build.CSRC / "ff_attention.cu").read_text()
BKV = 64                                  # the kernel's K/V tile


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32))


def _ff_values(n: int, seed: int):
    """Normalised FF pairs over wide exponents, with signed zeros in each
    limb and exact f32 values (lo = +-0) among them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n) * 2.0 ** rng.uniform(-60, 60, n)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    lo[::7] = 0.0
    lo[1::7] = -0.0
    hi[2::11], lo[2::11] = 0.0, 0.0
    hi[3::11], lo[3::11] = -0.0, 0.0
    hi[4::11], lo[4::11] = 0.0, -0.0
    hi[5::11], lo[5::11] = -0.0, -0.0
    return hi, lo


# -- the tile-skip identity --------------------------------------------------

def test_running_max_unchanged_gives_alpha_one():
    """A skipped tile leaves m = max(m, -1e30) = m: TwoSum(m, -m) is (+0,
    +0) and exp22 of it (1, 0), in the port's plain EFTs and the
    reference's."""
    rng = np.random.default_rng(250)
    m = np.concatenate([
        [-1e30, 0.0, 1e30, 3.5, -7.25],
        (rng.standard_normal(4000) * 2.0 ** rng.uniform(-60, 60, 4000))
    ]).astype(np.float32)
    for two_sum, exp22, conv in (
            (port_T.two_sum, port_math.exp22, _t),
            (ref_T.two_sum, ref_math.exp22, jnp.asarray)):
        sh, sl = two_sum(conv(m), conv(-m))
        assert not np.any(_bits(sh)) and not np.any(_bits(sl))
        eh, el = exp22(conv(np.zeros(3, np.float32)),
                       conv(np.zeros(3, np.float32)))
        assert np.array_equal(_bits(eh), _bits(np.ones(3)))
        assert not np.any(_bits(el))


@pytest.mark.parametrize("impl", ["port", "reference"])
def test_mul22_by_one_and_add22_of_zero_keep_the_value(impl):
    """Mul22(x, (1, 0)) and Add22(x, (+0, +0)) (and the two in turn, the
    skipped tile's den and num update) return x bit for bit where no limb
    is -0, and x's value elsewhere (a -0 limb may come back +0)."""
    hi, lo = _ff_values(6000, 251)
    one = np.ones_like(hi), np.zeros_like(hi)
    zero = np.zeros_like(hi), np.zeros_like(hi)
    if impl == "port":
        def run(op, a, b):
            r = op(port_ff.FF(_t(a[0]), _t(a[1])),
                   port_ff.FF(_t(b[0]), _t(b[1])))
            return r.hi.numpy(), r.lo.numpy()
        mul22, add22 = port_ff.mul22, port_ff.add22
    else:
        def run(op, a, b):
            r = op(ref_ff.FF(jnp.asarray(a[0]), jnp.asarray(a[1])),
                   ref_ff.FF(jnp.asarray(b[0]), jnp.asarray(b[1])))
            return np.asarray(r.hi), np.asarray(r.lo)
        mul22, add22 = ref_ff.mul22, ref_ff.add22

    def unsigned_zero(x):
        return np.where(x == 0, np.float32(0), x)

    neg_zero = np.signbit(hi) & (hi == 0) | np.signbit(lo) & (lo == 0)
    for got in (run(mul22, (hi, lo), one), run(add22, (hi, lo), zero),
                run(add22, run(mul22, (hi, lo), one), zero)):
        for g, x in zip(got, (hi, lo)):
            assert np.array_equal(_bits(unsigned_zero(g)),
                                  _bits(unsigned_zero(x)))
            assert np.array_equal(_bits(g)[~neg_zero], _bits(x)[~neg_zero])
    assert neg_zero.sum() > 100


# -- the bf16 score product ---------------------------------------------------

def _bf16(x) -> np.ndarray:
    return np.asarray(x, np.float32).astype(ml_dtypes.bfloat16).astype(
        np.float32)


@pytest.mark.parametrize("exponents", ["random", "edges"])
def test_bf16_product_is_exact(exponents):
    """A bf16 x bf16 product has at most 16 significant bits: the f32
    multiply (the kernel's score product) is the float64 product wherever
    that is normal, and TwoProd (the port's and the reference's) gives it
    with a low part of 0 wherever Dekker's split cannot overflow (|a|, |b|
    < 2^100, ``kSplitSafe``)."""
    rng = np.random.default_rng(252)
    n = 50000
    if exponents == "random":
        ea, eb = rng.uniform(-60, 60, n), rng.uniform(-60, 60, n)
    else:      # products near the normal range's ends and the bf16 extremes
        ea = rng.choice([-126.0, -63.0, -62.5, 0.0, 63.0, 63.5, 127.0], n)
        eb = np.clip(rng.choice([-1.0, 0.0, 1.0], n) - ea
                     + rng.uniform(-1, 1, n) * 60, -126, 127)
    a = _bf16(rng.choice([-1, 1], n) * rng.uniform(1, 2, n) * 2.0 ** ea)
    b = _bf16(rng.choice([-1, 1], n) * rng.uniform(1, 2, n) * 2.0 ** eb)
    # every bf16 significand pattern, times powers of two
    sig = _bf16(np.linspace(1.0, 2.0, 129)[:-1])
    a = np.concatenate([a, np.repeat(sig, 128)])
    b = np.concatenate([b, np.tile(sig, 128) * np.float32(2.0 ** -3)])
    prod = a.astype(np.float64) * b.astype(np.float64)
    normal = (np.abs(prod) >= 2.0 ** -126) & (np.abs(prod) < 2.0 ** 128)
    assert normal.sum() > 0.9 * len(a) if exponents == "random" \
        else normal.sum() > 1000
    a, b, prod = a[normal], b[normal], prod[normal]
    assert np.array_equal((a * b).astype(np.float64), prod)
    safe = np.maximum(np.abs(a), np.abs(b)) < 2.0 ** 100
    assert safe.sum() > 0.5 * len(a)
    a, b, prod = a[safe], b[safe], prod[safe]
    for hi, lo in (tuple(t.numpy() for t in port_T.two_prod(_t(a), _t(b))),
                   tuple(np.asarray(t) for t in ref_T.two_prod(
                       jnp.asarray(a), jnp.asarray(b)))):
        assert np.array_equal(hi.astype(np.float64), prod)
        assert not np.any(lo)
        assert np.array_equal(_bits(hi), _bits(a * b))


# -- the kernel's index arithmetic -------------------------------------------

def _configs():
    """(R, TR, TK, MINB) of the Big and Small configurations, read from
    the source."""
    out = []
    for name in ("Big", "Small"):
        m = re.search(rf"using {name} = Config<(\d+), (\d+), (\d+), (\d+)>;",
                      SRC)
        out.append(tuple(int(g) for g in m.groups()))
    return out


def test_configs_match_the_source():
    assert re.search(r"constexpr int kBKV = (\d+);", SRC).group(1) == str(BKV)
    for (R, TR, TK, minb), (rows, threads, per_sm) in zip(
            _configs(), port_attn.CONFIGS):
        assert (R, R // TR * (BKV // TK), minb) == (rows, threads, per_sm)
        assert (BKV // TK) <= 32 and 32 % (BKV // TK) == 0
    sig = re.search(r'extern "C" int ff_attention_fwd\((.*?)\)\s*{', SRC,
                    re.S).group(1).split(",")
    assert len(sig) == len(port_attn._ARGTYPES)
    assert [p.split()[-1] for p in sig[-3:]] == ["plan", "hb_shift",
                                                 "stream"]
    for name in ("kSkipTiles", "kExactBf16", "kFmaTwoProd", "kLongestFirst",
                 "kExpInline"):
        assert f"constexpr bool {name} = true;" in SRC


def _computed(config, heads, Sq, Skv, causal, q_offset):
    """The (position, key) pairs that the kernel computes for one head
    group: its tile loop, its warps' key limit jn and sub-tiles ns,
    mirrored from ff_attention_kernel.  Returns a boolean (Sq, Skv) array
    of pairs computed by some block, and asserts each is computed once."""
    R, TR, TK, _ = _configs()[config]
    KX, PB = BKV // TK, R // heads
    threads = R // TR * KX
    seen = np.zeros((Sq, Skv), np.int64)
    for qt in range(-(-Sq // PB)):
        q0 = qt * PB
        bpos = q_offset + q0 + PB - 1
        last = min(Skv - 1, bpos) if causal else Skv - 1
        n_tiles = 0 if last < 0 else last // BKV + 1
        for tile in range(n_tiles):
            k0 = tile * BKV
            for tid in range(threads):
                tx, ty = tid % KX, tid // KX
                wpos = q_offset + q0 + (
                    (TR * (((tid & ~31) + 31) // KX) + TR - 1) // heads)
                jn = min(BKV, Skv - k0)
                if causal:
                    jn = min(jn, wpos - k0 + 1)
                if jn <= 0:
                    continue
                ns = -(-jn // KX)
                for j in range(ns):
                    col = k0 + tx + KX * j
                    for i in range(TR):
                        r = TR * ty + i
                        if r % heads or q0 + r // heads >= Sq or col >= Skv:
                            continue     # one head's rows; off the edges
                        seen[q0 + r // heads, col] += 1
    assert seen.max() <= 1
    return seen.astype(bool)


@pytest.mark.parametrize("config", [0, 1])
@pytest.mark.parametrize("heads", [1, 2, 4])
@pytest.mark.parametrize("Sq, Skv, causal, q_offset", [
    (70, 70, True, 0), (5, 130, True, 125), (33, 200, True, 100),
    (40, 97, False, 0), (130, 130, True, 0), (32, 1500, False, 0)])
def test_every_visible_pair_is_computed(config, heads, Sq, Skv, causal,
                                        q_offset):
    """Under the tile and sub-tile skip every pair a row sees (key <
    Skv, and key <= q_offset + position if causal) is computed, once;
    the pairs computed beyond are masked in the kernel."""
    got = _computed(config, heads, Sq, Skv, causal, q_offset)
    pos = q_offset + np.arange(Sq)[:, None]
    want = np.ones((Sq, Skv), bool) if not causal else \
        np.arange(Skv)[None, :] <= pos
    assert np.all(got[want])
    # the skip leaves at most a sub-tile a warp beyond the diagonal
    R, TR, TK, _ = _configs()[config]
    if causal:
        extra = got & ~want
        reach = (np.where(extra, np.arange(Skv)[None, :], -1).max(axis=1)
                 - pos[:, 0])
        warp_rows = 32 // (BKV // TK) * TR // heads + 1
        assert reach.max() < BKV // TK + warp_rows


# -- the plan ---------------------------------------------------------------

@pytest.mark.parametrize("shape, want", [
    # granite-3-2b (32 heads, 8 KV): prefill, training, long step
    ((1, 64, 32, 8), (1, 4, 4, (8, 16))),
    ((4, 128, 32, 8), (0, 4, 16, (32, 8))),
    ((2, 1024, 32, 8), (0, 4, 16, (16, 64))),
    # a shorter prompt, one step of 4 x 64, and G = 1, 2, 3
    ((1, 16, 32, 8), (1, 4, 4, (8, 4))),
    ((4, 64, 32, 8), (1, 4, 4, (32, 16))),
    ((8, 300, 8, 8), (0, 1, 64, (64, 5))),
    ((2, 300, 8, 8), (1, 1, 16, (16, 19))),
    ((1, 37, 4, 2), (1, 2, 8, (2, 5))),
    ((1, 70, 6, 2), (1, 1, 16, (6, 5))),
    # whisper-medium (16 MHA heads): the encoder over 1500 frames, the
    # cross attention from a 32-token prompt
    ((2, 1500, 16, 16), (0, 1, 64, (32, 24))),
    ((2, 32, 16, 16), (1, 1, 16, (32, 2))),
])
def test_attention_plan_per_shape(shape, want):
    assert tuple(port_attn.attention_plan(*shape)) == want


def test_attention_ops_counts_every_pair_when_non_causal():
    """chip_smoke's bound: non-causal, every one of B H Sq Skv pairs
    counts (whisper's cross shape); causal, the pairs on or below the
    diagonal only."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs

    def ops(Sq, Skv, causal, B=2, H=16):
        return cs.attention_ops(B, Sq, Skv, H, 64, causal, True, 0.125)
    per_pair = (ops(32, 1500, False) - ops(32, 1499, False)) // (2 * 32 * 16)
    assert per_pair > 0
    assert ops(32, 1500, False) - ops(32, 0, False) == \
        per_pair * 2 * 32 * 1500 * 16
    assert ops(4, 4, True) - ops(4, 0, True) == per_pair * 2 * 16 * 10
    assert ops(4, 4, False) - ops(4, 4, True) == per_pair * 2 * 16 * 6


@pytest.mark.parametrize("B, Sq, H, KV", [
    (1, 1, 1, 1), (1, 64, 32, 8), (3, 257, 12, 3), (2, 1000, 16, 2),
    (8, 4096, 32, 8), (1, 5, 6, 6)])
def test_attention_plan_covers_the_rows(B, Sq, H, KV):
    """A block's heads share one KV head and its rows are heads x
    positions of its configuration; the grid covers every (batch, head)
    and q position; the largest configuration that fills the SMs."""
    plan = port_attn.attention_plan(B, Sq, H, KV)
    G = H // KV
    assert G % plan.heads == 0 and plan.heads in (1, 2, 4)
    assert plan.heads * plan.positions == port_attn.CONFIGS[plan.config][0]
    assert plan.grid == (B * H // plan.heads, -(-Sq // plan.positions))
    fills = [port_attn.plan_with(i, plan.heads, B, Sq, H).blocks >= 132
             for i in range(len(port_attn.CONFIGS))]
    assert plan.config == (fills.index(True) if any(fills)
                           else len(fills) - 1)
    assert port_attn.plan_with(plan.config, plan.heads, B, Sq, H) == plan


@pytest.mark.parametrize("hd", [1, 40, 64, 128, 192])
@pytest.mark.parametrize("config", [0, 1])
def test_head_dim_instances_fit_an_sm(hd, config):
    """Every head dim the kernel takes has an instance (64 for hd <= 64)
    whose blocks fit the shared memory of an SM, and a plan."""
    HD = port_attn.kernel_head_dim(hd)
    assert HD == (64 if hd <= 64 else hd) and HD in port_attn.KERNEL_HEAD_DIMS
    smem = port_attn.smem_bytes(config, hd)
    assert smem <= port_attn.SMEM_PER_BLOCK
    # blocks an SM: the __launch_bounds__ count, or fewer where the shared
    # memory runs out (Small at 192: one)
    per_sm = min(port_attn.CONFIGS[config][2],
                 port_attn.SMEM_PER_SM // smem)
    assert per_sm >= 1
    plan = port_attn.attention_plan(2, 32, 16, 16, hd=hd)
    assert plan.grid == (32 // plan.heads, -(-32 // plan.positions))


@pytest.mark.parametrize("hd", [0, 65, 96, 127, 129, 191, 256, 576])
def test_other_head_dims_raise(hd):
    with pytest.raises(ValueError, match="head_dim"):
        port_attn.kernel_head_dim(hd)
    with pytest.raises(ValueError, match="head_dim"):
        port_attn.attention_plan(1, 16, 4, 4, hd=hd)


def test_head_dim_instances_match_the_source():
    """The wrapper's shared-memory formula, rows a thread and head dims are
    the source's."""
    assert "return HD * C::kQS + HD * C::kKS + kBKV * HD + " \
        "2 * kBKV * C::kQS;" in SRC
    assert tuple(c[1] for c in _configs()) == port_attn.CONFIG_TR
    assert "(hd > 64 && hd != 128 && hd != 192)" in SRC
    for HD in port_attn.KERNEL_HEAD_DIMS:
        assert f"launch_plan<{HD}, T>" in SRC
    assert port_attn.KERNEL_BKV == BKV


# -- parity cases of the plain version ---------------------------------------

def _oracle(q, k, v, causal, q_offset):
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    sc = float(np.float32(1.0 / np.sqrt(hd)))
    q64 = q.astype(np.float64).reshape(B, Sq, KV, H // KV, hd)
    s = np.einsum("bqkgd,bskd->bkgqs", q64, k.astype(np.float64)) * sc
    if causal:
        mask = np.arange(Skv)[None, :] <= q_offset + np.arange(Sq)[:, None]
        s = np.where(mask, s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    o = np.einsum("bkgqs,bskd->bkgqd", p / p.sum(-1, keepdims=True),
                  v.astype(np.float64))
    return o.transpose(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)


def _rel_err(got, want):
    den = np.abs(want).max(axis=(1, 3), keepdims=True)
    return float((np.abs(got - want) / den).max())


PARITY = {
    # name: (B, Sq, Skv, H, KV, hd, causal, q_offset, bf16)
    "bf16_hd64_gqa4": (1, 16, 16, 8, 2, 64, True, 0, True),
    "causal_q_offset_sq_lt_skv": (1, 8, 40, 4, 2, 32, True, 32, False),
    "wholly_masked_tiles": (1, 160, 160, 2, 1, 32, True, 0, False),
    # the head dims the kernel once refused (hd > 64 raised on the card,
    # where the reference's kernel pads hd to its lane): the dense and MoE
    # configs' 128 and MLA's prefill 192, G = 1 and 4, q_offset > 0
    "hd128_g1_q_offset": (1, 8, 24, 2, 2, 128, True, 16, False),
    "hd192_g4_q_offset_bf16": (1, 8, 24, 4, 1, 192, True, 16, True),
}


@pytest.mark.parametrize("case", sorted(PARITY))
def test_plain_attention_parity_new_cases(case):
    B, Sq, Skv, H, KV, hd, causal, q_offset, bf16 = PARITY[case]
    rng = np.random.default_rng(253)
    mk = (lambda s: _bf16(rng.standard_normal(s))) if bf16 else \
        (lambda s: rng.standard_normal(s).astype(np.float32))
    q, k, v = mk((B, Sq, H, hd)), mk((B, Skv, KV, hd)), mk((B, Skv, KV, hd))
    if bf16:     # bf16 tensors to both, as the serving and training paths
        tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
        jq, jk, jv = (jnp.asarray(x.astype(ml_dtypes.bfloat16))
                      for x in (q, k, v))
    else:
        tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
        jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    got = port_attn.flash_attention_ff(tq, tk, tv, causal=causal,
                                       q_offset=q_offset, return_ff=True)
    got = got.hi.double().numpy() + got.lo.double().numpy()
    want = _oracle(q, k, v, causal, q_offset)
    assert _rel_err(got, want) <= TOL
    for ref in (ref_attn.flash_attention_ff(jq, jk, jv, causal=causal,
                                            q_offset=q_offset,
                                            return_ff=True),
                ref_attn.flash_attention_pallas(jq, jk, jv, causal=causal,
                                                q_offset=q_offset,
                                                interpret=True,
                                                return_ff=True)):
        r = np.asarray(ref.hi, np.float64) + np.asarray(ref.lo, np.float64)
        assert _rel_err(r, want) <= TOL
        assert _rel_err(got, r) <= TOL
    assert math.isfinite(float(np.abs(got).max()))
