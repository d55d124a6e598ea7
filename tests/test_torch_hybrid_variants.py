"""The hybrid FF matmul's wrapper and design records on the CPU:

  * ``benchmarks.hybrid_variants``: each variant's text edits apply once
    to ``csrc/ff_matmul.cu`` (else it cannot build), its Config line is
    found, and ``instance_label`` reads the kernel instances' names;
  * ``kernels.ff_matmul.hybrid_plan``, the rule that splits the K-blocks
    per shape: no split where the output tiles fill two blocks an SM, else
    over at most the blocks that fit beside them at three an SM, never
    more splits than K-blocks; ``HYBRID_TILE``, ``HYBRID_BLOCKS_PER_SM``
    and the ctypes signatures match the source;
  * the plain version (what the wrapper runs on CPU tensors) bit for bit
    the reference's oracle on integer operands at the kernel's edge shapes
    (M, N off its tiles, K off its K-tiles) and at bk 1, 300, 512 and
    beyond K, where every block product is exact.

The CUDA kernels run only on the card: ``chip_smoke.py`` holds the hybrid
kernel bit for bit to the check kernel (its earlier design) at these
shapes and bk, through every tile and split.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as ref_oracles
from repro_torch.benchmarks import hybrid_variants as hv
from repro_torch.kernels import build
from repro_torch.kernels import ff_matmul as km

SRC = (build.CSRC / "ff_matmul.cu").read_text()
CHECK_SRC = (build.CSRC / "ff_matmul_hybrid_check.cu").read_text()
GRANITE = ((512, 2048, 8192), (512, 8192, 2048), (512, 2048, 49155))
# (M, K, N): M and N off the 128 x 64 tile and the 4-wide copies, K off
# the K-tiles of 16 (chip_smoke.HYBRID_CASES)
EDGES = ((129, 300, 65), (1, 7, 1), (63, 1100, 129), (257, 513, 200),
         (130, 37, 70), (200, 1000, 131))


@pytest.mark.parametrize("name", sorted(hv.VARIANTS))
def test_hybrid_variants_edit_the_sources_once(name):
    """Each hybrid_variants variant is text edits of csrc/: every edited
    text occurs once in its file and changes it."""
    edits = hv.edits_of(name)
    for fname, old, new in edits:
        assert (build.CSRC / fname).read_text().count(old) == 1, (fname, old)
        assert old != new
    source_variant = hv.VARIANTS[name] is not None and (
        hv.VARIANTS[name][0] or hv.VARIANTS[name][1])
    assert bool(edits) == bool(source_variant)


def test_config_line_and_tile_match_the_wrapper():
    """The Shipped Config line parses; its output tile and blocks an SM are
    the wrapper's, with 8 x 8 outputs a thread and the FF accumulator in
    shared memory."""
    found = [dict(zip(hv.FIELDS, map(int, m.groups())))
             for m in hv.CONFIG.finditer(SRC)]
    assert len(found) == 1
    c = found[0]
    assert (c["TY"] * c["RM"], c["TX"] * c["RN"]) == km.HYBRID_TILE
    assert c["MINB"] == km.HYBRID_BLOCKS_PER_SM
    assert (c["RM"], c["RN"], hv.ACC[c["ACC"]]) == (8, 8, "shared memory")
    # a split's blocks launch without the accumulator's shared memory
    assert "ws ? C::kRing : C::kSmem" in SRC
    assert km.HYBRID_SPLIT_BLOCKS_PER_SM > km.HYBRID_BLOCKS_PER_SM
    assert "enum Acc : int { kAccRegs, kAccSmem, kAccOut };" in SRC


def test_instance_label_reads_the_mangled_names():
    name = ("_ZN66_GLOBAL__N__d1f2e3a4_12_ff_matmul_cu_abcdef0113hybrid_kernel"
            "INS_6ConfigILi8ELi16ELi8ELi8ELi16ELi3ELi1ELi2ELi8EEELb0ELb1EEEv"
            "NS_7"
            "OperandES3_PfS4_S4_iiiiibb")
    assert hv.instance_label(name) == (
        "128x64 tile 8x8 TK 16 stages 3 acc in shared memory, 2 blocks an "
        "SM, warp 4x8, A 4-byte, B 16-byte copies")
    assert hv.instance_label("_ZN13fold_gemm_kernelEv") is None


@pytest.mark.parametrize("sms", [132, 114, 78])
def test_hybrid_plan_rule(sms):
    """No split where the 128 x 64 tiles fill two blocks an SM, else at
    most 3 sms // tiles splits, never more than the K-blocks; at 132 SMs
    only w_down's (512, 8192, 2048) splits, in 3."""
    for M, K, N in GRANITE + EDGES:
        for bk in (1, 300, 512, 4096):
            splits = km.hybrid_plan(M, N, K, bk, sms)
            tiles = -(-M // 128) * -(-N // 64)
            assert 1 <= splits <= max(1, -(-K // bk))
            if tiles >= 2 * sms:
                assert splits == 1
            else:
                assert splits == 1 or splits * tiles <= 3 * sms
    if sms == 132:
        assert [km.hybrid_plan(M, N, K, 512, sms) for M, K, N in GRANITE] \
            == [1, 3, 1]


def _signature(src, fn):
    sig = re.search(rf'extern "C" int {fn}\((.*?)\)\s*{{', src, re.S)
    return [p.strip() for p in sig.group(1).split(",")]


def test_ctypes_signatures_match_the_sources():
    """The wrappers' argtypes have one entry per parameter of the C entry
    points (ctypes passes an unlisted pointer as a 32-bit int)."""
    assert len(_signature(SRC, "ff_matmul_f32")) == len(km._HYBRID_ARGTYPES)
    assert len(_signature(CHECK_SRC, "ff_matmul_hybrid_check_f32")) == len(
        km._CHECK_ARGTYPES)
    assert "ff_matmul_hybrid_check" in build.SOURCES
    # the check kernel is the earlier design: 64 x 64 tiles of 4 x 4
    # outputs, K depth 16 staged synchronously, two blocks an SM
    for line in ("constexpr int kTile = 64;", "constexpr int kTk = 16;",
                 "__launch_bounds__(kThreads, 2)",
                 "acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);"):
        assert line in CHECK_SRC


def test_wrappers_off_the_card():
    """CPU tensors take the plain version and count no launch; the check
    kernel has no plain version and raises."""
    rng = np.random.default_rng(83)
    a = torch.from_numpy(rng.standard_normal((5, 9)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((9, 3)).astype(np.float32))
    before = km.ff_matmul.launches
    got = km.ff_matmul(a, b, bk=4)
    want = km.ff_matmul_plain(a, b, bk=4)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert km.ff_matmul.launches == before
    with pytest.raises(RuntimeError, match="no kernel"):
        km.ff_matmul_hybrid_check(a, b)


@pytest.mark.parametrize("bk", [1, 300, 512, 4096])
@pytest.mark.parametrize("mkn", EDGES)
def test_hybrid_plain_bitwise_reference_at_the_kernel_edges(mkn, bk):
    """Integers in [-8, 8]: every block product is exact, so the plain
    version and the reference's oracle agree to the bit at every bk (and
    with float64 in hi + lo)."""
    M, K, N = mkn
    rng = np.random.default_rng(89 + M + K + N)
    A = rng.integers(-8, 9, (M, K)).astype(np.float32)
    B = rng.integers(-8, 9, (K, N)).astype(np.float32)
    want = ref_oracles.ref_ff_matmul(jnp.asarray(A), jnp.asarray(B), bk=bk)
    got = km.ff_matmul(torch.from_numpy(A), torch.from_numpy(B), bk=bk)
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w).view(np.int32),
                              g.numpy().view(np.int32))
    exact = A.astype(np.float64) @ B.astype(np.float64)
    assert np.array_equal(got[0].double().numpy() + got[1].double().numpy(),
                          exact)
