"""The streaming kernels' host side on the CPU (``csrc/ff_stream.cuh``:
the elementwise kernel's flat path and the AdamW kernel):

  * ``elementwise_plan`` sends every operand form to its path: dense
    planes (full, partly broadcast ones, which ``broadcast_planes``
    materialises, (R, 1) and (1, C) outputs) and scalars to the flat path,
    16-byte accesses ("vector") only where every dense plane and both
    outputs start on a 16-byte boundary, 4-byte ones ("flat") for views
    offset 1-3 floats; row, column and transposed operands to the strided
    path, and so every call of 2^30 elements or more;
  * ``adamw_plan``: all five leaves aligned and fewer than 2^30 elements
    give the streamed kernel, anything else the 4-byte loop;
  * ``stream_elements``, a host mirror of ``ffstream::stream``'s
    schedule, covers each index once (packs and tail) for 0-67 elements,
    every pack width, one or several blocks and steps, and its constants
    and loop are the header's;
  * the C entry points take the wrappers' ctypes arguments, and each
    ``stream_variants`` edit applies once to the shipped sources;
  * the plain versions the kernels are held to on the card are bitwise the
    reference's on the layouts the new paths take: each op on operands
    offset 1-3 floats and at lengths off the 4-wide packs (against the
    interpret-mode Pallas kernel), and AdamW on offset leaves (against the
    reference's op-by-op impl).

The kernels run only on the card: ``chip_smoke.py`` holds both bit for bit
to their plain versions on these layouts and shows the timed calls took
the 16-byte path.
"""

import re
from typing import List

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ff as ref_ff
from repro.kernels import ff_elementwise as ref_ew
from repro_torch.benchmarks import stream_variants as sv
from repro_torch.kernels import build
from repro_torch.kernels import ff_elementwise as ew
from repro_torch.kernels import ff_fused

HEADER = (build.CSRC / "ff_stream.cuh").read_text()
# ffstream::kThreads, kVec (floats a pack) and kUnroll (packs a thread)
STREAM_THREADS, STREAM_VEC, STREAM_UNROLL = 256, 4, 2
EW_SRC = (build.CSRC / "ff_elementwise.cu").read_text()
ADAMW_SRC = (build.CSRC / "ff_adamw.cu").read_text()
CPU = torch.device("cpu")


def _buf(n: int, off: int = 0) -> torch.Tensor:
    """n floats starting ``off`` floats past a 16-byte boundary."""
    base = torch.empty(n + 8)
    skip = (-base.data_ptr() // 4) % 4          # to the first boundary
    return base[skip + off: skip + off + n]


def _plan(op, *arrays, outs_off=0):
    n_in = len(arrays)
    planes, _shape, R, C = ew.layout(op, n_in, arrays, ew.DEFAULT_BLOCK, CPU)
    outs = (_buf(R * C, outs_off).view(R, C), _buf(R * C).view(R, C))
    return ew.elementwise_plan(planes, R, C, outs)


def _full(shape, off=0):
    n = int(np.prod(shape)) if shape else 1
    x = _buf(n, off).view(shape)
    return x.normal_()


# -- elementwise_plan -----------------------------------------------------

FORMS = {
    # operands (as shapes and offsets) -> (path, scalars)
    "full": (((64, 260), (64, 260), (64, 260), (64, 260)), ("vector", 0)),
    "full, R = 1": (((1, 67),) * 4, ("vector", 0)),
    "full, C = 1": (((37, 1),) * 4, ("vector", 0)),
    "a scalar lo": (((64, 260), (), (64, 260), (64, 260)), ("vector", 2)),
    "scalar b": (((64, 260), (64, 260), (), ()), ("vector", 12)),
    "a (1, 1) b": (((64, 260), (64, 260), (1, 1), (1, 1)), ("vector", 12)),
    "(1, C) b": (((64, 260), (64, 260), (1, 260), (1, 260)),
                 ("strided", 0)),
    "(R, 1) b": (((64, 260), (64, 260), (64, 1), (64, 1)), ("strided", 0)),
    "partly broadcast b": (((4, 3, 8), (4, 3, 8), (3, 8), (3, 8)),
                           ("vector", 0)),
    "rank-3 full": (((2, 3, 40),) * 4, ("vector", 0)),
}


@pytest.mark.parametrize("form", sorted(FORMS))
def test_elementwise_plan_forms(form):
    shapes, want = FORMS[form]
    arrays = [_full(s) if s else torch.tensor(1.5) for s in shapes]
    assert tuple(_plan("add22", *arrays)) == want


@pytest.mark.parametrize("off", [1, 2, 3, 4])
@pytest.mark.parametrize("which", [0, 1, 2, 3, "outputs"])
def test_elementwise_plan_offset_views(off, which):
    """A dense plane 1-3 floats off a 16-byte boundary takes the flat path
    with 4-byte accesses (never the strided one); 4 floats off, 16 bytes,
    keeps the vector path.  So does an output."""
    arrays = [_full((37, 68), off if k == which else 0) for k in range(4)]
    plan = _plan("mul22", *arrays,
                 outs_off=off if which == "outputs" else 0)
    assert plan == (("vector" if off == 4 else "flat"), 0)


def test_elementwise_plan_transposed_and_strided_views():
    a = _full((64, 260))
    t = _full((260, 64)).T                       # column-major
    assert _plan("add22", a, a, t, a).path == "strided"
    wide = _full((64, 300))[:, :260]             # rows 300 apart
    assert _plan("two_sum", a, wide).path == "strided"
    # a scalar is read once wherever it lies
    s = _buf(5, 3)[1]
    assert tuple(_plan("two_prod", a, s)) == ("vector", 2)


@pytest.mark.parametrize("op", ew.EW_OPS)
def test_elementwise_plan_each_op(op):
    n_in = 4 if op in ("add22", "mul22", "div22") else 2
    arrays = [_full((3, 130)) for _ in range(n_in)]
    assert tuple(_plan(op, *arrays)) == ("vector", 0)
    arrays[n_in - 1] = _full((3, 130), 1)
    assert tuple(_plan(op, *arrays)) == ("flat", 0)


def test_elementwise_plan_limit():
    """The streams' 32-bit index: from 2^30 elements on, the strided path
    (its 64-bit loop), whatever the layout."""
    assert ew.STREAM_LIMIT == 1 << 30
    for n, want in ((ew.STREAM_LIMIT - 1, "vector"),
                    (ew.STREAM_LIMIT, "strided")):
        x = torch.tensor(2.0).reshape(1, 1).expand(1, n)
        assert ew.elementwise_plan([x, x], 1, n).path == want


# -- adamw_plan -----------------------------------------------------------

@pytest.mark.parametrize("n", [1, 5, 67, 1003])
@pytest.mark.parametrize("off", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("which", [0, 2, 4])
def test_adamw_plan(n, off, which):
    leaves = [_buf(n, off if k == which else 0) for k in range(5)]
    assert ff_fused.adamw_plan(leaves) == (
        "vector" if off % 4 == 0 else "flat")


def test_adamw_plan_limit():
    x = torch.zeros(1)
    for n, want in ((ew.STREAM_LIMIT - 1, "vector"),
                    (ew.STREAM_LIMIT, "flat")):
        assert ff_fused.adamw_plan([x.expand(n)] * 5) == want


# -- the stream's schedule ------------------------------------------------

def stream_elements(n: int, vec: int, grid: int,
                    threads: int = STREAM_THREADS,
                    unroll: int = STREAM_UNROLL) -> List[int]:
    """The element indices ``ffstream::stream`` (csrc/ff_stream.cuh)
    visits over n elements in packs of ``vec`` on ``grid`` blocks, in its
    order: block by block, thread by thread, step by step, its packs, then
    the tail of n % vec elements on the last block."""
    out: List[int] = []
    packs = n // vec
    step = grid * threads * unroll
    for b in range(grid):
        for t in range(threads):
            j = b * threads * unroll + t
            while j < packs:
                for k in range(unroll):
                    if j + k * threads < packs:
                        i = (j + k * threads) * vec
                        out.extend(range(i, i + vec))
                j += step
            if vec > 1 and b == grid - 1 and packs * vec + t < n:
                out.append(packs * vec + t)
    return out



@pytest.mark.parametrize("vec", [1, 2, 4])
@pytest.mark.parametrize("threads,unroll,grid", [
    (256, 2, 1), (256, 2, 3), (4, 1, 1), (4, 2, 2), (4, 4, 3), (4, 2, 5)])
def test_stream_covers_each_index_once(vec, threads, unroll, grid):
    """Each index once, for 0-67 elements; with 4 threads a block the
    blocks take several steps each (the tail needs vec - 1 <= threads)."""
    for n in range(68):
        seen = stream_elements(n, vec, grid, threads, unroll)
        assert sorted(seen) == list(range(n)), n


def test_stream_mirror_matches_the_header():
    """``stream_elements`` follows ``ffstream::stream``'s loop, and the
    wrappers' constants are the header's."""
    for name, value in (("kThreads", STREAM_THREADS), ("kVec", STREAM_VEC),
                        ("kUnroll", STREAM_UNROLL)):
        assert f"constexpr int {name} = {value};" in HEADER
    for line in ("const int packs = n / VEC;",
                 "const int step = gridDim.x * t * kUnroll;",
                 "for (int j = blockIdx.x * t * kUnroll + threadIdx.x; "
                 "j < packs;",
                 "if (j + k * t < packs) load_k(Width<VEC>{}, k, "
                 "(j + k * t) * VEC);",
                 "const int i = packs * VEC + static_cast<int>"
                 "(threadIdx.x);",
                 "if (blockIdx.x == gridDim.x - 1 && i < n) {"):
        assert line in " ".join(HEADER.split()), line
    # one block a step: the loop body runs once a thread
    assert ("return static_cast<int>(blocks);" in HEADER
            and "blocks = n > 0 ? (n + per_step - 1) / per_step : 1;"
            in HEADER)
    for src in (EW_SRC, ADAMW_SRC):
        assert "if (n >= (1LL << 30)) return" in src
        assert '#include "ff_stream.cuh"' in src
    # the kernels of ff_planes.cuh stay off the new header
    assert "ff_stream.cuh" not in (build.CSRC / "ff_math.cu").read_text()
    assert "ff_stream.cuh" not in (build.CSRC / "ff_planes.cuh").read_text()


def _signature(src: str, fn: str):
    sig = re.search(rf'extern "C" int {fn}\((.*?)\)\s*{{', src, re.S)
    return [p.strip() for p in sig.group(1).split(",")]


def test_entry_points_take_the_wrappers_arguments():
    assert len(_signature(ADAMW_SRC, "ff_adamw_f32")) == len(
        ff_fused._ADAMW_ARGTYPES)
    assert _signature(ADAMW_SRC, "ff_adamw_f32")[9] == "int vector"
    assert _signature(EW_SRC, "ff_elementwise_flat_f32") == [
        "const void* planes", "int scalars", "int vector",
        "cudaStream_t stream"]
    assert _signature(EW_SRC, "ff_elementwise_f32") == [
        "const void* planes", "cudaStream_t stream"]
    assert sv.adamw_signature(build.CSRC) == _signature(ADAMW_SRC,
                                                        "ff_adamw_f32")


@pytest.mark.parametrize("name", sorted(sv.VARIANTS))
def test_stream_variants_edit_the_sources_once(name):
    """Each stream_variants variant is text edits of csrc/: every edited
    text occurs once in its file and changes it."""
    for fname, old, new in sv.edits_of(name):
        assert (build.CSRC / fname).read_text().count(old) == 1, (fname, old)
        assert old != new
    assert bool(sv.edits_of(name)) == (name not in ("shipped",
                                                    "strided path"))


def test_instance_labels():
    assert sv.instance_label(
        "_ZN12_GLOBAL__N_111flat_kernelILi3ELi4EEEvN3ffk6PlanesEi") == (
        "flat sqrt22 vec 4")
    assert sv.instance_label(
        "_ZN12_GLOBAL__N_118elementwise_kernelILi5EEEvN3ffk6PlanesE") == (
        "strided two_sum")
    assert sv.instance_label("_ZN12_GLOBAL__N_119adamw_stream_kernel"
                             "EPKfPfS2_S2_S2_S1_ffi") == "adamw stream"
    assert sv.instance_label("_ZN12_GLOBAL__N_112adamw_kernelEPKf") == (
        "adamw 4-byte")


# -- the plain versions on the new paths' layouts ------------------------

def _same(a, b) -> bool:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    if a.shape != b.shape or not np.array_equal(np.isnan(a), np.isnan(b)):
        return False
    keep = ~np.isnan(a)
    return np.array_equal(a[keep].view(np.int32), b[keep].view(np.int32))


def _operands(op, shape, rng):
    def pair(positive):
        h = rng.standard_normal(shape).astype(np.float32)
        if positive:
            h = np.abs(h) + 0.5
        return h, (h * 1e-8 * rng.standard_normal(shape)).astype(np.float32)
    (ah, al), (bh, bl) = pair(False), pair(True)
    return sv.ew_args(op, ah, al, bh, bl)


@pytest.mark.parametrize("op", ew.EW_OPS)
@pytest.mark.parametrize("off", [1, 2, 3])
def test_elementwise_plain_on_offset_views_matches_reference(op, off):
    """Each op on operand planes 1-3 floats off a 16-byte boundary, at a
    length off the 4-wide packs (37 x 67 = 2479 elements): bitwise the
    interpret-mode reference kernel on the same values."""
    ops = _operands(op, (37, 67), np.random.default_rng(20 + off))
    views = []
    for x in ops:
        v = _buf(x.size, off).view(x.shape)
        v.copy_(torch.from_numpy(x))
        views.append(v)
    assert ew.elementwise_plan(views, 37, 67).path == "flat"
    rh, rl = ref_ew.elementwise(op, *(jnp.asarray(x) for x in ops),
                                interpret=True)
    ph, pl = ew.elementwise_plain(op, *views)
    assert _same(rh, ph) and _same(rl, pl)


SCALARS = (1e-3, 0.9, 0.95, 0.1, 0.05)     # lr, b1, b2, bc1, bc2
EPS, WD = 1e-8, 0.1


@pytest.mark.parametrize("n", [1, 3, 67, 1001])
@pytest.mark.parametrize("off", [0, 1, 3])
def test_adamw_plain_on_offset_leaves_matches_reference(n, off):
    """AdamW's plain version in place on leaves offset 1-3 floats into
    their buffers, at lengths off the 4-wide packs: bitwise the
    reference's op-by-op impl on w, wlo, m and v; g unchanged."""
    rng = np.random.default_rng(n + off)
    host = [(rng.standard_normal(n) * s).astype(np.float32)
            for s in (1.0, 0.1, 0.01, 1.0, 1e-8)]
    host[2] = np.abs(host[2])
    leaves = []
    for x in host:
        v = _buf(n, off)
        v.copy_(torch.from_numpy(x))
        leaves.append(v)
    assert ff_fused.adamw_plan(leaves) == ("vector" if off == 0 else "flat")
    ff_fused.adamw_update_plain(*leaves, *(torch.tensor(s) for s in SCALARS),
                                eps=EPS, wd=WD)
    out = ref_ff.adamw_update(*(jnp.asarray(x) for x in host),
                              *(jnp.float32(s) for s in SCALARS), eps=EPS,
                              wd=WD, impl="jnp")
    want = (out[0].hi, out[0].lo, out[1], out[2])
    for name, r, p in zip(("w", "wlo", "m", "v"), want, leaves[3:] +
                          leaves[1:3]):
        assert _same(r, p.numpy()), name
    assert _same(host[0], leaves[0].numpy())
