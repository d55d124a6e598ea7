"""The whole-row kernels' host side (``csrc/ff_softmax.cu``,
``csrc/ff_norm_stats.cu`` on ``csrc/ff_rows.cuh``) and their plain
versions at the rows' edges:

  * ``row_plan`` as a function of (rows, cols, offset, kind, card): one
    case per class (staged by 16- and 4-byte copies past one wave or 2048
    columns, streamed rows within them, ``norm_stats`` re-read within one
    wave and 8192 columns where it has a row an SM, the rows a block by
    kernel and capped by the SMs);
  * ``row_walk``, the kernels' walk of a row (every path): every column
    added once, on the thread that owns its lane, in the lane's column
    order; and a torch model of the walk (the Neumaier update per lane in
    the walk's order, then the lane fold) gives the plain versions' lane
    cascade bit for bit;
  * ``ff_softmax_plain`` and ``ff_norm_stats_plain`` against the
    reference's ``ff_softmax`` / ``ff_norm_stats`` (``interpret=True``)
    on ``row_variants.row_edges``: the +-0 max tie, a lone -0, NaN, +inf,
    all -inf; and the sign of a zero max reaches no output;
  * the C entry points' parameters against the wrappers' argument types,
    and ``row_variants``' text edits.

The kernels themselves run only on the card (``chip_smoke.py`` and
``python -m repro_torch.benchmarks.row_variants`` hold them to these
plain versions there).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ff_fused as ref_fused
from repro_torch.benchmarks import row_variants as rv
from repro_torch.core import transforms as T
from repro_torch.kernels import build
from repro_torch.kernels import ff_fused as F
from repro_torch.kernels.ref import fold_lanes, lane_cascade

RowPlan = F.RowPlan

# (rows, cols, offset, kind[, sms]) -> the plan: one case per class; an
# H100's 132 SMs of 2048 threads unless given
PLANS = {
    "more rows than the card holds: staged, 16-byte copies, 2 a block":
        ((4096, 4096, 0, "norm_stats"), RowPlan("staged", 2)),
    "fast modes: one row a block":
        ((4096, 4096, 0, "softmax"), RowPlan("staged", 1)),
    "staged, ragged: 4-byte copies":
        ((301, 4097, 0, "softmax accurate"), RowPlan("staged scalar", 2)),
    "staged, a start off 16 bytes: 4-byte copies":
        ((271, 4096, 4, "logsumexp accurate"), RowPlan("staged scalar", 2)),
    "one wave of short rows: norm_stats re-reads":
        ((512, 2048, 0, "norm_stats"), RowPlan("reread", 1)),
    "one wave of short rows: softmax streams":
        ((512, 2048, 0, "softmax accurate"), RowPlan("streamed", 2)),
    "streamed rows take ragged and offset rows":
        ((271, 1001, 4, "logsumexp"), RowPlan("streamed", 1)),
    "re-read rows take ragged and offset rows":
        ((271, 1001, 8, "norm_stats"), RowPlan("reread", 1)),
    "short rows past one wave: staged":
        ((2113, 2048, 0, "norm_stats"), RowPlan("staged", 2)),
    "one wave is the card's: fewer SMs, fewer rows":
        ((1057, 2048, 0, "norm_stats", 66), RowPlan("staged", 2)),
    "fewer rows than SMs: one a block":
        ((131, 256, 0, "softmax accurate"), RowPlan("streamed", 1)),
    "fewer norm_stats rows than SMs: staged":
        ((1, 3, 0, "norm_stats"), RowPlan("staged scalar", 1)),
    "one wave of wider norm_stats rows: re-read":
        ((512, 8192, 0, "norm_stats"), RowPlan("reread", 1)),
    "one wave of wider softmax rows: staged":
        ((512, 8192, 0, "softmax"), RowPlan("staged", 1)),
    "long rows, fewer than SMs":
        ((64, 16384, 0, "softmax"), RowPlan("staged", 1)),
    "long ragged rows":
        ((3, 16383, 0, "norm_stats"), RowPlan("staged scalar", 1)),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_row_plan_classes(name):
    args, want = PLANS[name]
    assert F.row_plan(*args) == want


def test_row_plan_rows_a_block_and_paths():
    """1 <= rows a block <= the kernel's, one block an SM at least; only
    norm_stats re-reads, only the fast modes keep one row a block."""
    for rows in (1, 131, 132, 264, 600, 4096, 10 ** 6):
        for cols in (1, 127, 128, 1000, 2048, 2049, 4096, 16384):
            for kind, most in F.ROWS_PER_BLOCK.items():
                p = F.row_plan(rows, cols, 0, kind)
                assert 1 <= p.rows_per_block <= most
                # the re-read kernel runs one block a row
                assert p.path != "reread" or p.rows_per_block == 1
                assert p.rows_per_block <= max(1, rows // 132)
                assert (p.path == "reread") == (
                    kind == "norm_stats" and cols <= F.REREAD_COLS
                    and 132 <= rows <= 132 * 16)
                assert (p.path == "streamed") == (
                    kind != "norm_stats" and cols <= F.STREAM_COLS
                    and rows <= 132 * 16)
                assert p.path in F._PATH_CODES
    assert F.ROWS_PER_BLOCK["softmax"] == F.ROWS_PER_BLOCK["logsumexp"] == 1


def test_row_plan_offsets_and_the_path_codes():
    for off in (0, 16, 32):
        assert F.row_plan(8, 4096, off).path == "staged"
    for off in (4, 8, 12):
        assert F.row_plan(8, 4096, off).path == "staged scalar"
        assert F.row_plan(300, 2048, off).path == "reread"
        assert F.row_plan(8, 2048, off).path == "staged scalar"
        assert F.row_plan(8, 2048, off, "softmax").path == "streamed"
    text = (build.CSRC / "ff_rows.cuh").read_text()
    for name, code in (("kStaged4", "staged scalar"), ("kStaged16", "staged"),
                       ("kStreamed", "streamed"), ("kReread", "reread")):
        assert f"  {name} = {F._PATH_CODES[code]}," in text


# -- the walk ------------------------------------------------------------------

WALK_COLS = (1, 3, 100, 128, 129, 1001, 4096, 16383)


@pytest.mark.parametrize("cols", WALK_COLS)
def test_row_walk_visits_every_column_once_in_lane_order(cols):
    walk = F.row_walk(cols)
    assert len(walk) == F.LANE
    seen = sorted(c for thread in walk for _lane, c in thread)
    assert seen == list(range(cols))
    for t, thread in enumerate(walk):
        assert all(lane == t for lane, _c in thread)
        assert [c for _lane, c in thread] == list(range(t, cols, F.LANE))


def _walk_cascade(val: torch.Tensor, walk):
    """A torch model of the kernels' cascade: each thread's lanes updated
    (s, c, cc) column by column in the walk's order, as ffk::LaneSum."""
    R, C = val.shape
    s, c, cc = (torch.zeros(R, F.LANE) for _ in range(3))
    for thread in walk:
        for lane, col in thread:
            t1, e1 = T.two_sum(s[:, lane], val[:, col])
            t2, e2 = T.two_sum(c[:, lane], e1)
            s[:, lane], c[:, lane] = t1, t2
            cc[:, lane] = cc[:, lane] + e2
    return s, c, cc


@pytest.mark.parametrize("cols", (3, 300, 1001))
def test_walk_model_gives_the_plain_lane_cascade_bits(cols):
    """Walking the columns in the kernels' order gives lane_cascade's
    triples and fold_lanes' sum, the same bits."""
    rng = np.random.default_rng(cols)
    x = torch.from_numpy((rng.standard_normal((3, cols))
                          * np.exp(rng.uniform(-20, 20, (3, cols))))
                         .astype(np.float32))
    got = _walk_cascade(x, F.row_walk(cols))
    want = lane_cascade(x, lanes=F.LANE)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    for a, b in zip(fold_lanes(got), fold_lanes(want)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


# -- the plain versions at the rows' edges -------------------------------------

def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32).astype(np.int64)


def _ulp(a, b) -> int:
    """Largest distance in f32 steps; a NaN matches a NaN only."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    assert np.array_equal(np.isnan(a), np.isnan(b))
    keep = ~np.isnan(a)
    return int(np.abs(_bits(a[keep]) - _bits(b[keep])).max()) \
        if keep.any() else 0


def _edge_groups():
    """row_edges' rows grouped by width: one reference call a width."""
    groups = {}
    for name, x in rv.row_edges("cpu").items():
        groups.setdefault(x.shape[1], []).append(x)
    return {c: torch.cat(v).numpy() for c, v in groups.items()}


EDGES = _edge_groups()


@pytest.mark.parametrize("cols", sorted(EDGES))
@pytest.mark.parametrize("mode", ["softmax", "logsumexp"])
@pytest.mark.parametrize("accurate", [True, False])
def test_softmax_plain_matches_reference_on_edge_rows(cols, mode, accurate):
    """Accurate bitwise, the builtin exp within 4 ulp (XLA's and torch's
    f32 exp), a NaN where the reference has one."""
    x = EDGES[cols]
    want = ref_fused.ff_softmax(jnp.asarray(x), mode=mode, accurate=accurate,
                                interpret=True)
    got = F.ff_softmax_plain(torch.from_numpy(x), mode, accurate)
    assert _ulp(want, got.numpy()) <= (0 if accurate else 4)


@pytest.mark.parametrize("cols", sorted(EDGES))
def test_norm_stats_plain_matches_reference_on_edge_rows(cols):
    """mu within 1 ulp and var within 2 (the reference's division by C is
    XLA's reciprocal multiply), a NaN where the reference has one."""
    x = EDGES[cols]
    mu_r, var_r = ref_fused.ff_norm_stats(jnp.asarray(x), interpret=True)
    mu, var = F.ff_norm_stats_plain(torch.from_numpy(x))
    assert _ulp(mu_r, mu.numpy()) <= 1 and _ulp(var_r, var.numpy()) <= 2


@pytest.mark.parametrize("sign", [-1.0, 1.0])
def test_the_sign_of_a_zero_max_reaches_no_output(monkeypatch, sign):
    """The kernels' shuffle max may return either zero on a +-0 tie: every
    mode gives the same bits for m = +0 and m = -0."""
    rows = [rv.row_edges("cpu")[k] for k in ("+-0 max tie", "-0 column",
                                              "-0, +0")]
    amax = torch.amax

    def signed_amax(t, *a, **k):
        m = amax(t, *a, **k)
        return torch.where(m == 0, torch.full_like(m, sign * 0.0), m)

    want = {}
    for i, x in enumerate(rows):
        for mode in ("softmax", "logsumexp"):
            for acc in (False, True):
                want[(i, mode, acc)] = F.ff_softmax_plain(x, mode, acc)
    monkeypatch.setattr(torch, "amax", signed_amax)
    for (i, mode, acc), w in want.items():
        got = F.ff_softmax_plain(rows[i], mode, acc)
        assert torch.equal(got.view(torch.int32), w.view(torch.int32))


# -- the entry points and the variants' edits ----------------------------------

def _params(lib: str, fn: str):
    src = (build.CSRC / f"{lib}.cu").read_text()
    sig = re.search(r'extern "C" int ' + fn + r"\((.*?)\)\s*{", src, re.S)
    return [p.strip() for p in sig.group(1).split(",")]


def test_entry_points_take_the_wrappers_arguments():
    plan_args = ["int path", "int rows_per_block", "cudaStream_t stream"]
    for lib, fn, argtypes, n in (
            ("ff_softmax", "ff_softmax_f32", F._SOFTMAX_ARGTYPES, 9),
            ("ff_norm_stats", "ff_norm_stats_f32", F._NORM_STATS_ARGTYPES,
             8)):
        params = _params(lib, fn)
        assert rv.entry_params(build.CSRC, lib, fn) == params
        assert len(params) == len(argtypes) == n
        assert params[-3:] == plan_args


@pytest.mark.parametrize("name", sorted(rv.VARIANTS))
def test_row_variants_edit_the_sources_once(name):
    edits = rv.VARIANTS[name]
    for fname, old, new in edits:
        assert (build.CSRC / fname).read_text().count(old) == 1, (fname, old)
        assert old != new
    assert edits or name == "shipped"


def test_instance_labels():
    assert rv.instance_label(
        "_ZN12_GLOBAL__N_114softmax_kernelILb1ELb0EEEvPKfPfiii") \
        == "softmax"
    assert rv.instance_label(
        "_ZN12_GLOBAL__N_114softmax_kernelILb0ELb1EEEvPKfPfiii") \
        == "logsumexp accurate"
    assert rv.instance_label(
        "_ZN12_GLOBAL__N_117norm_stats_kernelEPKfPfS2_iii") == "norm_stats"
    assert rv.instance_label(
        "_ZN12_GLOBAL__N_117norm_stats_rereadEPKfPfS2_i") \
        == "norm_stats reread"
    assert rv.instance_label("_ZN12_GLOBAL__N_111flat_kernel") is None
