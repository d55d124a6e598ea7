"""The whole-row kernels' design (``csrc/ff_softmax.cu`` and
``csrc/ff_norm_stats.cu`` on ``csrc/ff_rows.cuh``), one choice at a time,
on the card::

    python -m repro_torch.benchmarks.row_variants [NAME ...] \\
        [--baseline CSRC] [--out rows.json]
    python <this file> --calls       # with any checkout's src on PYTHONPATH

Each variant is text edits of a copy of ``csrc/`` (``VARIANTS``), built
with the port's ``nvcc`` flags into ``build/variants/rows_<name>/`` (all
at once, ``stream_variants.build_variants``): the rows a block forced to
1, 2 or 4 in the entry points (against the plan's 2 for ``ff_norm_stats``
and the accurate modes, 1 for the fast ones), each row folding its own
triples in place of one warp folding the block's, one path for every
shape in place of the plan's choice (staged by 16- or by 4-byte copies,
streamed), the passes or the fold not unrolled, the exponential loop not unrolled in the accurate modes or
unrolled by 2 in the fast ones.  ``--baseline`` builds another ``csrc/``
directory (the parent commit's) as the row ``baseline``: its kernels
through their own entry points (fewer plan arguments there).

Every row is held to the plain versions on ``check_cases`` (ragged,
short, offset and long rows, and ``row_edges``' rows: the +-0 max tie,
NaN, +inf, all -inf): ``ff_norm_stats`` and the accurate modes bit for
bit, the fast modes within 1 ulp, a NaN for a NaN.  Then each row is
timed by CUDA-graph replay at ``SHAPES``, in the order of the rows and
then in reverse (``ms`` holds both).  Each row also lists, per kernel
instance, its registers, spills and stack (``-Xptxas -v``), and the
shipped row the path each check case took.  The library calls
(``torch.var_mean``, ``torch.softmax``, ``torch.logsumexp``) are timed
once as the row ``yardsticks``.

``--calls`` builds nothing and times the wrappers of whichever
``repro_torch`` is imported at ``SHAPES``: a call from Python (``iters``
back to back between CUDA events) beside its kernel's CUDA-graph time,
and, where the wrappers plan, the host's microseconds a plan.  Run
against another checkout's ``src`` to compare the host's cost of two
wrappers in one call.  Needs a CUDA card and a checkout.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.benchmarks.math_variants import graph_ms
from repro_torch.benchmarks.stream_variants import (build_variants,
                                                    cuda_ms, offset_view,
                                                    ptxas_info)
from repro_torch.kernels import build
from repro_torch.kernels import ff_fused

LIBS = ("ff_softmax", "ff_norm_stats")
Edit = Tuple[str, str, str]
W_LINE = "  const int W = rows_per_block;\n"     # in both entry points


def entries(new: str) -> Tuple[Edit, ...]:
    """The edit of both entry points' rows-a-block line into ``new``."""
    return tuple((f"{lib}.cu", W_LINE, new) for lib in LIBS)


UNROLL_PASSES = ("ff_rows.cuh", "#pragma unroll 4\n  for (int j = t; j < "
                 "cols; j += kLanes) f(j);", "  for (int j = t; j < cols; "
                 "j += kLanes) f(j);")
EXP_ACCURATE = ("ff_softmax.cu", "#pragma unroll 2\n    for (int j = t; j < "
                "cols; j += kLanes) sum(j);\n    each_col(",
                "    for (int j = t; j < cols; j += kLanes) sum(j);\n"
                "    each_col(")
EXP_FAST = ("ff_softmax.cu", "  } else {\n    for (int j = t; j < cols; "
            "j += kLanes) sum(j);", "  } else {\n#pragma unroll 2\n    "
            "for (int j = t; j < cols; j += kLanes) sum(j);")
OWN_FOLD = ("ff_rows.cuh", "  if (static_cast<int>(threadIdx.x) < b.W) "
            "fold_scratch(b.sh(threadIdx.x));\n",
            "  if (t == 0) fold_scratch(sh);\n")
VARIANTS: Dict[str, Tuple[Edit, ...]] = {
    "shipped": (),
    "1 row a block": entries("  const int W = 1;\n"),
    "2 rows a block": entries("  const int W = 2;\n"),
    "4 rows a block": entries("  const int W = 4;\n"),
    "each row folds its own": (OWN_FOLD,),
    "staged everywhere": entries(
        W_LINE + "  path = cols % 4 == 0 && reinterpret_cast<size_t>(x) % "
        "16 == 0 ? kStaged16 : kStaged4;\n"),
    "4-byte copies everywhere": entries(W_LINE + "  path = kStaged4;\n"),
    "streamed everywhere": entries(W_LINE + "  path = kStreamed;\n"),
    "passes not unrolled": (UNROLL_PASSES,),
    "fold not unrolled": (("ff_rows.cuh", "#pragma unroll 8\n", ""),),
    "accurate exp loop not unrolled": (EXP_ACCURATE,),
    "fast exp loop unrolled 2": (EXP_FAST,),
}
# (mode, accurate) of each timed kernel; None: ff_norm_stats
KERNELS = (None, ("softmax", False), ("softmax", True), ("logsumexp", False),
           ("logsumexp", True))
SHAPES = ((4096, 4096), (512, 2048), (512, 8192), (64, 16384), (64, 2048),
          (64, 8192))


def edits_of(name: str) -> Tuple[Edit, ...]:
    return VARIANTS.get(name) or ()


def kernel_name(k) -> str:
    return "norm_stats" if k is None else k[0] + (" accurate" if k[1]
                                                  else "")


def instance_label(mangled: str) -> Optional[str]:
    """The kernel of an instance of the two libraries, else None."""
    m = re.search(r"softmax_kernelILb([01])ELb([01])E", mangled)
    if m:
        return (("softmax" if m.group(1) == "1" else "logsumexp")
                + (" accurate" if m.group(2) == "1" else ""))
    if "norm_stats_reread" in mangled:
        return "norm_stats reread"
    return "norm_stats" if "norm_stats_kernel" in mangled else None


# -- inputs -----------------------------------------------------------------

def row_edges(device, cols: int = 1000, seed: int = 0
              ) -> Dict[str, torch.Tensor]:
    """Rows at the edges of the row kernels' max and sums, each (R, C)
    f32: zeros of both signs among negatives (the max a +-0 tie), a lone
    -0 column and a [-0, +0] row, a NaN, a +inf, every element -inf, -inf
    among finite values; beside an ordinary row, so that a fault does not
    spread along the batch."""
    g = torch.Generator().manual_seed(seed)

    def rn(n):
        return torch.randn(n, generator=g) * 3.0

    tie = -rn(cols).abs()
    tie[::3] = 0.0
    tie[1::3] = -0.0
    nan, inf, minf = rn(cols), rn(cols), rn(cols)
    nan[cols // 2] = float("nan")
    inf[cols // 3] = float("inf")
    minf[::2] = float("-inf")
    rows = {"+-0 max tie": torch.stack([tie, rn(cols)]),
            "-0 column": torch.tensor([[-0.0]]),
            "-0, +0": torch.tensor([[-0.0, 0.0], [0.0, -0.0]]),
            "NaN": torch.stack([rn(cols), nan]),
            "+inf": torch.stack([inf, rn(cols)]),
            "all -inf": torch.stack([rn(cols),
                                     torch.full((cols,), float("-inf"))]),
            "-inf among finite": torch.stack([minf, rn(cols)])}
    return {k: v.to(device) for k, v in rows.items()}


def check_cases(g, device="cuda") -> List[Tuple[str, torch.Tensor]]:
    """(name, x) on ``device``: ragged rows (cols % 4 != 0), rows shorter
    than 128, rows offset 1-3 floats from a 16-byte boundary, rows of
    16384 columns (ragged and offset ones too), a shape of each timed
    width, enough rows for two a block, and ``row_edges``."""
    def rn(*shape):
        return torch.randn(shape, generator=g, device=device) * 3.0

    cases = [(f"{s}", rn(*s)) for s in ((5, 1001), (7, 3), (6, 100),
                                        (9, 20), (3, 16384), (3, 16383),
                                        (33, 4096), (17, 2048), (5, 8192),
                                        (301, 1001), (601, 100),
                                        (301, 4097), (3001, 2048))]
    cases += [(f"{shape} offset {o}", offset_view(rn(*shape), o))
              for shape in ((271, 2048), (271, 4096)) for o in (1, 2, 3)]
    cases += [("(2, 12000) offset 1", offset_view(rn(2, 12000), 1))]
    cases += [(f"edge: {k}", v) for k, v in row_edges(device).items()]
    return cases


def run_kernel(k, x):
    """The kernel ``k`` of ``KERNELS`` on x: its outputs as a tuple."""
    if k is None:
        return ff_fused.ff_norm_stats(x)
    return (ff_fused.ff_softmax(x, *k),)


def run_plain(k, x):
    if k is None:
        return ff_fused.ff_norm_stats_plain(x)
    return (ff_fused.ff_softmax_plain(x, *k),)


def ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance in f32 steps between a and b (a NaN matches a
    NaN; a NaN against a number is 2^32)."""
    na, nb = torch.isnan(a), torch.isnan(b)
    if a.shape != b.shape or not torch.equal(na, nb):
        return 1 << 32
    keep = ~na
    ia = a[keep].contiguous().view(torch.int32).long()
    ib = b[keep].contiguous().view(torch.int32).long()
    return int((ia - ib).abs().max()) if ia.numel() else 0


def tolerance(k) -> int:
    """Ulps a kernel may differ from its plain version: 0, 1 for expf."""
    return 1 if k is not None and not k[1] else 0


# -- rows -------------------------------------------------------------------

KEYS = {("ff_softmax", "ff_softmax_f32"): ff_fused._SOFTMAX_ARGTYPES,
        ("ff_norm_stats", "ff_norm_stats_f32"):
        ff_fused._NORM_STATS_ARGTYPES}


def entry_params(csrc: Path, lib: str, fn: str) -> List[str]:
    """The parameters of ``fn`` in ``csrc``'s ``lib``.cu."""
    src = (csrc / f"{lib}.cu").read_text()
    sig = re.search(r'extern "C" int ' + fn + r"\((.*?)\)\s*{", src, re.S)
    return [p.strip() for p in sig.group(1).split(",")]


def row_setup(name: str, lib_dir: Path,
              baseline_src: Optional[Path]) -> Callable[[], None]:
    """Swap row ``name``'s libraries in; returns the undo.  The
    baseline's entry points, where they take fewer plan arguments, get
    the call without the plan's (the two before the stream)."""
    saved = {key: build.entry(*key, argtypes) for key, argtypes in
             KEYS.items()}
    for (lib, fn), argtypes in KEYS.items():
        f = getattr(ctypes.CDLL(str(lib_dir / f"lib{lib}.so")), fn)
        f.restype = ctypes.c_int
        n = len(entry_params(baseline_src, lib, fn)) if name == "baseline" \
            else len(argtypes)
        f.argtypes = argtypes[:n - 1] + argtypes[-1:]
        build._ENTRIES[(lib, fn)] = f if n == len(argtypes) else (
            lambda *a, f=f, n=n: f(*a[:n - 1], a[-1]))

    def undo():
        build._ENTRIES.update(saved)
    return undo


def call_times(iters: int = 20) -> dict:
    """The wrappers of the imported ``repro_torch`` at ``SHAPES``: ms of
    a call from Python (the median of 15 means of ``iters`` calls back
    to back) and of its kernel."""
    g = torch.Generator(device="cuda").manual_seed(12)
    row = {"variant": "calls", "package": str(Path(ff_fused.__file__)),
           "card": torch.cuda.get_device_name(0), "ms": {}}
    for s in SHAPES:
        x = torch.randn(s, generator=g, device="cuda") * 3.0
        for k in KERNELS:
            calls = sorted(cuda_ms(lambda: run_kernel(k, x), iters)
                           for _ in range(15))
            row["ms"][f"{kernel_name(k)} {s}"] = {
                "call": calls[len(calls) // 2],
                "kernel": graph_ms(lambda: run_kernel(k, x), 20)}
    if hasattr(ff_fused, "_row_plan_of"):
        t0 = time.perf_counter()
        for _ in range(10000):
            ff_fused._row_plan_of(x, "norm_stats")
        row["plan_us"] = (time.perf_counter() - t0) / 10000 * 1e6
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*", default=list(VARIANTS))
    ap.add_argument("--baseline", help="another csrc/ directory, built and "
                    "timed as the row 'baseline'")
    ap.add_argument("--out", help="write the rows as JSON here")
    ap.add_argument("--calls", action="store_true",
                    help="only time the wrappers' calls (call_times)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("row_variants: no CUDA device", file=sys.stderr)
        return 2
    if args.calls:
        print(json.dumps(call_times()), flush=True)
        return 0
    unknown = set(args.names) - set(VARIANTS)
    if unknown:
        raise KeyError(f"variants {sorted(unknown)}; known: {list(VARIANTS)}")
    libs = build_variants(args.names, args.baseline, libs=LIBS,
                          edits_fn=edits_of, prefix="rows_")
    rows_of = list(args.names) + (["baseline"] if args.baseline else [])
    base = Path(args.baseline) if args.baseline else None
    card = torch.cuda.get_device_name(0)
    g = torch.Generator(device="cuda").manual_seed(12)
    cases = check_cases(g)
    want = {(name, kernel_name(k)): run_plain(k, x)
            for name, x in cases for k in KERNELS}
    rows = []
    for name in rows_of:
        d, logs = libs[name]
        undo = row_setup(name, d, base)
        bad, worst, paths = [], {}, {}
        try:
            for case, x in cases:
                for k in KERNELS:
                    kn = kernel_name(k)
                    u = max(ulps(a, b) for a, b in zip(
                        run_kernel(k, x), want[(case, kn)]))
                    worst[kn] = max(worst.get(kn, 0), u)
                    if u > tolerance(k):
                        bad.append(f"{kn} {case}: {u} ulp")
                    if name == "shipped":
                        paths.setdefault(case, {})[kn] = (
                            ff_fused.ff_norm_stats if k is None
                            else ff_fused.ff_softmax).last_path
            torch.cuda.synchronize()
        finally:
            undo()
        info = {}
        for lib in LIBS:
            info.update(ptxas_info(logs[lib], instance_label))
        row = {"variant": name, "bits_equal": not bad, "worst_ulp": worst,
               "card": card, "paths": paths, "ptxas": info,
               "warnings": [ln for lib in LIBS
                            for ln in logs[lib].splitlines()
                            if "warning" in ln.lower()], "ms": {}}
        rows.append(row)
        print(json.dumps({k: row[k] for k in ("variant", "bits_equal",
                                              "worst_ulp")}), flush=True)
        if bad:
            raise AssertionError(f"variant {name!r} is off its plain "
                                 f"versions: {bad[:10]}")
    xs = {s: torch.randn(s, generator=g, device="cuda") * 3.0
          for s in SHAPES}
    for order in (rows, rows[::-1]):
        for row in order:
            name = row["variant"]
            undo = row_setup(name, libs[name][0], base)
            try:
                for s, x in xs.items():
                    for k in KERNELS:
                        row["ms"].setdefault(f"{kernel_name(k)} {s}",
                                             []).append(graph_ms(
                            lambda: run_kernel(k, x), 20))
            finally:
                undo()
    for row in rows:
        print(json.dumps(row), flush=True)
    yard = {"variant": "yardsticks", "card": card, "ms": {}}
    for s, x in xs.items():
        for what, fn in (("torch.var_mean", lambda: torch.var_mean(
                x, -1, correction=0)),
                         ("torch.softmax", lambda: torch.softmax(x, -1)),
                         ("torch.logsumexp", lambda: torch.logsumexp(x, -1))):
            yard["ms"][f"{what} {s}"] = graph_ms(fn, 20)
    rows.append(yard)
    print(json.dumps(yard), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
