"""The ``ff_math`` kernel's erf, gelu, tanh, sigmoid, silu, pow, log1p,
expm1, log and exp design, one choice at a time, on the card::

    python -m repro_torch.benchmarks.math_variants [NAME ...] \\
        [--ops OP ...] [--baseline CSRC] [--sass] [--out rows.json]

Each variant is a copy of ``csrc/`` with one design choice undone (a text
edit of the sources, ``VARIANTS``), built with the port's ``nvcc`` flags
into ``build/variants/<name>/`` (all at once), then swapped in for the
``ff_math`` library: each function of ``--ops`` (default all ten) is
checked bit for bit against its plain version at (512, 8192), tanh also
on its band edges and a mixed tile, sigmoid and silu also on
``sigmoid_edges``, pow and log1p on ``log_pow_edges``, expm1, log and exp
on ``exp_log_edges``, and those seven on a strided view and a row plane
(pow also a column plane and a scalar b),
and timed by CUDA-graph replay at (4096, 4096) and (512, 8192) on
``|N(0,1)| + 0.5`` (the operators phase's input; pow's b ~ N(0,1));
erf also at (4096, 4096) on its argument uniform in each band, tanh on x
uniform in (-1, 1) (about 35% in its small band) and uniform in each
band, sigmoid and silu on x uniform in (-30, 30), log1p on x uniform in
its near band (-0.29, 0.41), at both shapes, and log1p on x uniform in
(-0.29, 1.2) (its two branches mixed in every warp), expm1 on x uniform in
(-0.34, 0.34) (its k == 0 branch) at both shapes and in (-1, 1) (both
branches), log on exp(U(-50, 50)) at both shapes.  Each row also lists
each kernel's registers and spill bytes (``-Xptxas -v``), the kernels whose
SASS differs from ``shipped``'s (``cuobjdump -sass``, addresses and
encodings dropped), and the loops of the sigmoid, silu, pow, log1p, expm1,
log and exp kernels with their f32 (FADD, FMUL, FFMA) and other instructions
(one element a pass) and the share of the IEEE divisions' code in them.
``shipped`` is the
sources as they are; ``--baseline`` builds another ``csrc/`` directory
(the parent commit's, say) as a row named ``baseline``, so that two
versions compare in one call, and lists each row's kernels whose SASS
differs from the baseline's.  ``--sass`` also prints the loops of each
variant's erf kernel.  Needs a CUDA card and a checkout (the variants
build into its ``build/``).
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import math
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

import torch

from repro_torch.core import ffmath
from repro_torch.core import transforms as T
from repro_torch.kernels import build
from repro_torch.kernels import ff_math as fm

# name: ((file, text, replacement), ...); every text must occur once
Edit = Tuple[str, str, str]
# tanh through the band-sorted kernel (tanh_band's three bands fit its four)
TANH_SORTED: Tuple[Edit, ...] = (
    ("ff_math.cu", "  if constexpr (OP == ERF) return ffk::erf_band(h);\n",
     "  if constexpr (OP == ERF) return ffk::erf_band(h);\n"
     "  else if constexpr (OP == TANH) return ffk::tanh_band(h);\n"),
    ("ff_math.cu",
     "  if (t.op == GELU) return launch_bands<GELU>(t, n, stream);\n",
     "  if (t.op == GELU) return launch_bands<GELU>(t, n, stream);\n"
     "  if (t.op == TANH) return launch_bands<TANH>(t, n, stream);\n"),
    ("ff_math.cu", "    case TANH: return launch<TANH>(t, grid, stream);\n",
     ""))
# sigmoid and silu on Dekker's TwoProd everywhere (the FMA twins unused)
SIGMOID_DEKKER: Tuple[Edit, ...] = (
    ("ff_math.cu", "return sigmoid22_fma(h, l);", "return sigmoid22(h, l);"),
    ("ff_math.cu", "return silu22_fma(h, l);", "return silu22(h, l);"))
# log1p and pow the same
LOG_POW_DEKKER: Tuple[Edit, ...] = (
    ("ff_math.cu", "return log1p22_fma(h, l);", "return log1p22(h, l);"),
    ("ff_math.cu", "return pow22_fma(h, l, bh, bl);",
     "return pow22(h, l, bh, bl);"))
# expm1, log and exp the same
EXPM1_LOG_DEKKER: Tuple[Edit, ...] = (
    ("ff_math.cu", "return expm122_fmapath(h, l);", "return expm122(h, l);"),
    ("ff_math.cu", "return log22_fmapath(h, l);", "return log22(h, l);"),
    ("ff_math.cu", "return exp22_fmapath(h, l);", "return exp22(h, l);"))
NO_FLAT: Tuple[Edit, ...] = (
    ("ff_math.cu", "constexpr bool kFlat = OP == EXP || OP == EXPM1 || "
     "OP == LOG ||\n"
     "    OP == SIGMOID || OP == SILU || OP == LOG1P || OP == POW;",
     "constexpr bool kFlat = false;"),)
# the flat loop of exp, expm1, log, log1p, sigmoid, silu and pow, and two
# alternatives to it
FLAT_LOOP = """      for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                         threadIdx.x;
           i < n; i += stride) {
        const ff2 v = flat_apply<OP>(t, i);
        t.out_hi[i] = v.hi;
        t.out_lo[i] = v.lo;
      }
"""
FLAT_32 = """      if (n < (1LL << 31)) {
        for (int i = blockIdx.x * blockDim.x + threadIdx.x;
             i < static_cast<int>(n); i += static_cast<int>(stride)) {
          const ff2 v = flat_apply<OP>(t, i);
          t.out_hi[i] = v.hi;
          t.out_lo[i] = v.lo;
        }
        return;
      }
""" + FLAT_LOOP
FLAT_TWO = """      for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                         threadIdx.x;
           i < n; i += 2 * stride) {
        const long long j = i + stride < n ? i + stride : i;
        const ff2 v = flat_apply<OP>(t, i);
        const ff2 w = flat_apply<OP>(t, j);
        t.out_hi[i] = v.hi;
        t.out_lo[i] = v.lo;
        t.out_hi[j] = w.hi;
        t.out_lo[j] = w.lo;
      }
"""
# log1p's branches each with its own atanh kernel (the far one log22_fma's)
LOG1P_SHARED = """  const bool near = xh >= -0x1.2bec32p-2f && xh <= 0x1.a82798p-2f;
  ff2 n = {xh, xl}, d, f = {0.0f, 0.0f};
  float ef = 0.0f;
  if (near) {
    d = add212(n, 2.0f);
  } else {
    const ff2 w = two_sum(xh, 1.0f);
    f = fast_two_sum(w.hi, add(w.lo, xl));
    ef = log_reduce(f.hi, f.lo, &n, &d);
  }
  float sh, u;
  const ff2 l = atanh2_fma(n, d, &sh, &u);
  if (near) {
    *ok = atanh_arg_ok(sh) && u != 0.0f;
    return l;
  }
  *ok = atanh_arg_ok(sh) || n.hi == 0.0f;
  return log_finish(f.hi, ef, l);
"""
LOG1P_APART = """  if (xh >= -0x1.2bec32p-2f && xh <= 0x1.a82798p-2f) {
    float sh, u;
    const ff2 l = atanh2_fma({xh, xl}, add212({xh, xl}, 2.0f), &sh, &u);
    *ok = atanh_arg_ok(sh) && u != 0.0f;
    return l;
  }
  const ff2 w = two_sum(xh, 1.0f);
  const ff2 f = fast_two_sum(w.hi, add(w.lo, xl));
  return log22_fma(f.hi, f.lo, ok);
"""
VARIANTS: Dict[str, Tuple[Edit, ...]] = {
    "shipped": (),
    # sigmoid, silu, log1p, pow, expm1, log and exp as they were before
    # their FMA paths: Dekker's TwoProd, the strided loop
    "dekker": SIGMOID_DEKKER + LOG_POW_DEKKER + EXPM1_LOG_DEKKER + NO_FLAT,
    # each TwoProd of sigmoid and silu checks its own product, operands and
    # zero error, and runs Dekker's out of line otherwise, in place of the
    # element's test on its reduced argument (a test of the product alone
    # is not enough: on lo limbs far beyond hi an operand's split
    # overflows under a product below 2^100)
    "per-product guard": (
        ("ff_eft.cuh", "// Mul22 and Div22 on two_prod_fma.\n",
         "__device__ __noinline__ ff2 two_prod_far(float a, float b) {\n"
         "  return two_prod(a, b);\n}\n"
         "__device__ __forceinline__ ff2 two_prod_guarded(float a, "
         "float b) {\n"
         "  ff2 t = two_prod_fma(a, b);\n"
         "  const float ax = fabsf(t.hi);\n"
         "  if (!(ax >= 0x1p-100f && ax < 0x1p+100f &&\n"
         "        fmaxf(fabsf(a), fabsf(b)) < 0x1p+100f) || t.lo == 0.0f)\n"
         "    t = two_prod_far(a, b);\n"
         "  return t;\n}\n\n"
         "// Mul22 and Div22 on two_prod_fma.\n"),
        ("ff_eft.cuh", "  ff2 t = two_prod_fma(a.hi, b.hi);\n  float u",
         "  ff2 t = two_prod_guarded(a.hi, b.hi);\n  float u"),
        ("ff_eft.cuh", "  ff2 t = two_prod_fma(ch, b.hi);\n",
         "  ff2 t = two_prod_guarded(ch, b.hi);\n"),
        ("ff_eft.cuh", "const ff2 t = two_prod_fma(xh, s.hi);",
         "const ff2 t = two_prod_guarded(xh, s.hi);"),
        ("ff_eft.cuh",
         "  *ok = ar <= 0.5f && (ar >= 0x1p-48f || ar == 0.0f);\n",
         "  *ok = true;\n"),
        ("ff_eft.cuh",
         "  if (!(ok && at >= 0x1p-100f && at < 0x1p+100f && u != 0.0f))\n",
         "  if (!ok)\n")),
    # the contiguous planes through for_each_element, as strided ones
    "no contiguous fast path": NO_FLAT,
    # the flat loop with a 32-bit index where the extent fits
    "flat 32-bit index": (("ff_math.cu", FLAT_LOOP, FLAT_32),),
    # two elements a thread and pass, for instruction-level parallelism
    "two elements a thread": (("ff_math.cu", FLAT_LOOP, FLAT_TWO),),
    # log1p's near and far branches each with its own atanh kernel
    "log1p branches apart": (("ff_eft.cuh", LOG1P_SHARED, LOG1P_APART),),
    # log1p22 out of line where log1p's test fails, as pow22 is
    "log1p far body out of line": (
        ("ff_eft.cuh", "// log1p22(xh, xl), bit for bit.",
         "__device__ __noinline__ ff2 log1p22_far(float xh, float xl) {\n"
         "  return log1p22(xh, xl);\n}\n\n// log1p22(xh, xl), bit for bit."),
        ("ff_eft.cuh", "  if (!ok) r = log1p22(xh, xl);\n",
         "  if (!ok) r = log1p22_far(xh, xl);\n")),
    # log22 out of line where log's test fails, as expm122 is
    "log far body out of line": (
        ("ff_eft.cuh", "__device__ __forceinline__ ff2 log22_fmapath(",
         "__device__ __noinline__ ff2 log22_far(float xh, float xl) {\n"
         "  return log22(xh, xl);\n}\n\n"
         "__device__ __forceinline__ ff2 log22_fmapath("),
        ("ff_eft.cuh", "  if (!ok) r = log22(xh, xl);\n",
         "  if (!ok) r = log22_far(xh, xl);\n")),
    # pow's log half on Dekker's TwoProd (log22), the FMA in its product
    # l b and in exp22 only
    "fma in exp only": (
        ("ff_eft.cuh", "  const ff2 l = log22_fma(ah, al, &lok);\n",
         "  const ff2 l = log22(ah, al);\n  lok = true;\n"),),
    # the FMA twins in exp_poly only: Dekker's TwoProd in the division and
    # in silu's last product (where the remaining time goes)
    "fma in exp_poly only": (
        ("ff_eft.cuh", "  ff2 t = two_prod_fma(ch, b.hi);\n",
         "  ff2 t = two_prod(ch, b.hi);\n"),
        ("ff_eft.cuh", "const ff2 t = two_prod_fma(xh, s.hi);",
         "const ff2 t = two_prod(xh, s.hi);")),
    # one thread an element in the grid-stride kernel: warps straddle bands
    "no band sort": (
        ("ff_math.cu",
         "  if (t.op == ERF) return launch_bands<ERF>(t, n, stream);\n"
         "  if (t.op == GELU) return launch_bands<GELU>(t, n, stream);\n",
         ""),
        ("ff_math.cu",
         "    case SILU: return launch<SILU>(t, grid, stream);\n",
         "    case ERF: return launch<ERF>(t, grid, stream);\n"
         "    case GELU: return launch<GELU>(t, grid, stream);\n"
         "    case SILU: return launch<SILU>(t, grid, stream);\n")),
    # __fdiv_rn for every division by an integer
    "IEEE division": (
        ("ff_eft.cuh",
         "  const float q0 = mul(a, zh);\n"
         "  const float q = __fmaf_rn(-__fmaf_rn(q0, df, -a), zh, q0);\n"
         "  return kFinite || fabsf(q0) != inf32() ? q : q0;\n",
         "  return dvd(a, df);\n"),
        ("ff_eft.cuh", "  if (d == 1) return a;\n",
         "  return dvd(a, static_cast<float>(d));\n")),
    # the guarded division in the series on every argument
    "guarded series": (
        ("ff_eft.cuh", "bounded ? erf_small<true>(xh, xl)",
         "bounded ? erf_small<false>(xh, xl)"),
        ("ff_eft.cuh", ": (bounded ? erf_mid<true>(axh, axl)",
         ": (bounded ? erf_mid<false>(axh, axl)")),
    # div22 and the guarded series inlined at every call
    "fallbacks inline": tuple(
        ("ff_eft.cuh", f"__device__ __noinline__ ff2 {fn}(",
         f"__device__ __forceinline__ ff2 {fn}(")
        for fn in ("div22_far", "erf_small_any", "erf_mid_any",
                   "sigmoid22_far", "silu22_far", "pow22_far",
                   "expm122_far", "exp22_far")),
    "mid series unrolled": (
        ("ff_eft.cuh", "#pragma unroll 4\n  for (int n = 1; n < kErfPosTerms",
         "#pragma unroll\n  for (int n = 1; n < kErfPosTerms"),),
    "mid series rolled": (
        ("ff_eft.cuh", "#pragma unroll 4\n  for (int n = 1; n < kErfPosTerms",
         "#pragma unroll 1\n  for (int n = 1; n < kErfPosTerms"),),
    "small series by 4": (
        ("ff_eft.cuh", "#pragma unroll\n  for (int n = 1; n < kErfAltTerms",
         "#pragma unroll 4\n  for (int n = 1; n < kErfAltTerms"),),
    "tiles of 1024": (
        ("ff_math.cu", "constexpr int kPer = 8;", "constexpr int kPer = 4;"),),
    # tanh's elements sorted by band, 32 consecutive a warp, as erf's
    "tanh band sort": TANH_SORTED,
    # the earlier tanh: both branches on every element, then the
    # selection
    "tanh both branches": (
        ("ff_eft.cuh", "expm122<true>(", "expm122("),
        ("ff_eft.cuh",
         "  switch (tanh_band(xh)) {\n"
         "    case kTanhIdentity: return {xh, xl};\n"
         "    case kTanhSmall: return tanh_small(xh, xl);\n"
         "    default: return tanh_large(xh, xl);\n"
         "  }\n",
         "  const ff2 sm = tanh_small(xh, xl);\n"
         "  const ff2 lg = tanh_large(xh, xl);\n"
         "  ff2 r = fabsf(xh) <= 0x1.666666p-2f ? sm : lg;\n"
         "  if (fabsf(xh) < kIdentity) return {xh, xl};\n"
         "  return r;\n")),
}

BANDS = {"small": (0.0, 1.0), "mid": (1.0, 4.0), "big": (4.0, 8.0)}
# tanh's two series' bands of |x| (the identity band below 2^-45 is empty
# at these sizes)
TANH_BANDS = {"small": (0.0, 0.35), "large": (0.3501, 8.0)}
OPS = ("erf", "gelu", "tanh", "sigmoid", "silu", "pow", "log1p", "expm1",
       "log", "exp")
F32_OPS = ("FADD", "FMUL", "FFMA")
# the kernel instances whose loops are counted
COUNTED = {"sigmoid": "math_kernelILi5E", "silu": "math_kernelILi8E",
           "pow": "math_kernelILi9E", "log1p": "math_kernelILi3E",
           "expm1": "math_kernelILi1E", "log": "math_kernelILi2E",
           "exp": "math_kernelILi0E"}


def graph_ms(fn, iters: int = 5) -> float:
    """Mean device ms of ``fn()`` over ``iters`` calls captured in one CUDA
    graph and replayed between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def variant_dir(name: str) -> Path:
    return build.ROOT / "build" / "variants" / name.replace(" ", "_")


def build_variants(names, baseline: Optional[str] = None) -> Dict[str, str]:
    """Build each variant's libff_math.so (and ``baseline``'s, from that
    csrc/ directory as it is); returns name -> nvcc log."""
    nvcc, procs = build._nvcc(), {}
    sources = {name: (build.CSRC, VARIANTS[name]) for name in names}
    if baseline:
        sources["baseline"] = (Path(baseline), ())
    for name, (src, edits) in sources.items():
        d = variant_dir(name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(src, d)
        for fname, old, new in edits:
            text = (d / fname).read_text()
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name!r}: {old!r} not found "
                                   f"once in {fname}")
            (d / fname).write_text(text.replace(old, new))
        cmd = [nvcc, *build.FLAGS, "-I", str(d), "-o",
               str(d / "libff_math.so"), str(d / "ff_math.cu")]
        procs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True))
    logs = {}
    for name, (d, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {name!r} failed to build:\n"
                               f"{logs[name][-4000:]}")
    return logs


def cuobjdump_sass(lib) -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return subprocess.run([os.path.join(home, "bin", "cuobjdump"), "-sass",
                           str(lib)], capture_output=True, text=True,
                          check=True).stdout


def sass_instructions(body: str) -> List[Tuple[int, str, str]]:
    """(address, opcode, operands) of each instruction of a function's
    SASS."""
    return [(int(m.group(1), 16), m.group(2), m.group(3)) for m in re.finditer(
        r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)([^;]*);",
        body)]


def loops(ins, least: int = 1) -> List[dict]:
    """The loops of one function's SASS, found by their backward branches:
    each one's address range, instruction count and opcode counts, with
    the f32 arithmetic (FADD, FMUL, FFMA) apart from the rest."""
    out = []
    for addr, op, rest in ins:
        t = re.search(r"0x([0-9a-f]+)", rest)
        if op.startswith("BRA") and t and int(t.group(1), 16) < addr:
            lo = int(t.group(1), 16)
            ops = collections.Counter(o.split(".")[0] for a, o, _ in ins
                                      if lo <= a <= addr)
            n = sum(ops.values())
            if n < least:
                continue
            f32 = sum(ops[o] for o in F32_OPS)
            body = [i for i in ins if lo <= i[0] <= addr]
            out.append({"from": hex(lo), "to": hex(addr), "instructions": n,
                        "f32": f32, "other": n - f32,
                        "fdiv": division_regions(body),
                        "ops": dict(ops.most_common(8)),
                        "other_ops": dict(collections.Counter(
                            {o: c for o, c in ops.items()
                             if o not in F32_OPS}).most_common(8))})
    return out


def division_regions(ins) -> dict:
    """The IEEE divisions (``__fdiv_rn``) among ``ins``: each one's code
    from its reciprocal (MUFU.RCP) through its range check (FCHK), the
    branch around the call of the slow path, to the BSYNC that rejoins it;
    the count of divisions, and the instructions of those regions (their
    union) with their f32 ones."""
    ops = [op for _a, op, _r in ins]
    mine = set()
    checks = [j for j, op in enumerate(ops) if op.startswith("FCHK")]
    for j in checks:
        lo = max((i for i in range(j) if ops[i].startswith("MUFU.RCP")),
                 default=j)
        hi = next((i for i in range(j, len(ops))
                   if ops[i].startswith("BSYNC")), j)
        mine.update(range(lo, hi + 1))
    return {"divisions": len(checks), "instructions": len(mine),
            "f32": sum(ops[i].split(".")[0] in F32_OPS for i in mine)}


def function_body(sass: str, name: str) -> str:
    body = sass[sass.index(name):]
    return body[:body.find("Function :")] if "Function :" in body else body


def sass_loops(lib) -> List[dict]:
    """The loops of the erf kernel's SASS."""
    sass = cuobjdump_sass(lib)
    name = ("band_kernelILi6E" if "band_kernelILi6E" in sass
            else "math_kernelILi6E")                        # ERF's instance
    return loops(sass_instructions(function_body(sass, name)))


def element_loops(sass: str) -> Dict[str, List[dict]]:
    """The loops of the COUNTED kernels (one element a pass; the flat loop
    over contiguous planes and for_each_element's two) of at least 64
    instructions."""
    return {op: loops(sass_instructions(function_body(sass, name)), 64)
            for op, name in COUNTED.items()}


def sass_functions(sass: str) -> Dict[str, str]:
    """Each function of the library's SASS, keyed by its name without the
    anonymous namespace's per-file tag, its body without addresses and
    encodings."""
    out = {}
    for part in sass.split("Function : ")[1:]:
        name, body = part.split("\n", 1)
        name = re.sub(r"\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "", name.strip())
        out[name] = "\n".join(
            re.sub(r"/\*[0-9a-fx]+\*/|/\* 0x[0-9a-f]+ \*/", "", ln).strip()
            for ln in body.splitlines()
            if ln.strip() and "/* 0x" not in ln.strip()[:6])
    return out


def registers(log: str) -> Dict[str, dict]:
    """Registers and spill bytes of each band-sorted and grid-stride kernel
    instance, by its op code (``-Xptxas -v``)."""
    out = {}
    for block in log.split("Compiling entry function")[1:]:
        m = re.search(r"(band_kernel|math_kernel)ILi(\d+)E",
                      block.split("\n", 1)[0])
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", block)
        if m and regs:
            out[f"{m.group(1)}<{m.group(2)}>"] = {
                "registers": int(regs.group(1)),
                "spill_bytes": (int(spill.group(1)) + int(spill.group(2))
                                if spill else None)}
    return out


def tanh_edges(device) -> Tuple[torch.Tensor, torch.Tensor]:
    """tanh's band edges as FF limbs: 0.35 (0x1.666666p-2) and 2^-45, each
    with its f32 neighbours, and 17 to 20, of both signs, each with lo 0,
    -0 and +-hi 2^-25; then +-0, +-inf and nan (lo 0)."""
    f = dict(dtype=torch.float32, device=device)
    e = torch.tensor([float.fromhex("0x1.666666p-2"), 2.0 ** -45], **f)
    h = torch.cat([e, torch.nextafter(e, torch.full_like(e, math.inf)),
                   torch.nextafter(e, torch.zeros_like(e)),
                   torch.tensor([17.0, 17.5, 18.0, 19.0, 20.0], **f)])
    h = torch.cat([h, -h])
    z = torch.zeros_like(h)
    spec = torch.tensor([0.0, -0.0, math.inf, -math.inf, math.nan], **f)
    return (torch.cat([h, h, h, h, spec]),
            torch.cat([z, -z, h * 2.0 ** -25, -h * 2.0 ** -25,
                       torch.zeros_like(spec)]))


def cancelling_lo(yh: torch.Tensor) -> torch.Tensor:
    """For exp22's argument hi limbs ``yh``, the lo limb near RN(k L3 -
    s.hi), s the reduction's TwoSum of yh - k L1 and -k L2: the reduced
    argument r = add212(s, RN(lo - k L3)) then cancels to s.lo, or to 0
    where that TwoSum is exact."""
    xc = yh.clamp(ffmath._EXP_CLIP_LO, ffmath._EXP_CLIP_HI)
    kf = torch.round(xc * ffmath._INV_LN2)
    sh, _ = T.two_sum(xc - kf * ffmath._EXP_L1, -(kf * ffmath._EXP_L2))
    return ((kf * ffmath._EXP_L3).double() - sh.double()).float()


def lo_forms(h) -> Tuple[np.ndarray, np.ndarray]:
    """f32 hi limbs ``h``, each with lo +0, -0 and +-hi 2^-25."""
    h = np.asarray(h, np.float32)
    s = (h * np.float32(2.0 ** -25)).astype(np.float32)
    z = np.zeros_like(h)
    return np.concatenate([h, h, h, h]), np.concatenate([z, -z, s, -s])


def lo_beyond(h) -> Tuple[np.ndarray, np.ndarray]:
    """f32 hi limbs ``h``, each with lo = +-hi 2^(-10, 0, 10, 60, 130)
    (the last inf)."""
    with np.errstate(over="ignore"):
        lo = np.concatenate([(h * np.float32(2.0 ** k)).astype(np.float32)
                             for k in (-10, 0, 10, 60, 130)])
    hh = np.tile(h, 5)
    return np.concatenate([hh, hh]), np.concatenate([lo, -lo])


def on_device(device, planes) -> Tuple[torch.Tensor, ...]:
    """numpy planes as contiguous f32 tensors on ``device``."""
    return tuple(torch.from_numpy(np.ascontiguousarray(p, np.float32))
                 .to(device) for p in planes)


def sigmoid_edges(device, seed: int = 0) -> Dict[str, Tuple[torch.Tensor,
                                                             torch.Tensor]]:
    """The edge classes of sigmoid22 and silu22 on the FMA TwoProd, as FF
    limbs (hi, lo) by class: where z = exp(-|x|) turns subnormal (x in
    (-110, -60)); FF x = +-k ln2 (k = 1..100, hi and its neighbours) with a
    lo that cancels the reduced argument to 0 or to a few ulps of the
    reduction's grid, and its neighbours, and for k = 0 hi + lo = +-2^-120
    to 2^-43; |x| from 2^-150 to 2^-40; lo
    limbs +0, -0 and +-hi 2^-25 on x uniform in (-30, 30); exact products
    (hi = m 2^e, m odd below 64, lo +-0: errors that are zeros of either
    sign); subnormal limbs; lo limbs beyond hi (up to hi 2^130, inf);
    +-0, +-inf and nan with lo +-0, and non-finite lo limbs.  Every class
    but the non-finite one also has lo +-0 and +-hi 2^-25 where that
    applies."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    out = {"z subnormal": lo_forms(rng.uniform(-110, -60, 512))}
    y = torch.tensor([-k * math.log(2.0) for k in range(1, 101)],
                     dtype=torch.float32)
    y = torch.cat([y, torch.nextafter(y, torch.full_like(y, -math.inf)),
                   torch.nextafter(y, torch.zeros_like(y))])
    base = cancelling_lo(y)
    ys, ls = [y], [base]
    for d in (1, 2):
        up = down = base
        for _ in range(d):
            up = torch.nextafter(up, torch.full_like(up, math.inf))
            down = torch.nextafter(down, torch.full_like(down, -math.inf))
        ys += [y, y]
        ls += [up, down]
    # k = 0: hi = 2^e, lo = -(hi - 2^(e-23)), so r = 2^(e-23), to 2^-120
    e = np.arange(-97, -20, dtype=np.float64)
    ys.append(torch.from_numpy(np.exp2(e).astype(f32)))
    ls.append(torch.from_numpy((-(np.exp2(e) - np.exp2(e - 23))).astype(f32)))
    yh, yl = torch.cat(ys).numpy(), torch.cat(ls).numpy()
    # x < 0 is y itself, x > 0 is -y (sigmoid's argument is -|x|)
    out["k ln2 cancelling"] = (np.concatenate([yh, -yh]),
                               np.concatenate([yl, -yl]))
    e = rng.integers(-150, -39, 512)
    tiny = np.ldexp(rng.uniform(1, 2, 512), e) * rng.choice([-1, 1], 512)
    out["tiny |x|"] = lo_forms(tiny.astype(f32))
    out["lo signed zeros"] = lo_forms(rng.uniform(-30, 30, 2048))
    m = np.arange(1, 64, 2, dtype=np.float64)
    r = (m[:, None] * 2.0 ** np.arange(-20, 7)[None, :]).ravel()
    r = np.concatenate([r, -r]).astype(f32)
    out["exact products"] = (np.concatenate([r, r]),
                             np.concatenate([np.zeros_like(r),
                                             -np.zeros_like(r)]))
    sub = np.ldexp(rng.uniform(1, 2, 128), rng.integers(-149, -126, 128))
    sub = (sub * rng.choice([-1, 1], 128)).astype(f32)
    hn = rng.uniform(-30, 30, 128).astype(f32)
    out["subnormal limbs"] = (np.concatenate([sub, hn, hn]),
                              np.concatenate([np.zeros_like(sub), sub, -sub]))
    out["lo beyond hi"] = lo_beyond(rng.uniform(-30, 30, 256).astype(f32))
    spec = np.array([0.0, -0.0, np.inf, -np.inf, np.nan], f32)
    fin = np.array([1.0, -2.0, 30.0], f32)
    bad = np.array([np.inf, -np.inf, np.nan], f32)
    out["non-finite"] = (np.concatenate([spec, spec, fin, fin, fin]),
                         np.concatenate([np.zeros(5, f32), -np.zeros(5, f32),
                                         bad, -bad, bad[::-1]]))
    return {k: on_device(device, v) for k, v in out.items()}


# log1p's near branch, [-0.2928932, 0.41421354] as f32, and the band
# chip_smoke times it on
LOG1P_NEAR = (float.fromhex("-0x1.2bec32p-2"), float.fromhex("0x1.a82798p-2"))
LOG1P_BAND = (-0.29, 0.41)


def log_pow_edges(device, seed: int = 0) -> Dict[str, Dict[str, Tuple[
        torch.Tensor, ...]]]:
    """The edge classes of pow22 and log1p22 on the FMA TwoProd:
    ``{"pow": {class: (ah, al, bh, bl)}, "log1p": {class: (xh, xl)}}``.

    pow: a = 1; a = 2^k with lo +-[1, 2) 2^(k-45 ... k-100) (log's s from
    2^-46 down to 2^-101); a near 1 with |b| in 2^100 ... 2^127 (b's split
    overflows); |b| in 2^-140 ... 2^-90 (the product l b below 2^-100);
    b ln a near +-89 and near -104 (the saturations); lo limbs beyond hi on
    a and on b (up to hi 2^130, inf); exact products (a = m 2^e, b = +-1,
    2, 3, 4, 1/2, lo +-0); subnormal limbs; +-0, +-inf and nan in every
    operand.  log1p: its near band with lo +0, -0 and +-hi 2^-25, and its
    edges with their neighbours; 1 + x = 2^k with lo as a's above; lo
    beyond hi on the near band (up to hi 2^130, and 2 + x near 0) and
    beyond it; the identity edge 2^-45; exact products; subnormal limbs;
    -1, below -1, +-0, +-inf and nan, and non-finite lo limbs."""
    rng = np.random.default_rng(seed)
    f32 = np.float32

    def pm(n):
        return rng.choice([-1.0, 1.0], n)

    def ff(x):                            # float64 -> (hi, lo)
        x = np.asarray(x, np.float64)
        h = x.astype(f32)
        with np.errstate(invalid="ignore"):
            lo = np.where(np.isfinite(x), x - h.astype(np.float64), 0.0)
        return h, lo.astype(f32)

    def tiny_lo(h, n):                    # +-[1, 2) 2^(k-45 ... k-100)
        k = np.floor(np.log2(np.abs(h.astype(np.float64))))
        return (np.ldexp(rng.uniform(1, 2, n), (k + rng.integers(-100, -44, n))
                         .astype(int)) * pm(n)).astype(f32)

    def b_of(n):                          # b uniform in (-8, 8), FF
        return ff(rng.uniform(-8, 8, n))

    pw, lp = {}, {}
    n = 512
    bh, bl = b_of(4 * n)
    ah = np.ones(4 * n, f32)
    al = np.concatenate([np.zeros(n, f32), -np.zeros(n, f32),
                         tiny_lo(ah[:2 * n], 2 * n)])
    ints = np.array([1, -1, 2, -2, 3, 0.5, -0.5, 100, 2.0 ** 100], f32)
    pw["a = 1"] = (np.concatenate([ah, np.ones(2 * ints.size, f32)]),
                   np.concatenate([al, np.zeros(2 * ints.size, f32)]),
                   np.concatenate([bh, ints, ints]),
                   np.concatenate([bl, np.zeros(ints.size, f32),
                                   -np.zeros(ints.size, f32)]))
    ah = np.ldexp(1.0, rng.integers(-40, 41, 4 * n)).astype(f32)
    bh, bl = b_of(4 * n)
    pw["a = 2^k, tiny lo"] = (ah, tiny_lo(ah, 4 * n), bh, bl)
    near1 = (1.0 + rng.uniform(-2.0 ** -20, 2.0 ** -20, 2 * n)).astype(f32)
    near1 = np.concatenate([near1, np.nextafter(np.ones(1, f32), f32(2)),
                            np.nextafter(np.ones(1, f32), f32(0))])
    m = near1.size
    big = (np.ldexp(rng.uniform(1, 2, m), rng.integers(100, 128, m))
           * pm(m)).astype(f32)
    pw["a near 1, |b| in 2^100-2^127"] = (
        np.concatenate([near1, near1]), np.zeros(2 * m, f32),
        np.concatenate([big, big]),
        np.concatenate([np.zeros(m, f32), (big * f32(2.0 ** -25))
                        .astype(f32)]))
    ah, al = ff(np.exp(rng.uniform(-3, 3, 2 * n)))
    tiny = (np.ldexp(rng.uniform(1, 2, 2 * n), rng.integers(-140, -89, 2 * n))
            * pm(2 * n)).astype(f32)
    pw["|b| in 2^-140-2^-90"] = (ah, al, tiny,
                                 (tiny * f32(2.0 ** -25)).astype(f32))
    a64 = np.exp(rng.uniform(-3, 3, 3 * n))
    a64 = np.where(np.abs(a64 - 1) < 1e-3, 2.0, a64)
    c = np.concatenate([rng.uniform(88, 90, n), rng.uniform(-90, -88, n),
                        rng.uniform(-105, -102, n)])
    ah, al = ff(a64)
    bh, bl = ff(c / np.log(ah.astype(np.float64) + al))
    pw["b ln a near 89, -89, -104"] = (ah, al, bh, bl)
    h = np.exp(rng.uniform(-3, 3, 256)).astype(f32)
    xh, xl = lo_beyond(h)
    bh, bl = b_of(xh.size)
    gh, gl = lo_beyond(rng.uniform(-8, 8, 256).astype(f32))
    ah2, al2 = ff(np.exp(rng.uniform(-3, 3, gh.size)))
    pw["lo beyond hi"] = (np.concatenate([xh, ah2]), np.concatenate([xl, al2]),
                          np.concatenate([bh, gh]), np.concatenate([bl, gl]))
    mo = np.arange(1, 64, 2, dtype=np.float64)
    am = (mo[:, None] * 2.0 ** np.arange(-10, 7)[None, :]).ravel().astype(f32)
    bs = np.array([1, -1, 2, -2, 3, -3, 4, 0.5, -0.5], f32)
    ah, bh = np.repeat(am, bs.size), np.tile(bs, am.size)
    z = np.zeros_like(ah)
    pw["exact products"] = (np.concatenate([ah, ah]), np.concatenate([z, -z]),
                            np.concatenate([bh, bh]), np.concatenate([-z, z]))
    sub = (np.ldexp(rng.uniform(1, 2, 128), rng.integers(-149, -126, 128))
           * pm(128)).astype(f32)
    an, al = ff(np.exp(rng.uniform(-3, 3, 128)))
    bn, bl = b_of(128)
    z = np.zeros(128, f32)
    pw["subnormal limbs"] = (
        np.concatenate([np.abs(sub), an, an, an, an]),
        np.concatenate([z, sub, al, al, al]),
        np.concatenate([bn, bn, sub, bn, sub * f32(2.0 ** 20)]),
        np.concatenate([bl, bl, z, sub, z]))
    spec = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 2.0, 0.5, -2.0], f32)
    sa, sb = np.repeat(spec, spec.size), np.tile(spec, spec.size)
    z = np.zeros_like(sa)
    bad = np.array([np.inf, -np.inf, np.nan], f32)
    fin = np.full(3, 1.5, f32)
    pw["non-finite"] = (np.concatenate([sa, sa, fin, fin]),
                        np.concatenate([z, -z, bad, z[:3]]),
                        np.concatenate([sb, sb, fin, fin]),
                        np.concatenate([z, -z, z[:3], bad]))

    lo_, hi_ = LOG1P_NEAR
    e = np.array([lo_, hi_], f32)
    e = np.concatenate([e, np.nextafter(e, f32(-1)), np.nextafter(e, f32(1))])
    lp["near band"] = lo_forms(np.concatenate([
        rng.uniform(lo_, hi_, 2 * n).astype(f32), e]))
    k = rng.integers(1, 21, 2 * n)
    xh = np.concatenate([np.ldexp(1.0, k) - 1.0,
                         -1.0 + np.ldexp(1.0, -rng.integers(1, 21, 2 * n))])
    xh = xh.astype(f32)
    one = (xh.astype(np.float64) + 1.0).astype(f32)
    lp["1 + x = 2^k, tiny lo"] = (xh, tiny_lo(one, xh.size))
    xh, xl = lo_beyond(rng.uniform(lo_, hi_, 256).astype(f32))
    h2 = rng.uniform(lo_, hi_, 2 * n).astype(f32)
    l2 = (-(2.0 + h2.astype(np.float64))
          + rng.uniform(-0.2, 0.2, 2 * n)).astype(f32)
    lp["near band, lo beyond hi"] = (np.concatenate([xh, h2]),
                                     np.concatenate([xl, l2]))
    lp["far, lo beyond hi"] = lo_beyond(np.concatenate([
        np.exp(rng.uniform(-1, 4, 128)), rng.uniform(-0.99, -0.3, 128)])
        .astype(f32))
    e = np.array([2.0 ** -45, -2.0 ** -45], f32)
    e = np.concatenate([e, np.nextafter(e, f32(0)),
                        np.nextafter(e, e * 2)])
    lp["identity edge"] = lo_forms(np.concatenate([
        e, (np.ldexp(rng.uniform(1, 2, 256), rng.integers(-46, -40, 256))
            * pm(256)).astype(f32)]))
    xm = np.concatenate([am, -am[am < 1]])
    z = np.zeros_like(xm)
    lp["exact products"] = (np.concatenate([xm, xm]), np.concatenate([z, -z]))
    hn = rng.uniform(-0.99, 4, 128).astype(f32)
    z = np.zeros(128, f32)
    lp["subnormal limbs"] = (np.concatenate([sub, hn, hn]),
                             np.concatenate([z, sub, -sub]))
    spec = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -1.0, -1.5, -2.0],
                    f32)
    fin = np.array([0.1, -0.2, 2.0], f32)
    lp["non-finite"] = (np.concatenate([spec, spec, fin, fin, fin]),
                        np.concatenate([np.zeros(8, f32), -np.zeros(8, f32),
                                        bad, -bad, bad[::-1]]))
    return {"pow": {k: on_device(device, v) for k, v in pw.items()},
            "log1p": {k: on_device(device, v) for k, v in lp.items()}}


def exp_log_edges(device, seed: int = 0) -> Dict[str, Dict[str, Tuple[
        torch.Tensor, torch.Tensor]]]:
    """The edge classes of expm122, log22 and exp22 on the FMA TwoProd:
    ``{"expm1": {class: (xh, xl)}, "log": {...}, "exp": {...}}``.

    expm1: |x| at the identity edge 2^-45 (and its neighbours, 2^-46 to
    2^-40); x at +-ln2/2, where k flips between 0 and +-1 (the f32 values
    within 8 ulps); FF x = k ln2 (k = +-1 ... +-127) whose reduced argument
    cancels below 2^-48 (``cancelling_lo``), and for k = 0 hi = 2^e, lo =
    -(hi - 2^(e-23)) (r = 2^(e-23), hi from 2^-45); x in (-ln2/2, ln2/2)
    with lo +-0 (k = -0 for x < 0); exact products (x = m 2^e, m odd below
    64, lo +-0; FF x = k ln2 + m 2^e: zero errors of either sign on both
    branches); lo beyond hi
    (up to hi 2^130, inf, and lo = -hi); the clip edges -105 and 89 and the
    overflow of exp from ~88.72, with their neighbours; subnormal limbs;
    +-0, +-inf and nan with lo +-0, and non-finite lo limbs.  log: x =
    2^k (1 + tiny) (hi = 2^k, lo = +-[1, 2) 2^(k-45 ... k-100): s from
    2^-46 down to 2^-101); powers of two (n.hi == 0) with lo +-0; x near
    1 and near the frexp seam sqrt2 with lo +0, -0 and +-hi 2^-25; exact
    products; lo beyond hi (up to hi 2^130, inf), and lo ~ -2 hi, where
    the atanh argument s is near +-2^6.8; subnormal hi limbs (and lo);
    +-0, negative, +-inf and nan hi limbs, and non-finite lo limbs; m =
    mh + ml near 3 and 1/3 (lo beyond hi), where |s| is near 1/2 and
    div22's quotient n.hi / d.hi and its s.hi fall on either side of it.
    (Near |s| = 2^-48 they cannot: m is then within 2^-46 of 1, so d.hi
    = 2 and n.lo = 0, and s.hi is the exact n.hi / 2.)  exp: +-0 and |x|
    around 2^-48 (2^-50 to 2^-46, and 2^-48 with its neighbours), where r
    is x; expm1's x = k ln2 whose r cancels (``cancelling_lo``), for k
    also -128 ... -150 (x down to -104), with expm1's k = 0 class; x in
    (-ln2/2, ln2/2) with lo +-0; exact products; lo beyond hi; the
    overflow from ~88.72 and the 89 clip, x at -103 and the -105 clip,
    with their neighbours; subnormal limbs; +-0, +-inf and nan with lo
    +-0, and non-finite lo limbs."""
    rng = np.random.default_rng(seed)
    f32 = np.float32

    def pm(n):
        return rng.choice([-1.0, 1.0], n)

    def around(v, ulps):                  # v and its f32 neighbours
        v = np.asarray(v, f32)
        out, up, down = [v], v, v
        for _ in range(ulps):
            up = np.nextafter(up, f32(np.inf))
            down = np.nextafter(down, f32(-np.inf))
            out += [up, down]
        return np.concatenate(out)

    def subnormal(n):
        return (np.ldexp(rng.uniform(1, 2, n), rng.integers(-149, -126, n))
                * pm(n)).astype(f32)

    spec = np.array([0.0, -0.0, np.inf, -np.inf, np.nan], f32)
    bad = np.array([np.inf, -np.inf, np.nan], f32)
    em, lg = {}, {}
    e = np.array([2.0 ** -45, -2.0 ** -45], f32)
    em["identity edge"] = lo_forms(np.concatenate([
        around(e, 2), (np.ldexp(rng.uniform(1, 2, 256),
                                rng.integers(-46, -40, 256))
                       * pm(256)).astype(f32)]))
    half = f32(math.log(2.0) / 2)
    em["x at +-ln2/2"] = lo_forms(around(np.array([half, -half], f32), 8))
    y = torch.tensor([k * math.log(2.0) for k in range(1, 128)]
                     + [-k * math.log(2.0) for k in range(1, 128)],
                     dtype=torch.float32)
    y = torch.cat([y, torch.nextafter(y, torch.full_like(y, -math.inf)),
                   torch.nextafter(y, torch.full_like(y, math.inf))])
    base = cancelling_lo(y)
    ys, ls = [y], [base]
    for d in (1, 2):
        up = down = base
        for _ in range(d):
            up = torch.nextafter(up, torch.full_like(up, math.inf))
            down = torch.nextafter(down, torch.full_like(down, -math.inf))
        ys += [y, y]
        ls += [up, down]
    k0 = np.arange(-45, -20, dtype=np.float64)   # k = 0, r = 2^(e-23)
    ys.append(torch.from_numpy(np.concatenate([np.exp2(k0), -np.exp2(k0)])
                               .astype(f32)))
    r0 = -(np.exp2(k0) - np.exp2(k0 - 23))
    ls.append(torch.from_numpy(np.concatenate([r0, -r0]).astype(f32)))
    em["r cancelling near k ln2"] = (torch.cat(ys).numpy(),
                                     torch.cat(ls).numpy())
    x = rng.uniform(-half, half, 1024).astype(f32)
    z = np.zeros_like(x)
    em["k = 0, lo +-0"] = (np.concatenate([x, x]), np.concatenate([z, -z]))
    m = np.arange(1, 64, 2, dtype=np.float64)
    r = (m[:, None] * 2.0 ** np.arange(-44, 6)[None, :]).ravel()
    r = np.concatenate([r, -r])
    r = r[np.abs(r) < 88].astype(f32)
    z = np.zeros_like(r)
    # and FF x = k ln2 + r with a short r = m 2^e (k != 0)
    r0 = (m[:, None] * 2.0 ** np.arange(-16, -7)[None, :]).ravel()
    kl = np.array([1, 2, 5, 17, -1, -2, -5, -17])[:, None] * (
        ffmath._EXP_L1 + ffmath._EXP_L2 + float(f32(ffmath._EXP_L3)))
    xk = (kl + np.concatenate([r0, -r0])[None, :]).ravel()
    hk = xk.astype(f32)
    em["exact products"] = (np.concatenate([r, r, hk]),
                            np.concatenate([z, -z, (xk - hk).astype(f32)]))
    h = rng.uniform(-20, 20, 256).astype(f32)
    xh, xl = lo_beyond(np.concatenate([h, rng.uniform(-half, half, 64)
                                    .astype(f32)]))
    em["lo beyond hi"] = (xh, xl)
    clip = np.array([-105.0, 89.0, 88.72283935546875, -103.97, 88.0], f32)
    em["clip edges"] = lo_forms(around(clip, 3))
    sub = subnormal(128)
    hn = rng.uniform(-20, 20, 128).astype(f32)
    em["subnormal limbs"] = (np.concatenate([sub, hn, hn]),
                             np.concatenate([np.zeros(128, f32), sub, -sub]))
    fin = np.array([0.1, -0.2, 2.0], f32)
    em["non-finite"] = (np.concatenate([spec, spec, fin, fin, fin]),
                        np.concatenate([np.zeros(5, f32), -np.zeros(5, f32),
                                        bad, -bad, bad[::-1]]))

    k = rng.integers(-126, 128, 1024)
    hi = np.ldexp(1.0, k).astype(f32)
    tiny = (np.ldexp(rng.uniform(1, 2, 1024),
                     k + rng.integers(-100, -44, 1024)) * pm(1024)).astype(f32)
    lg["2^k (1 + tiny)"] = (hi, tiny)
    hi = np.ldexp(1.0, np.arange(-126, 128)).astype(f32)
    z = np.zeros_like(hi)
    lg["powers of two"] = (np.concatenate([hi, hi]), np.concatenate([z, -z]))
    near = np.concatenate([
        rng.uniform(0.7, 1.42, 1024),
        np.sqrt(2.0) * (1 + rng.uniform(-2.0 ** -20, 2.0 ** -20, 256)),
        1.0 + rng.uniform(-2.0 ** -20, 2.0 ** -20, 256)]).astype(f32)
    lg["near 1 and sqrt2"] = lo_forms(np.concatenate([near, around(
        np.array([1.0, math.sqrt(2.0), math.sqrt(0.5)], f32), 3)]))
    xm = (m[:, None] * 2.0 ** np.arange(-30, 20)[None, :]).ravel().astype(f32)
    z = np.zeros_like(xm)
    lg["exact products"] = (np.concatenate([xm, xm]), np.concatenate([z, -z]))
    lg["lo beyond hi"] = lo_beyond(np.exp(rng.uniform(-20, 20, 256))
                                   .astype(f32))
    # m = mh + ml = (1 + s) / (1 - s) for |s| in 2^6.6 ... 2^7: the atanh
    # kernel's a.hi passes 2^116, where Dekker's split overflows
    mh = rng.uniform(1.0, 1.4, 512).astype(f32)
    t = np.exp2(rng.uniform(6.6, 7.0, 512)) * pm(512)
    sc = np.ldexp(1.0, rng.integers(-20, 21, 512))
    lg["lo ~ -2 hi (s near +-2^6.8)"] = (
        (mh * sc).astype(f32),
        (((1 + t) / (1 - t) - mh.astype(np.float64)) * sc).astype(f32))
    sub = np.abs(subnormal(128))
    hn = np.exp(rng.uniform(-20, 20, 128)).astype(f32)
    lg["subnormal limbs"] = (np.concatenate([sub, hn, hn]),
                             np.concatenate([np.zeros(128, f32), sub, -sub]))
    neg = -np.exp(rng.uniform(-5, 5, 64)).astype(f32)
    lg["non-finite, zero, negative"] = (
        np.concatenate([spec, spec, neg, fin[[0, 2]], fin[[0, 2]],
                        fin[[0, 2]]]),
        np.concatenate([np.zeros(5, f32), -np.zeros(5, f32),
                        np.zeros(64, f32), bad[:2], -bad[:2], bad[1:]]))
    # m = mh + ml within 2^-21 of 3 and of 1/3, where s = +-1/2: d.hi is
    # no power of two, so the quotient ch = n.hi / d.hi and s.hi =
    # RN(ch + cl) often fall on either side of the test's 1/2
    mh = rng.uniform(0.75, 1.4, 1024).astype(f32)
    t = np.repeat([3.0, 1.0 / 3.0], 512) * (
        1 + rng.uniform(-2.0 ** -21, 2.0 ** -21, 1024))
    sc = np.ldexp(1.0, rng.integers(-20, 21, 1024))
    lg["|s| near 1/2 (lo beyond hi)"] = (
        (mh * sc).astype(f32), ((t - mh.astype(np.float64)) * sc)
        .astype(f32))
    ex = {}
    e = np.ldexp(rng.uniform(1, 2, 256), rng.integers(-50, -45, 256)) * pm(256)
    ex["+-0, |x| around 2^-48"] = lo_forms(np.concatenate([
        np.array([0.0, -0.0], f32),
        around(np.array([2.0 ** -48, -2.0 ** -48], f32), 2), e.astype(f32)]))
    y = torch.tensor([-k * math.log(2.0) for k in range(128, 151)],
                     dtype=torch.float32)
    y = torch.cat([y, torch.nextafter(y, torch.full_like(y, -math.inf)),
                   torch.nextafter(y, torch.full_like(y, math.inf))])
    base = cancelling_lo(y)
    xh, xl = em["r cancelling near k ln2"]
    ex["r cancelling near k ln2"] = (
        np.concatenate([xh, y.numpy(), y.numpy()]),
        np.concatenate([xl, base.numpy(), torch.nextafter(
            base, torch.full_like(base, math.inf)).numpy()]))
    for k in ("k = 0, lo +-0", "exact products", "lo beyond hi",
              "subnormal limbs", "non-finite"):
        ex[k] = em[k]
    clip = np.array([88.72283935546875, 89.0, -103.0, -105.0, 88.0,
                     -87.33654], f32)
    ex["overflow and clip edges"] = lo_forms(around(clip, 3))
    return {"expm1": {k: on_device(device, v) for k, v in em.items()},
            "log": {k: on_device(device, v) for k, v in lg.items()},
            "exp": {k: on_device(device, v) for k, v in ex.items()}}


def dekker_elements(op: str, xh: torch.Tensor,
                    xl: torch.Tensor) -> torch.Tensor:
    """Where the ff_math kernel's exp, expm1 or log sends an element to the
    Dekker body (exp22 / expm122 / log22): the host's emulation of its
    element test, bit for bit (the FMA's product through float64, rounded
    once).  exp and expm1 (one test, exp22_fma's): exp's reduced argument r
    off |r.hi| <= 1/2 and (|r.hi| >= 2^-48 or r.hi == 0), nan reduced as
    -105 (CUDA's fminf / fmaxf); log:
    the atanh argument s = div22_fma(n, d) off 2^-48 <= |s.hi| <= 1/2,
    unless n.hi == 0.  The CPU tests take their emulated paths' test from
    here; chip_smoke.py holds it to the card's own (csrc/ff_math_paths.cu)
    on every edge class."""
    from repro_torch.core import ff as core_ff
    from repro_torch.core.ff import FF
    if op in ("exp", "expm1"):
        xc = torch.where(xh != xh, ffmath._EXP_CLIP_LO, xh)
        rh = ffmath._exp_reduce(xc, xl)[0].abs()
        return ~((rh <= 0.5) & ((rh >= 2.0 ** -48) | (rh == 0)))
    if op != "log":
        raise KeyError(f"dekker_elements: {op!r} (exp, expm1 or log)")
    mh, ml, _e = ffmath._frexp_sqrt2(xh, xl)
    n = core_ff.add212(FF(mh, ml), -1.0)
    d = core_ff.add212(FF(mh, ml), 1.0)
    ch = n.hi / d.hi                                  # div22_fma
    th = ch * d.hi
    tl = (ch.double() * d.hi.double() - th.double()).float()
    cl = ((((n.hi - th) - tl) + n.lo) - ch * d.lo) / d.hi
    sh = (ch + cl).abs()                              # fast_two_sum's hi
    return ~(((sh <= 0.5) & (sh >= 2.0 ** -48)) | (n.hi == 0))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*", default=list(VARIANTS))
    ap.add_argument("--ops", nargs="+", choices=OPS, default=list(OPS),
                    help="the functions to check and time (default all)")
    ap.add_argument("--baseline", help="another csrc/ directory, built and "
                    "timed as the row 'baseline'")
    ap.add_argument("--out", help="write the rows as JSON here")
    ap.add_argument("--sass", action="store_true",
                    help="also print the loops of each erf kernel's SASS")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("math_variants: no CUDA device", file=sys.stderr)
        return 2
    unknown = set(args.names) - set(VARIANTS)
    if unknown:
        raise KeyError(f"variants {sorted(unknown)}; known: {list(VARIANTS)}")
    names = ["shipped"] + [n for n in args.names if n != "shipped"]
    logs = build_variants(names, args.baseline)
    rows_of = list(args.names) + (["baseline"] if args.baseline else [])
    lib_of = {n: variant_dir(n) / "libff_math.so" for n in logs}
    if args.sass:
        for name in rows_of:
            for loop in sass_loops(lib_of[name]):
                print(json.dumps({"variant": name, **loop}), flush=True)
    base_sass = sass_functions(cuobjdump_sass(lib_of["shipped"]))
    parent_sass = (sass_functions(cuobjdump_sass(lib_of["baseline"]))
                   if args.baseline else None)
    g = torch.Generator(device="cuda").manual_seed(5)

    def limbs(h):
        return h, h * 1e-8 * torch.randn(h.shape, generator=g, device="cuda")

    def mixed(shape):
        return limbs(torch.randn(shape, generator=g, device="cuda").abs()
                     + 0.5)

    def band(b0, b1, shape=(4096, 4096)):
        u = torch.rand(shape, generator=g, device="cuda", dtype=torch.float64)
        return limbs((b0 + (b1 - b0) * (1.0 - u)).float())

    ops = args.ops
    uniform = limbs(torch.rand((4096, 4096), generator=g, device="cuda") * 2
                    - 1)
    wide = {s: limbs(torch.rand(s, generator=g, device="cuda") * 60 - 30)
            for s in ((4096, 4096), (512, 8192))}
    inputs = {"4096x4096": mixed((4096, 4096)), "512x8192": mixed((512, 8192))}
    # pow's exponent b ~ N(0, 1), as the operators phase times it
    expo = {k: limbs(torch.randn(v[0].shape, generator=g, device="cuda"))
            for k, v in inputs.items()}
    timed = {op: {k: v + expo[k] if op == "pow" else v
                  for k, v in inputs.items()} for op in ops}
    if "erf" in ops:
        timed["erf"].update({f"{k} band": band(*v) for k, v in BANDS.items()})
    if "tanh" in ops:
        timed["tanh"].update({"uniform (-1, 1)": uniform, **{
            f"{k} band": band(*v) for k, v in TANH_BANDS.items()}})
    for op in {"sigmoid", "silu"} & set(ops):
        timed[op].update({f"uniform (-30, 30) {s[0]}x{s[1]}": v
                          for s, v in wide.items()})
    if "log1p" in ops:
        timed["log1p"].update({f"near band {s[0]}x{s[1]}": band(
            *LOG1P_BAND, s) for s in ((4096, 4096), (512, 8192))})
        # near and far branches about evenly mixed in every warp
        timed["log1p"]["uniform (-0.29, 1.2) 4096x4096"] = band(-0.29, 1.2)
    if "expm1" in ops:
        timed["expm1"].update({f"k == 0 (-0.34, 0.34) {s[0]}x{s[1]}": band(
            -0.34, 0.34, s) for s in ((4096, 4096), (512, 8192))})
        # k == 0 where |x| < ln2/2 (about a third), k = +-1 beyond
        timed["expm1"]["uniform (-1, 1) 4096x4096"] = band(-1.0, 1.0)
    if "log" in ops:
        for s in ((4096, 4096), (512, 8192)):
            u = torch.rand(s, generator=g, device="cuda", dtype=torch.float64)
            timed["log"][f"exp(U(-50, 50)) {s[0]}x{s[1]}"] = limbs(
                torch.exp(100.0 * u - 50.0).float())
    check = mixed((512, 8192))
    checks = {op: [check + expo["512x8192"] if op == "pow" else check]
              for op in ops}
    if "tanh" in ops:
        checks["tanh"] += [tanh_edges("cuda"),
                           tuple(x[:512] for x in uniform)]
    edges = sigmoid_edges("cuda")
    eh = torch.cat([h for h, _ in edges.values()])
    el = torch.cat([lo for _, lo in edges.values()])
    wh, wl = wide[(512, 8192)]
    for op in {"sigmoid", "silu"} & set(ops):
        checks[op] += [(eh, el), (wh[:, ::3], wl[:, ::3]), (wh, wl[:1])]
    # pow, log1p, expm1, log and exp: the edge classes, a strided view and
    # a row lo plane; pow also a column and a scalar b
    lp = {**log_pow_edges("cuda"), **exp_log_edges("cuda")}
    for op in {"pow", "log1p", "expm1", "log", "exp"} & set(ops):
        c = checks[op][0]
        checks[op] += [tuple(torch.cat(p) for p in zip(*lp[op].values())),
                       tuple(x[:, 1::3] for x in c),
                       (c[0], c[1][:1]) + c[2:]]
    if "pow" in ops:
        ah, al, bh, bl = checks["pow"][0]
        checks["pow"] += [(ah, al, bh[:, :1], bl[:, :1]),
                          (ah, al, bh[0, 0], bl[0, 0])]
    want = {op: [fm.math_elementwise_plain(op, *c) for c in cs]
            for op, cs in checks.items()}
    key = ("ff_math", "ff_math_f32")
    shipped = build.entry(*key, [ctypes.c_void_p, ctypes.c_void_p])
    card = torch.cuda.get_device_name(0)
    rows = []
    try:
        for name in rows_of:
            fn = ctypes.CDLL(str(lib_of[name])).ff_math_f32
            fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_void_p], \
                ctypes.c_int
            build._ENTRIES[key] = fn     # math_elementwise launches this one
            same = all(same_bits(a, b)
                       for op, cs in checks.items()
                       for c, w in zip(cs, want[op])
                       for a, b in zip(fm.math_elementwise(op, *c), w))
            text = cuobjdump_sass(lib_of[name])
            sass = sass_functions(text)
            row = {"variant": name, "bits_equal": same, "card": card,
                   "registers": registers(logs[name]),
                   "sass_differs_from_shipped": sorted(
                       k for k in set(sass) | set(base_sass)
                       if sass.get(k) != base_sass.get(k)),
                   "element_loops": element_loops(text)}
            if parent_sass is not None:
                row["sass_differs_from_baseline"] = sorted(
                    k for k in set(sass) | set(parent_sass)
                    if sass.get(k) != parent_sass.get(k))
            for op in ops:
                for what, planes in timed[op].items():
                    row[f"{op} {what}"] = graph_ms(
                        lambda: fm.math_elementwise(op, *planes))
            rows.append(row)
            print(json.dumps(row), flush=True)
            if not same:
                raise AssertionError(f"variant {name!r} changed the bits")
    finally:
        build._ENTRIES[key] = shipped
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


def same_bits(a, b) -> bool:
    """The same bits; a NaN matches any NaN."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb) and (
        (a.contiguous().view(torch.int32) == b.contiguous().view(torch.int32))
        | na).all())


if __name__ == "__main__":
    sys.exit(main())
