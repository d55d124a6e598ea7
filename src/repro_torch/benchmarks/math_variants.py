"""The ``ff_math`` kernel's erf and gelu design, one choice at a time, on
the card::

    python -m repro_torch.benchmarks.math_variants [NAME ...] [--sass] \\
        [--out rows.json]

Each variant is a copy of ``csrc/`` with one design choice undone (a text
edit of the sources, ``VARIANTS``), built with the port's ``nvcc`` flags
into ``build/variants/<name>/`` (all at once), then swapped in for the
``ff_math`` library: erf and gelu are checked bit for bit against their
plain versions at (512, 8192), and timed by CUDA-graph replay at
(4096, 4096) and (512, 8192) on ``|N(0,1)| + 0.5`` (the operators phase's
input) and at (4096, 4096) on erf's argument uniform in each band.
``shipped`` is the sources as they are.  ``--sass`` also prints the
loops of each variant's erf kernel (``cuobjdump -sass``: instructions and
opcodes per loop).  Needs a CUDA card and a checkout (the variants build
into its ``build/``).
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
from typing import Dict, List, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ff_math as fm

# name: ((file, text, replacement), ...); every text must occur once
Edit = Tuple[str, str, str]
VARIANTS: Dict[str, Tuple[Edit, ...]] = {
    "shipped": (),
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
        for fn in ("div22_far", "erf_small_any", "erf_mid_any")),
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
}

BANDS = {"small": (0.0, 1.0), "mid": (1.0, 4.0), "big": (4.0, 8.0)}


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


def build_variants(names) -> Dict[str, str]:
    """Build each variant's libff_math.so; returns name -> nvcc log."""
    nvcc, procs = build._nvcc(), {}
    for name in names:
        d = build.ROOT / "build" / "variants" / name.replace(" ", "_")
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(build.CSRC, d)
        for fname, old, new in VARIANTS[name]:
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


def sass_loops(lib) -> List[dict]:
    """The loops of the erf kernel's SASS (``cuobjdump -sass``), found by
    their backward branches: each one's address range, instruction count
    and opcode counts."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    sass = subprocess.run([os.path.join(home, "bin", "cuobjdump"), "-sass",
                           str(lib)], capture_output=True, text=True,
                          check=True).stdout
    name = ("band_kernelILi6E" if "band_kernelILi6E" in sass
            else "math_kernelILi6E")                        # ERF's instance
    body = sass[sass.index(name):]
    body = body[:body.find("Function :")] if "Function :" in body else body
    ins = [(int(m.group(1), 16), m.group(2), m.group(3)) for m in re.finditer(
        r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)([^;]*);",
        body)]
    loops = []
    for addr, op, rest in ins:
        t = re.search(r"0x([0-9a-f]+)", rest)
        if op.startswith("BRA") and t and int(t.group(1), 16) < addr:
            lo = int(t.group(1), 16)
            ops = collections.Counter(o.split(".")[0] for a, o, _ in ins
                                      if lo <= a <= addr)
            loops.append({"from": hex(lo), "to": hex(addr),
                          "instructions": sum(ops.values()),
                          "ops": dict(ops.most_common(8))})
    return loops


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*", default=list(VARIANTS))
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
    logs = build_variants(args.names)
    if args.sass:
        for name in args.names:
            d = build.ROOT / "build" / "variants" / name.replace(" ", "_")
            for loop in sass_loops(d / "libff_math.so"):
                print(json.dumps({"variant": name, **loop}), flush=True)
    g = torch.Generator(device="cuda").manual_seed(5)

    def limbs(h):
        return h, h * 1e-8 * torch.randn(h.shape, generator=g, device="cuda")

    def mixed(shape):
        return limbs(torch.randn(shape, generator=g, device="cuda").abs()
                     + 0.5)

    def band(b0, b1, shape=(4096, 4096)):
        u = torch.rand(shape, generator=g, device="cuda", dtype=torch.float64)
        return limbs((b0 + (b1 - b0) * (1.0 - u)).float())

    inputs = {"4096x4096": mixed((4096, 4096)), "512x8192": mixed((512, 8192)),
              **{f"{k} band": band(*v) for k, v in BANDS.items()}}
    check = mixed((512, 8192))
    want = {op: fm.math_elementwise_plain(op, *check)
            for op in ("erf", "gelu")}
    key = ("ff_math", "ff_math_f32")
    shipped = build.entry(*key, [ctypes.c_void_p, ctypes.c_void_p])
    card = torch.cuda.get_device_name(0)
    rows = []
    try:
        for name in args.names:
            d = build.ROOT / "build" / "variants" / name.replace(" ", "_")
            fn = ctypes.CDLL(str(d / "libff_math.so")).ff_math_f32
            fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_void_p], \
                ctypes.c_int
            build._ENTRIES[key] = fn     # math_elementwise launches this one
            same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                       for op in ("erf", "gelu")
                       for a, b in zip(fm.math_elementwise(op, *check),
                                       want[op]))
            row = {"variant": name, "bits_equal": same, "card": card,
                   "registers": [ln.split("Used ")[1].split(" ")[0]
                                 for ln in logs[name].splitlines()
                                 if "Used" in ln][-3:]}
            for what, (h, lo) in inputs.items():
                for op in ("erf", "gelu"):
                    if what.endswith("band") and op == "gelu":
                        continue
                    row[f"{op} {what}"] = graph_ms(
                        lambda: fm.math_elementwise(op, h, lo))
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


if __name__ == "__main__":
    sys.exit(main())
