"""The ``ff_math`` kernel's erf, gelu and tanh design, one choice at a
time, on the card::

    python -m repro_torch.benchmarks.math_variants [NAME ...] [--sass] \\
        [--out rows.json]

Each variant is a copy of ``csrc/`` with one design choice undone (a text
edit of the sources, ``VARIANTS``), built with the port's ``nvcc`` flags
into ``build/variants/<name>/`` (all at once), then swapped in for the
``ff_math`` library: erf, gelu and tanh are checked bit for bit against
their plain versions at (512, 8192) and tanh also on its band edges and
a mixed tile, and timed by CUDA-graph replay at (4096, 4096) and (512,
8192) on ``|N(0,1)| + 0.5`` (the operators phase's input), erf at (4096,
4096) on its argument uniform in each band, and tanh at (4096, 4096) on
x uniform in (-1, 1) (about 35% in its small band) and uniform in each
band.  Each row also lists the kernels whose SASS differs from
``shipped``'s (``cuobjdump -sass``, addresses and encodings dropped).
``shipped`` is the sources as they are.  ``--sass`` also prints the
loops of each variant's erf kernel (instructions and opcodes per loop).
Needs a CUDA card and a checkout (the variants build into its
``build/``).
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
from typing import Dict, List, Tuple

import torch

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


def sass_functions(lib) -> Dict[str, str]:
    """Each function of the library's SASS (``cuobjdump -sass``), keyed by
    its name without the anonymous namespace's per-file tag, its body
    without addresses and encodings."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    sass = subprocess.run([os.path.join(home, "bin", "cuobjdump"), "-sass",
                           str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for part in sass.split("Function : ")[1:]:
        name, body = part.split("\n", 1)
        name = re.sub(r"\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "", name.strip())
        out[name] = "\n".join(
            re.sub(r"/\*[0-9a-fx]+\*/|/\* 0x[0-9a-f]+ \*/", "", ln).strip()
            for ln in body.splitlines()
            if ln.strip() and "/* 0x" not in ln.strip()[:6])
    return out


def registers(log: str) -> Dict[str, int]:
    """Registers of each band-sorted and grid-stride kernel instance, by
    its op code (``-Xptxas -v``)."""
    out = {}
    for block in log.split("Compiling entry function")[1:]:
        m = re.search(r"(band_kernel|math_kernel)ILi(\d+)E",
                      block.split("\n", 1)[0])
        regs = re.search(r"Used (\d+) registers", block)
        if m and regs:
            out[f"{m.group(1)}<{m.group(2)}>"] = int(regs.group(1))
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
    names = ["shipped"] + [n for n in args.names if n != "shipped"]
    logs = build_variants(names)
    lib_of = {n: build.ROOT / "build" / "variants" / n.replace(" ", "_")
              / "libff_math.so" for n in names}
    if args.sass:
        for name in args.names:
            for loop in sass_loops(lib_of[name]):
                print(json.dumps({"variant": name, **loop}), flush=True)
    base_sass = sass_functions(lib_of["shipped"])
    g = torch.Generator(device="cuda").manual_seed(5)

    def limbs(h):
        return h, h * 1e-8 * torch.randn(h.shape, generator=g, device="cuda")

    def mixed(shape):
        return limbs(torch.randn(shape, generator=g, device="cuda").abs()
                     + 0.5)

    def band(b0, b1, shape=(4096, 4096)):
        u = torch.rand(shape, generator=g, device="cuda", dtype=torch.float64)
        return limbs((b0 + (b1 - b0) * (1.0 - u)).float())

    uniform = limbs(torch.rand((4096, 4096), generator=g, device="cuda") * 2
                    - 1)
    inputs = {"4096x4096": mixed((4096, 4096)), "512x8192": mixed((512, 8192)),
              **{f"{k} band": band(*v) for k, v in BANDS.items()}}
    tanh_inputs = {"4096x4096": inputs["4096x4096"],
                   "512x8192": inputs["512x8192"],
                   "uniform (-1, 1)": uniform,
                   **{f"{k} band": band(*v) for k, v in TANH_BANDS.items()}}
    check = mixed((512, 8192))
    checks = {op: [check] for op in ("erf", "gelu")}
    checks["tanh"] = [check, tanh_edges("cuda"),
                      tuple(x[:512] for x in uniform)]
    want = {op: [fm.math_elementwise_plain(op, *c) for c in cs]
            for op, cs in checks.items()}
    key = ("ff_math", "ff_math_f32")
    shipped = build.entry(*key, [ctypes.c_void_p, ctypes.c_void_p])
    card = torch.cuda.get_device_name(0)
    rows = []
    try:
        for name in args.names:
            fn = ctypes.CDLL(str(lib_of[name])).ff_math_f32
            fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_void_p], \
                ctypes.c_int
            build._ENTRIES[key] = fn     # math_elementwise launches this one
            same = all(same_bits(a, b)
                       for op, cs in checks.items()
                       for c, w in zip(cs, want[op])
                       for a, b in zip(fm.math_elementwise(op, *c), w))
            sass = sass_functions(lib_of[name])
            row = {"variant": name, "bits_equal": same, "card": card,
                   "registers": registers(logs[name]),
                   "sass_differs_from_shipped": sorted(
                       k for k in set(sass) | set(base_sass)
                       if sass.get(k) != base_sass.get(k))}
            for what, (h, lo) in inputs.items():
                for op in ("erf", "gelu"):
                    if what.endswith("band") and op == "gelu":
                        continue
                    row[f"{op} {what}"] = graph_ms(
                        lambda: fm.math_elementwise(op, h, lo))
            for what, (h, lo) in tanh_inputs.items():
                row[f"tanh {what}"] = graph_ms(
                    lambda: fm.math_elementwise("tanh", h, lo))
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
