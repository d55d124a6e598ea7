"""The Ozaki kernel's design (``csrc/ff_matmul_ozaki.cu``), one choice at
a time, on the card::

    python -m repro_torch.benchmarks.ozaki_variants [NAME ...] [--out rows.json]

Each variant is the kernel with one design choice undone, a text edit of
a copy of ``csrc/`` (another block layout of the kernel's ``Config``: two
consumers with turns, without, sharing a ring, one consumer issuing its
own loads; or another choice) built with the port's ``nvcc`` flags into
``build/variants/<name>/`` (all at once).  Each is swapped in for the ``ff_matmul_ozaki`` library, held bit
for bit to the plain version at (512, 2048, 8192) and a ragged shape with a
K-block edge inside a K tile, and timed by CUDA-graph replay at
granite-3-2b's three matmul shapes on ``ozaki_operands``' outputs.  Each
row also carries the kernels' registers and spills (``-Xptxas -v``).
``shipped`` is the source as it is.
Needs a CUDA card and a checkout (the variants build into its ``build/``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
from typing import Dict, Tuple

import torch

from repro_torch.core import ffmatmul
from repro_torch.kernels import build
from repro_torch.kernels import ff_matmul as km

# name: ((text, replacement), ...); every text must occur once in
# ff_matmul_ozaki.cu
Edit = Tuple[str, str]
SHIPPED = "using Shipped = Config<1, false, false, false>;"


def layout(cfg: str) -> Tuple[Edit, ...]:
    """The kernel built with another block layout (``Config<...>``)."""
    return ((SHIPPED, f"using Shipped = Config<{cfg}>;"),)


VARIANTS: Dict[str, Tuple[Edit, ...]] = {
    # a producer warpgroup and one consumer of 64 x 128, one block an SM
    "shipped": (),
    # a producer warpgroup and two consumers of 64 x 128 (setmaxnreg 40 /
    # 232): a ring each, taking turns on the tensor cores (ping-pong) ...
    "ping-pong, 2 consumers": layout("2, false, true, false"),
    # ... a ring each, no turns ...
    "2 consumers, no turns": layout("2, false, false, false"),
    # ... one shared ring of 128 x 64 A tiles: 128 x 128 a block
    "2 consumers, one shared ring": layout("2, true, false, false"),
    # no producer warpgroup: the consumer issues its loads, two blocks an SM
    "own loads, 2 blocks an SM": layout("1, false, false, true"),
    # the exact exponent split on every block, no two-factor path
    "exact scaling only": (("        if (staged && ok_a[i] && ok_b[j]) {",
                            "        if (false) {"),),
    "2 K tiles in flight": (("constexpr int kInFlight = 3;",
                             "constexpr int kInFlight = 2;"),),
    # diagnostic (other bits): the fold replaced by a plain add
    "no fold (diagnostic)": ((
        "              const ffk::ff2 f = ffk::add212({hi[4 * c + h], lo[4 * c + h]}, v);",
        "              const ffk::ff2 f = {hi[4 * c + h] + v, lo[4 * c + h]};"),),
    # diagnostic (other bits): each K tile loaded once, then reused
    "no loads (diagnostic)": (
        ("    mbar_expect_tx(bar, C::kStageBytes);\n",
         "    if (c.kb + c.p > 0) {\n      mbar_arrive(bar);\n    } else {\n"
         "    mbar_expect_tx(bar, C::kStageBytes);\n"),
        ("    tma_load_3d(b, &tma_b, bar, k, n0, j);\n",
         "    tma_load_3d(b, &tma_b, bar, k, n0, j);\n    }\n")),
}

SHAPES = ((512, 2048, 8192), (512, 8192, 2048), (512, 2048, 49155))
CHECKS = ((512, 2048, 8192, 512), (200, 1000, 300, 300))


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


def build_variants(names) -> Dict[str, Tuple[str, str]]:
    """Build each edited variant's library; returns name -> (library path,
    nvcc log).  ``shipped`` uses the port's build."""
    lib = build.build_all() / "libff_matmul_ozaki.so"
    out, procs = {}, {}
    for name in names:
        edits = VARIANTS[name]
        if not edits:
            out[name] = (str(lib), (lib.with_suffix(".log").read_text()))
            continue
        d = build.ROOT / "build" / "variants" / re.sub(r"\W+", "_", name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(build.CSRC, d)
        src = d / "ff_matmul_ozaki.cu"
        text = src.read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name!r}: {old!r} not found once")
            text = text.replace(old, new)
        src.write_text(text)
        cmd = [build._nvcc(), *build.FLAGS, "-I", str(d), "-o",
               str(d / "libff_matmul_ozaki.so"), str(src)]
        procs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True))
    for name, (d, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {name!r} failed to build:\n"
                               f"{log[-4000:]}")
        out[name] = (str(d / "libff_matmul_ozaki.so"), log)
    return out


def kernel_info(log: str) -> list:
    """Per kernel instance: registers, stack frame, spill stores."""
    info = []
    for block in log.split("Compiling entry function")[1:]:
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                          block)
        name = re.search(r"ConfigILi(\d)ELb(\d)ELb(\d)E", block)
        info.append({"config": name.groups() if name else None,
                     "registers": int(regs.group(1)) if regs else None,
                     "stack": int(spill.group(1)) if spill else None,
                     "spill_stores": int(spill.group(2)) if spill else None})
    return info


def sass_info(lib: str) -> list:
    """Per kernel instance in the library's SASS (``cuobjdump -sass``): the
    highest register, HGMMA instructions, local loads and stores."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    sass = subprocess.run([os.path.join(home, "bin", "cuobjdump"), "-sass",
                           lib], capture_output=True, text=True,
                          check=True).stdout
    out = []
    for body in sass.split("Function : ")[1:]:
        name = re.search(r"ConfigILi(\d)ELb(\d)ELb(\d)E", body)
        regs = [int(r) for r in re.findall(r"\bR(\d+)\b", body)]
        out.append({"config": name.groups() if name else None,
                    "max_register": max(regs, default=-1),
                    "HGMMA": body.count("HGMMA"),
                    "LDL": len(re.findall(r"\bLDL\b", body)),
                    "STL": len(re.findall(r"\bSTL\b", body))})
    return out


def operands(M, K, N, bk, g):
    A = torch.randn((M, K), generator=g, device="cuda")
    B = torch.randn((K, N), generator=g, device="cuda")
    a, b, n, beta, bk, pairs = km._ozaki_setup(A, B, 0, 0, bk)
    return a, b, n, beta, bk, pairs, km.ozaki_operands(a, b, n, beta, bk)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*", default=list(VARIANTS))
    ap.add_argument("--out", help="write the rows as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ozaki_variants: no CUDA device", file=sys.stderr)
        return 2
    unknown = set(args.names) - set(VARIANTS)
    if unknown:
        raise KeyError(f"variants {sorted(unknown)}; known: {list(VARIANTS)}")
    libs = build_variants(args.names)
    g = torch.Generator(device="cuda").manual_seed(7)
    checks = []
    for M, K, N, bk in CHECKS:
        a, b, n, beta, bk, pairs, ops = operands(M, K, N, bk, g)
        pa, _ = ffmatmul.extract_slices(a, 1, n, beta)
        pb, _ = ffmatmul.extract_slices(b, 0, n, beta)
        checks.append((ops, pairs, km.ozaki_accumulate_plain(
            torch.stack(pa), torch.stack(pb), pairs, bk)))
        del a, b, pa, pb
    timed = [operands(M, K, N, 512, g)[5:] for M, K, N in SHAPES]
    key = ("ff_matmul_ozaki", "ff_matmul_ozaki_f16")
    shipped = build.entry(*key, km._OZAKI_ARGTYPES)
    card = torch.cuda.get_device_name(0)
    rows = []
    try:
        for name in args.names:
            path, log = libs[name]
            fn = ctypes.CDLL(path).ff_matmul_ozaki_f16
            fn.argtypes, fn.restype = km._OZAKI_ARGTYPES, ctypes.c_int
            build._ENTRIES[key] = fn     # ozaki_accumulate launches this one
            same = True
            for ops, pairs, want in checks:
                got = km.ozaki_accumulate(ops, pairs)
                same &= all(torch.equal(x, y) for x, y in zip(got, want))
            row = {"variant": name, "bits_equal": same,
                   "card": card, "kernels": kernel_info(log),
                   "sass": sass_info(path),
                   "warnings": [ln for ln in log.splitlines()
                                if "warning" in ln.lower()]}
            for (M, K, N), (pairs, ops) in zip(SHAPES, timed):
                row[f"{M}x{K}x{N}"] = graph_ms(
                    lambda: km.ozaki_accumulate(ops, pairs))
            rows.append(row)
            print(json.dumps(row), flush=True)
            if not same and "diagnostic" not in name:
                raise AssertionError(f"variant {name!r} changed the bits")
    finally:
        build._ENTRIES[key] = shipped
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
