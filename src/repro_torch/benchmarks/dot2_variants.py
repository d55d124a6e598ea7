"""The Dot2 kernel's design (``csrc/ff_matmul_dot2.cu``), one choice at a
time, on the card::

    python -m repro_torch.benchmarks.dot2_variants [NAME ...] [--out rows.json]

Each variant is the kernel with one design choice undone: another
``Config`` of the shipped kernel (the register tile, the blocks an SM
that cap its registers, the outputs interleaved, the K-tiles in flight,
synchronous staging) or the earlier design itself
(``benchmarks/dot2_one_output.cu``: one output a thread, operands read
from shared memory per product, synchronous tiles).  Each is a copy of
``csrc/`` built with the port's ``nvcc`` flags into
``build/variants/<name>/`` (all at once), swapped in for the
``ff_matmul_dot2`` library, held bit for bit to the plain version on
edge shapes, every slab width and transposed views, and timed by
CUDA-graph replay at granite-3-2b's three matmul shapes.  Each row also
carries the VEC = 8 instance's registers and spills (``-Xptxas -v``) and
its main loop's SASS per product (``cuobjdump -sass``: the f32
arithmetic and the rest).  ``shipped`` is the source as it is.  Needs a
CUDA card and a checkout (the variants build into its ``build/``).
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
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ff_matmul as km

SOURCE = "ff_matmul_dot2.cu"
EARLIER = Path(__file__).with_name("dot2_one_output.cu")
CONFIG = re.compile(r"using Shipped = Config<(\d+), (\d+), (\d+), (\d+), "
                    r"(\d+)>;")
FIELDS = ("RM", "RN", "IL", "STAGES", "MINB")

# name: the shipped Config's fields to change, or None for the earlier
# design
VARIANTS: Dict[str, Optional[Dict[str, int]]] = {
    "shipped": {},
    "earlier kernel (one output a thread)": None,
    "2 blocks an SM (128 registers)": {"MINB": 2},
    "tile 2x4": {"RM": 2},
    "tile 2x4, 2 blocks an SM": {"RM": 2, "MINB": 2},
    "tile 4x2": {"RN": 2},
    "interleave 4": {"IL": 4},
    "no interleaving": {"IL": 1},
    "2 stages": {"STAGES": 2},
    "synchronous staging": {"STAGES": 1},
}

SHAPES = ((512, 2048, 8192), (512, 8192, 2048), (512, 2048, 49155))
# (M, K, N): M and N off the block tile, K of every slab width (K = 1..7
# give vec = K; 9: 3; 11: 1; 14: 7; 300: 8) and a granite shape
CHECKS = ((65, 300, 129), (63, 7, 5), (257, 11, 1), (1, 9, 65),
          (129, 14, 63), (512, 2048, 8192))
F32_OPS = ("FADD", "FMUL", "FFMA")


def shipped_config(text: str) -> Dict[str, int]:
    m = CONFIG.search(text)
    if not m:
        raise RuntimeError(f"{SOURCE}: no 'using Shipped = Config<...>;'")
    return dict(zip(FIELDS, map(int, m.groups())))


def tile_of(name: str) -> Tuple[int, int]:
    """(RM, RN): the outputs a thread of variant ``name`` owns."""
    change = VARIANTS[name]
    if change is None:
        return 1, 1
    cfg = {**shipped_config((build.CSRC / SOURCE).read_text()), **change}
    return cfg["RM"], cfg["RN"]


def graph_ms(fn, iters: int = 3) -> float:
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
    """Build each variant's library; returns name -> (library path, nvcc
    log).  ``shipped`` uses the port's build."""
    lib = build.build_all() / "libff_matmul_dot2.so"
    text = (build.CSRC / SOURCE).read_text()
    line = CONFIG.search(text).group(0)
    base = shipped_config(text)
    out, procs = {}, {}
    for name in names:
        change = VARIANTS[name]
        if change == {}:
            out[name] = (str(lib), lib.with_suffix(".log").read_text())
            continue
        d = build.ROOT / "build" / "variants" / re.sub(r"\W+", "_", name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(build.CSRC, d)
        if change is None:
            shutil.copy(EARLIER, d / SOURCE)
        else:
            cfg = {**base, **change}
            (d / SOURCE).write_text(text.replace(line, (
                "using Shipped = Config<"
                + ", ".join(str(cfg[f]) for f in FIELDS) + ">;")))
        cmd = [build._nvcc(), *build.FLAGS, "-I", str(d), "-o",
               str(d / "libff_matmul_dot2.so"), str(d / SOURCE)]
        procs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True))
    for name, (d, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {name!r} failed to build:\n"
                               f"{log[-4000:]}")
        out[name] = (str(d / "libff_matmul_dot2.so"), log)
    return out


def ptxas_info(log: str, vec: int = 8) -> dict:
    """The VEC = ``vec`` instance's registers and spill bytes (``-Xptxas
    -v``)."""
    for block in log.split("Compiling entry function")[1:]:
        if f"dot2_kernelILi{vec}E" not in block.split("\n", 1)[0]:
            continue
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", block)
        return {"registers": int(regs.group(1)) if regs else None,
                "spill_stores": int(spill.group(1)) if spill else None,
                "spill_loads": int(spill.group(2)) if spill else None}
    return {}


def sass_split(lib: str, tile: Tuple[int, int], vec: int = 8,
               tile_k: int = 32) -> dict:
    """The main loop of the VEC = ``vec`` instance's SASS (``cuobjdump
    -sass``; the loop whose backward branch spans the most instructions,
    one K-tile of ``tile_k`` per pass): its instructions per product of a
    thread (RM RN tile_k products a pass), the f32 arithmetic (FADD, FMUL,
    FFMA) and the rest, and the rest's commonest opcodes."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    sass = subprocess.run([os.path.join(home, "bin", "cuobjdump"), "-sass",
                           lib], capture_output=True, text=True, check=True,
                          timeout=120).stdout
    body = next(f for f in sass.split("Function : ")[1:]
                if f"dot2_kernelILi{vec}E" in f.split("\n", 1)[0])
    ins = [(int(m.group(1), 16), m.group(2).split(".")[0], m.group(3))
           for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                                r"([A-Z0-9_.]+)([^;]*);", body)]
    best = None
    for addr, op, rest in ins:
        t = re.search(r"0x([0-9a-f]+)", rest)
        if op == "BRA" and t and int(t.group(1), 16) < addr:
            lo = int(t.group(1), 16)
            n = sum(1 for a, _, _ in ins if lo <= a <= addr)
            if best is None or n > best[2]:
                best = (lo, addr, n)
    if best is None:
        raise RuntimeError(f"{lib}: no loop in the vec = {vec} instance")
    ops = collections.Counter(o for a, o, _ in ins if best[0] <= a <= best[1])
    products = tile[0] * tile[1] * tile_k
    f32 = sum(ops[o] for o in F32_OPS)
    other = sum(ops.values()) - f32
    return {"loop_instructions": sum(ops.values()),
            "products_a_pass": products,
            "f32_per_product": f32 / products,
            "other_per_product": other / products,
            "other_ops": dict(collections.Counter(
                {o: n for o, n in ops.items() if o not in F32_OPS})
                .most_common(8))}


def check_cases(g):
    """(what, A, B, plain hi, plain lo): the CHECKS shapes with operands
    whose exponents spread over 2^+-40 with alternating signs (the sums
    cancel) and some signed zeros, and transposed views."""
    cases = []
    for M, K, N in CHECKS:
        A, B = spread_operands((M, K, N), g)
        want = km.ff_matmul_dot2_plain(A, B)
        cases.append((f"{M}x{K}x{N}", A, B) + want)
        if M * N < 2 ** 20:
            cases.append((f"{M}x{K}x{N} transposed views",
                          A.T.contiguous().T, B.T.contiguous().T) + want)
    return cases


def spread_operands(mkn, g):
    """(A, B) on the card: normal values times 2^e, e uniform in
    [-40, 40], with alternating signs along K and about 1 in 16 entries a
    signed zero."""
    M, K, N = mkn

    def one(shape, kdim):
        x = torch.randn(shape, generator=g, device="cuda").abs() + 0.5
        e = torch.randint(-40, 41, shape, generator=g, device="cuda")
        k = torch.arange(shape[kdim], device="cuda")
        sign = (1 - 2 * (k % 2)).float()
        x = x * torch.exp2(e.float()) * (sign[None, :] if kdim == 1
                                          else sign[:, None])
        z = torch.randint(0, 16, shape, generator=g, device="cuda") == 0
        zero = torch.where(torch.rand(shape, generator=g, device="cuda")
                           < 0.5, -0.0, 0.0)
        return torch.where(z, zero, x)
    return one((M, K), 1), one((K, N), 0)


def same_bits(x, y) -> bool:
    return all(torch.equal(a.contiguous().view(torch.int32),
                           b.contiguous().view(torch.int32))
               for a, b in zip(x, y))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*", default=list(VARIANTS))
    ap.add_argument("--out", help="write the rows as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dot2_variants: no CUDA device", file=sys.stderr)
        return 2
    unknown = set(args.names) - set(VARIANTS)
    if unknown:
        raise KeyError(f"variants {sorted(unknown)}; known: {list(VARIANTS)}")
    libs = build_variants(args.names)
    g = torch.Generator(device="cuda").manual_seed(9)
    checks = check_cases(g)
    timed = [(torch.randn((M, K), generator=g, device="cuda"),
              torch.randn((K, N), generator=g, device="cuda"))
             for M, K, N in SHAPES]
    key = ("ff_matmul_dot2", "ff_matmul_dot2_f32")
    shipped = build.entry(*key, km._DOT2_ARGTYPES)
    card = torch.cuda.get_device_name(0)
    rows = []
    try:
        for name in args.names:
            path, log = libs[name]
            fn = ctypes.CDLL(path).ff_matmul_dot2_f32
            fn.argtypes, fn.restype = km._DOT2_ARGTYPES, ctypes.c_int
            build._ENTRIES[key] = fn     # ff_matmul_dot2 launches this one
            bad = [what for what, A, B, *want in checks
                   if not same_bits(km.ff_matmul_dot2(A, B), want)]
            row = {"variant": name, "bits_equal": not bad, "card": card,
                   "tile": tile_of(name), **ptxas_info(log),
                   "sass": sass_split(path, tile_of(name)),
                   "warnings": [ln for ln in log.splitlines()
                                if "warning" in ln.lower()]}
            for (M, K, N), (A, B) in zip(SHAPES, timed):
                row[f"{M}x{K}x{N}"] = graph_ms(
                    lambda: km.ff_matmul_dot2(A, B))
            rows.append(row)
            print(json.dumps(row), flush=True)
            if bad:
                raise AssertionError(f"variant {name!r} changed the bits "
                                     f"on {bad}")
    finally:
        build._ENTRIES[key] = shipped
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
