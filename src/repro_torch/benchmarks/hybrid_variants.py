"""The hybrid FF matmul kernel's design (``csrc/ff_matmul.cu``), one
choice at a time, on the card::

    python -m repro_torch.benchmarks.hybrid_variants [NAME ...] \\
        [--out rows.json]

Each variant is the kernel with one design choice undone: another field
of its ``Shipped`` configuration (the 8 x 8 register tile, the K depth of
a tile, the stages of the ``cp.async`` ring, the FF accumulator in
registers or in shared memory rather than in the outputs, the blocks an
SM that cap the registers, the warp's layout, 128 x 128 tiles), 4-byte
copies everywhere, no split of the K-blocks, or
the earlier design itself (the check kernel
``csrc/ff_matmul_hybrid_check.cu``: 64 x 64 tiles, 4 x 4 outputs a
thread, synchronous staging).  Each source variant is a text edit of a
copy of ``csrc/`` built with the port's ``nvcc`` flags into
``build/variants/hybrid_<name>/`` (all at once) and swapped in for the
``ff_matmul`` library.  Every variant is held bit for bit (signs of zero
included) to the check kernel on ragged shapes off every tile, at ``bk``
1, 300, 512 and beyond K, on operands whose exponents spread over 2^+-40
with signed zeros, contiguous and as transposed views, and on a granite
shape; then timed by CUDA-graph replay at granite-3-2b's three matmul
shapes.  Each row also carries each kernel instance's registers and
spills (``-Xptxas -v``) and the main loops' SASS of the instances the
forward pass runs (A row-major, B N-contiguous and aligned): their FFMA
against the rest, and the FFMAs that read two registers of one bank.
Needs a CUDA card and a checkout.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.benchmarks.dot2_variants import (graph_ms, same_bits,
                                                  spread_operands)
from repro_torch.benchmarks.math_variants import (cuobjdump_sass, loops,
                                                  sass_instructions)
from repro_torch.kernels import build
from repro_torch.kernels import ff_matmul as km

SOURCE = "ff_matmul.cu"
FIELDS = ("TX", "TY", "RM", "RN", "TK", "STAGES", "ACC", "MINB", "WTX")
ACC = {0: "registers", 1: "shared memory", 2: "the outputs"}
CONFIG = re.compile(r"using Shipped = Config<" + ", ".join(
    [r"(\d+)"] * len(FIELDS)) + ">;")
Edit = Tuple[str, str, str]
Plan = Callable[[int, int, int, int, int], int]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan_fill(tile: Tuple[int, int], per_sm: int) -> Plan:
    """``hybrid_plan``'s rule for another output ``tile`` (rows, columns)
    and ``per_sm`` blocks an SM: no split where the tiles fill those blocks
    on every SM, else as many as fit beside them, at most one a K-block."""
    def plan(M, N, K, bk, sms):
        tiles = _cdiv(M, tile[0]) * _cdiv(N, tile[1])
        if tiles >= per_sm * sms:
            return 1
        return max(1, min(_cdiv(K, bk), per_sm * sms // tiles))
    return plan


def plan_no_split(M, N, K, bk, sms):
    """No split of the K-blocks."""
    return 1


# name: (changes to the Shipped Config line, other text edits, split rule
# in place of hybrid_plan's); None: the earlier kernel (the check kernel)
Variant = Optional[Tuple[Dict[str, int], Tuple[Edit, ...], Optional[Plan]]]
VARIANTS: Dict[str, Variant] = {
    "shipped": ({}, (), None),
    "earlier kernel (4 x 4 a thread, synchronous)": None,
    # 4 x 4 outputs a thread: 64 x 32 tiles, 16 KB of accumulator a block
    "register tile 4 x 4": ({"RM": 4, "RN": 4}, (), plan_fill((64, 32), 2)),
    "K depth 8": ({"TK": 8}, (), None),
    "2 stages": ({"STAGES": 2}, (), None),
    "4 stages": ({"STAGES": 4}, (), None),
    "synchronous staging": ({"STAGES": 1}, (), None),
    # the accumulator in registers (255 of them, two blocks an SM), or in
    # the outputs (read, folded and written back each K-block: 165
    # registers and no accumulator memory, so three or, capped at 128
    # registers, four blocks an SM)
    "accumulators in registers": ({"ACC": 0, "MINB": 1}, (), None),
    "accumulators in the outputs, 3 blocks an SM": (
        {"ACC": 2, "MINB": 3}, (), plan_fill((128, 64), 3)),
    "accumulators in the outputs, 4 blocks an SM (128 registers)": (
        {"ACC": 2, "MINB": 4}, (), plan_fill((128, 64), 4)),
    "warps of 8 x 4 threads": ({"WTX": 4}, (), None),
    "4-byte copies everywhere": ({}, (
        ("ff_matmul.cu", "const bool va = a.s0 == 1 &&",
         "const bool va = false && a.s0 == 1 &&"),
        ("ff_matmul.cu", "const bool vb = b.s1 == 1 &&",
         "const bool vb = false && b.s1 == 1 &&")), None),
    # 128 x 128 tiles of 256 threads (warps of 2 x 16); their 128 KB of
    # accumulator would leave one block an SM, so in the outputs, two
    # blocks an SM; and with K-tiles of 8 in a 4-stage ring
    "128 x 128 tiles (accumulators in the outputs)": (
        {"TX": 16, "WTX": 16, "ACC": 2, "MINB": 2}, (),
        plan_fill((128, 128), 2)),
    "128 x 128 tiles (accumulators in the outputs), K depth 8, 4 stages": (
        {"TX": 16, "WTX": 16, "ACC": 2, "MINB": 2, "TK": 8, "STAGES": 4},
        (), plan_fill((128, 128), 2)),
    "no split": ({}, (), plan_no_split),
}

SHAPES = ((512, 2048, 8192), (512, 8192, 2048), (512, 2048, 49155))
# (M, K, N, bk): M and N off the tiles and off the 4-wide copies, K off the
# K-tiles, bk 1, 300, 512 and beyond K
CHECKS = ((129, 300, 65, 512), (1, 7, 1, 512), (63, 1100, 129, 512),
          (257, 513, 200, 300), (130, 37, 70, 1), (200, 1000, 131, 2048),
          (64, 2048, 8, 512), (512, 2048, 8192, 512))


def config_edits(changes: Dict[str, int]) -> Tuple[Edit, ...]:
    """The text edit that applies ``changes`` to the Shipped Config line."""
    if not changes:
        return ()
    m = CONFIG.search((build.CSRC / SOURCE).read_text())
    if not m:
        raise RuntimeError(f"{SOURCE}: no 'using Shipped = Config<...>;'")
    cfg = dict(zip(FIELDS, m.groups()))
    cfg.update({k: str(v) for k, v in changes.items()})
    return ((SOURCE, m.group(0), "using Shipped = Config<"
             + ", ".join(cfg[f] for f in FIELDS) + ">;"),)


def edits_of(name: str) -> Tuple[Edit, ...]:
    """Every text edit of variant ``name`` (none for the shipped source, the
    earlier kernel and the rule variants)."""
    v = VARIANTS[name]
    return () if v is None else config_edits(v[0]) + v[1]


def variant_dir(name: str):
    return build.ROOT / "build" / "variants" / ("hybrid_" + re.sub(
        r"\W+", "_", name))


def build_variants(names) -> Dict[str, Tuple[str, str]]:
    """Build each source variant's library; returns name -> (library path,
    nvcc log).  The shipped source, the rules and the earlier kernel use
    the port's build."""
    out = build.build_all()
    shipped = (str(out / "libff_matmul.so"),
               (out / "libff_matmul.log").read_text())
    earlier = (str(out / "libff_matmul_hybrid_check.so"),
               (out / "libff_matmul_hybrid_check.log").read_text())
    res, procs = {}, {}
    for name in names:
        edits = edits_of(name)
        if not edits:
            res[name] = earlier if VARIANTS[name] is None else shipped
            continue
        d = variant_dir(name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(build.CSRC, d)
        for fname, old, new in edits:
            text = (d / fname).read_text()
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name!r}: {old!r} not found "
                                   f"once in {fname}")
            (d / fname).write_text(text.replace(old, new))
        cmd = [build._nvcc(), *build.FLAGS, "-I", str(d), "-o",
               str(d / "libff_matmul.so"), str(d / SOURCE)]
        procs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True))
    for name, (d, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {name!r} failed to build:\n"
                               f"{log[-4000:]}")
        res[name] = (str(d / "libff_matmul.so"), log)
    return res


INSTANCE = re.compile(r"ConfigI((?:Li\d+E){9})E+Lb([01])ELb([01])E")


def instance_label(mangled: str) -> Optional[str]:
    """``RMxRN tile BMxBN TK STAGES acc VA VB`` of a hybrid_kernel
    instance's mangled name, else None (fold_kernel, the check kernel)."""
    m = INSTANCE.search(mangled)
    if not m or "hybrid_kernel" not in mangled:
        return None
    tx, ty, rm, rn, tk, st, acc, minb, wtx = map(int, re.findall(
        r"\d+", m.group(1)))
    va, vb = int(m.group(2)), int(m.group(3))
    return (f"{ty * rm}x{tx * rn} tile {rm}x{rn} TK {tk} stages {st} "
            f"acc in {ACC[acc]}, {minb} blocks an SM, warp {32 // wtx}x"
            f"{wtx}, A "
            f"{'16' if va else '4'}-byte, B {'16' if vb else '4'}-byte "
            f"copies")


def ptxas_info(log: str) -> Dict[str, dict]:
    """Registers and spill bytes of each kernel instance (``-Xptxas -v``),
    by ``instance_label`` (the earlier kernel: ``fold_gemm_kernel``)."""
    out = {}
    for block in log.split("Compiling entry function")[1:]:
        head = block.split("\n", 1)[0]
        label = instance_label(head) or (
            "fold_gemm_kernel" if "fold_gemm_kernel" in head else None)
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", block)
        if label and regs:
            out[label] = {"registers": int(regs.group(1)),
                          "spill_bytes": (int(spill.group(1))
                                          + int(spill.group(2))
                                          if spill else None)}
    return out


def same_bank_ffma(ins) -> int:
    """FFMAs among ``ins`` (``sass_instructions``) that read two or more
    source registers of one parity from the register file (a reused
    operand, ``.reuse``, comes from the operand cache): on this card's two
    register banks such an FFMA waits a cycle for its second read."""
    n = 0
    for _a, op, rest in ins:
        if op.split(".")[0] != "FFMA":
            continue
        srcs = [o.strip() for o in rest.split(",")][1:]
        regs = [int(o[1:].split(".")[0]) for o in srcs
                if re.match(r"R\d+$", o)]
        parity = [r % 2 for r in regs]
        n += len(parity) != len(set(parity))
    return n


def forward_loops(lib: str) -> Dict[str, dict]:
    """The main loop of each instance the forward pass runs (A's 4-byte and
    B's 16-byte copies; the earlier kernel's only one): the loop of the
    most instructions, one K-tile a pass (it also holds the K-block's fold
    and the partial-tile loop, which run once per K-block and never at the
    granite shapes); its instructions, FFMA, the FFMAs that read two
    registers of one bank (``same_bank_ffma``), and the rest's commonest
    opcodes; by ``instance_label``."""
    out = {}
    for part in cuobjdump_sass(lib).split("Function : ")[1:]:
        name, body = part.split("\n", 1)
        label = instance_label(name) or (
            "fold_gemm_kernel" if "fold_gemm_kernel" in name else "")
        if not ("A 4-byte, B 16-byte" in label
                or label == "fold_gemm_kernel"):
            continue
        ins = sass_instructions(body)
        found = loops(ins)
        if not found:
            continue
        top = max(found, key=lambda r: r["instructions"])
        lo, hi = int(top["from"], 16), int(top["to"], 16)
        ffma = top["ops"].get("FFMA", 0)
        out[label] = {"loop_instructions": top["instructions"],
                      "ffma": ffma, "ffma_same_bank": same_bank_ffma(
                          [i for i in ins if lo <= i[0] <= hi]),
                      "other": top["instructions"] - ffma,
                      "other_ops": top["other_ops"]}
    if not out:
        raise RuntimeError(f"{lib}: no main loop found")
    return out


def check_cases(g) -> List[tuple]:
    """(what, A, B, bk): the CHECKS shapes on operands spread over
    2^+-40 with alternating signs and signed zeros, contiguous and as
    transposed views (the granite shape contiguous only)."""
    cases = []
    for M, K, N, bk in CHECKS:
        A, B = spread_operands((M, K, N), g)
        cases.append((f"{M}x{K}x{N} bk {bk}", A, B, bk))
        if M * N < 2 ** 20:
            cases.append((f"{M}x{K}x{N} bk {bk} transposed views",
                          A.T.contiguous().T, B.T.contiguous().T, bk))
    return cases


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*", default=list(VARIANTS))
    ap.add_argument("--out", help="write the rows as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("hybrid_variants: no CUDA device", file=sys.stderr)
        return 2
    unknown = set(args.names) - set(VARIANTS)
    if unknown:
        raise KeyError(f"variants {sorted(unknown)}; known: {list(VARIANTS)}")
    libs = build_variants(args.names)
    g = torch.Generator(device="cuda").manual_seed(11)
    checks = [(what, A, B, bk, km.ff_matmul_hybrid_check(A, B, bk=bk))
              for what, A, B, bk in check_cases(g)]
    timed = [(torch.randn((M, K), generator=g, device="cuda"),
              torch.randn((K, N), generator=g, device="cuda"))
             for M, K, N in SHAPES]
    key = ("ff_matmul", "ff_matmul_f32")
    shipped = build.entry(*key, km._HYBRID_ARGTYPES)
    rule = km.hybrid_plan
    card = torch.cuda.get_device_name(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    try:
        for name in args.names:
            path, log = libs[name]
            v = VARIANTS[name]
            if v is None:
                def run(A, B, bk=512):
                    return km.ff_matmul_hybrid_check(A, B, bk=bk)
            else:
                fn = ctypes.CDLL(path).ff_matmul_f32
                fn.argtypes, fn.restype = km._HYBRID_ARGTYPES, ctypes.c_int
                build._ENTRIES[key] = fn     # ff_matmul launches this one
                km.hybrid_plan = v[2] or rule

                def run(A, B, bk=512):
                    return km.ff_matmul(A, B, bk=bk)
            bad = [what for what, A, B, bk, want in checks
                   if not same_bits(run(A, B, bk), want)]
            row = {"variant": name, "bits_equal": not bad, "card": card,
                   "plans": {f"{M}x{K}x{N}": km.hybrid_plan(M, N, K, 512, sms)
                             for M, K, N in SHAPES} if v else None,
                   "ptxas": ptxas_info(log), "main_loops": forward_loops(path),
                   "warnings": [ln for ln in log.splitlines()
                                if "warning" in ln.lower()]}
            for (M, K, N), (A, B) in zip(SHAPES, timed):
                row[f"{M}x{K}x{N}"] = graph_ms(lambda: run(A, B))
            rows.append(row)
            print(json.dumps(row), flush=True)
            if bad:
                raise AssertionError(f"variant {name!r} changed the bits "
                                     f"on {bad}")
    finally:
        build._ENTRIES[key] = shipped
        km.hybrid_plan = rule
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
