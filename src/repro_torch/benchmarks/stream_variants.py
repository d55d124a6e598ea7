"""The streaming kernels' design (``csrc/ff_elementwise.cu``'s flat path
and ``csrc/ff_adamw.cu``, both on ``csrc/ff_stream.cuh``), one choice at
a time, on the card::

    python -m repro_torch.benchmarks.stream_variants [NAME ...] \\
        [--baseline CSRC] [--out rows.json]

Each source variant is a copy of ``csrc/`` with one design choice undone
(a text edit, ``VARIANTS``): the pack width (``kVec`` 1, 2), the packs a
thread (``kUnroll`` 1, 4), the grid (2, 4 or 8 blocks an SM striding
over the steps, in place of one block a step; 4 are the resident ones),
128 or 512 threads a block, evict-first loads and stores (``__ldcs`` /
``__stcs``), 16-byte loads that ask L2 for the 256 bytes around them
(``ld.global.L2::256B``), or Mul22, Div22,
Sqrt22 and TwoProd on the FMA TwoProd where one test on the product
proves Dekker's exact (Dekker's out of line elsewhere).  Each builds with
the port's ``nvcc`` flags into ``build/variants/stream_<name>/`` (all at
once) and is swapped in for the ``ff_elementwise`` and ``ff_adamw``
libraries.  ``strided path`` runs the shipped sources with the plans
overridden: the elementwise ops through the strided loop, AdamW through
its 4-byte loop.  ``--baseline`` builds another ``csrc/`` directory (the
parent commit's) as the row ``baseline``: its strided elementwise kernel
and its AdamW entry point, whatever their signature.

Every row is held bit for bit (NaN to any NaN) to the plain versions: the
six ops on the timed inputs, odd and offset shapes, mixed scalar and
transposed operands and ``elementwise_edges``' classes; AdamW (all four
outputs) on odd sizes, leaves offset 1-3 floats into a buffer and one
layer of ``w_gate``.  Then each row is timed by CUDA-graph replay: the
six ops at (4096, 4096) on the operators phase's inputs of
``chip_smoke.py`` and AdamW in place on granite-3-2b's ``w_gate`` leaf
(40, 2048, 8192), twice, in the order of the rows and then in reverse
(``ms`` holds both, the mean is what a table quotes).  Each row also
lists, per kernel instance, its registers, spill and stack bytes
(``-Xptxas -v``) and its main loop's SASS (the loop of the most
instructions: its instructions and commonest opcodes), and the path each
timed call took.  The float64 calls and PyTorch's fused f32 AdamW are
timed once as the row ``yardsticks``.  Needs a CUDA card and a checkout.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.benchmarks.math_variants import (cuobjdump_sass, graph_ms,
                                                  loops, same_bits,
                                                  sass_instructions)
from repro_torch.kernels import build
from repro_torch.kernels import ff_elementwise as ew
from repro_torch.kernels import ff_fused

LIBS = ("ff_elementwise", "ff_adamw")
HEADER = "ff_stream.cuh"
EW_SHAPE = (4096, 4096)
ADAMW_SHAPE = (40, 2048, 8192)          # granite-3-2b's w_gate leaf
ADAMW_SCALARS = (1e-3, 0.9, 0.95, 0.1, 0.05)   # lr, b1, b2, bc1, bc2
ADAMW_EPS, ADAMW_WD = 1e-8, 0.1
Edit = Tuple[str, str, str]


def header(name: str, value: str) -> Tuple[Edit, ...]:
    """The edit that sets ``ff_stream.cuh``'s constant ``name`` to
    ``value``."""
    text = (build.CSRC / HEADER).read_text()
    m = re.search(rf"constexpr int {name} = ([^;]+);", text)
    if not m:
        raise RuntimeError(f"{HEADER}: no constant {name}")
    return ((HEADER, m.group(0), f"constexpr int {name} = {value};"),)


def grid_cap(per_sm: int) -> Tuple[Edit, ...]:
    """The edit that caps ``stream_grid`` at ``per_sm`` blocks an SM (the
    blocks then stride over the steps)."""
    return ((HEADER, "  return static_cast<int>(blocks);\n",
             "  int dev = 0, sms = 132;\n"
             "  cudaGetDevice(&dev);\n"
             "  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, "
             "dev);\n"
             f"  const long long cap = static_cast<long long>(sms) * {per_sm};"
             "\n  return static_cast<int>(blocks < cap ? blocks : cap);\n"),)


# TwoProd as a multiply and an FMA where |a|, |b| < 2^100 and 2^-100 <=
# |a b| < 2^100 (Dekker's split cannot overflow, no partial product
# underflows: Dekker's is exact) and the FMA's low limb is not zero (a zero
# low limb's sign may differ from Dekker's); Dekker's out of line elsewhere.
# Mul22, Div22 and Sqrt22 are ff_eft.cuh's op sequences on it.
FMA_OPS = """__device__ __noinline__ ff2 two_prod_far(float a, float b) {
  return ffk::two_prod(a, b);
}

__device__ __forceinline__ ff2 two_prod_g(float a, float b) {
  ff2 t = ffk::two_prod_fma(a, b);
  const float ax = fabsf(t.hi);
  if (!(fmaxf(fabsf(a), fabsf(b)) < 0x1p+100f && ax >= 0x1p-100f &&
        ax < 0x1p+100f && t.lo != 0.0f))
    t = two_prod_far(a, b);
  return t;
}

__device__ __forceinline__ ff2 mul22_g(ff2 a, ff2 b) {
  using namespace ffk;
  ff2 t = two_prod_g(a.hi, b.hi);
  float u = add(t.lo, add(mul(a.hi, b.lo), mul(a.lo, b.hi)));
  return fast_two_sum(t.hi, u);
}

__device__ __forceinline__ ff2 div22_g(ff2 a, ff2 b) {
  using namespace ffk;
  float ch = dvd(a.hi, b.hi);
  ff2 t = two_prod_g(ch, b.hi);
  float cl = dvd(sub(add(sub(sub(a.hi, t.hi), t.lo), a.lo), mul(ch, b.lo)),
                 b.hi);
  return fast_two_sum(ch, cl);
}

__device__ __forceinline__ ff2 sqrt22_g(ff2 a) {
  using namespace ffk;
  float ch = __fsqrt_rn(a.hi);
  ff2 t = two_prod_g(ch, ch);
  float num = add(sub(sub(a.hi, t.hi), t.lo), a.lo);
  float cl = dvd(num, add(ch, ch));
  return fast_two_sum(ch, cl);
}

"""
APPLY = "template <int OP>\n__device__ __forceinline__ ff2 apply("
FMA_TWO_PROD: Tuple[Edit, ...] = (
    ("ff_elementwise.cu", APPLY, FMA_OPS + APPLY),
    ("ff_elementwise.cu", "return mul22({a, b}, {c, d});",
     "return mul22_g({a, b}, {c, d});"),
    ("ff_elementwise.cu", "return div22({a, b}, {c, d});",
     "return div22_g({a, b}, {c, d});"),
    ("ff_elementwise.cu", "return sqrt22({a, b});",
     "return sqrt22_g({a, b});"),
    ("ff_elementwise.cu", "return two_prod(a, b);",
     "return two_prod_g(a, b);"))

# name: (text edits of csrc/, or None for the shipped sources run through
# the strided elementwise loop and AdamW's 4-byte loop)
VARIANTS: Dict[str, Optional[Tuple[Edit, ...]]] = {
    "shipped": (),
    "vector width 1": header("kVec", "1"),
    "vector width 2": header("kVec", "2"),
    "1 pack a thread": header("kUnroll", "1"),
    "4 packs a thread": header("kUnroll", "4"),
    # the grid capped, its blocks striding over the steps: at 4 blocks an
    # SM the grid is the blocks resident at once (62-64 registers)
    "2 blocks an SM": grid_cap(2),
    "4 blocks an SM (the resident blocks)": grid_cap(4),
    "8 blocks an SM": grid_cap(8),
    "128 threads a block": header("kThreads", "128"),
    "512 threads a block": header("kThreads", "512"),
    "cache hints": ((HEADER, "  return *p;\n", "  return __ldcs(p);\n"),
                    (HEADER, "  *p = v;\n", "  __stcs(p, v);\n")),
    # each 16-byte load asks L2 to fetch the 256-byte block around it
    "L2 256-byte prefetch": ((
        HEADER, "const float4 v = ld(reinterpret_cast<const float4*>(p));",
        "float4 v;\n"
        "    asm volatile(\"ld.global.L2::256B.v4.f32 {%0, %1, %2, %3}, "
        "[%4];\"\n"
        "                 : \"=f\"(v.x), \"=f\"(v.y), \"=f\"(v.z), "
        "\"=f\"(v.w) : \"l\"(p));"),),
    "FMA TwoProd": FMA_TWO_PROD,
    "strided path": None,
}


def edits_of(name: str) -> Tuple[Edit, ...]:
    return VARIANTS[name] or ()


def variant_dir(name: str, prefix: str = "stream_") -> Path:
    return build.ROOT / "build" / "variants" / (prefix + re.sub(
        r"\W+", "_", name))


def build_variants(names, baseline: Optional[str] = None, *,
                   libs: Tuple[str, ...] = LIBS,
                   edits_fn: Callable[[str], Tuple[Edit, ...]] = None,
                   prefix: str = "stream_"
                   ) -> Dict[str, Tuple[Path, Dict[str, str]]]:
    """Build each source variant's libraries (``libs``; and
    ``baseline``'s, from that csrc/ directory as it is) into
    ``build/variants/<prefix><name>``; returns name -> (directory,
    {library: nvcc log}).  A variant without edits (``edits_fn``, by
    default this module's ``edits_of``) uses the port's build."""
    edits_of_ = edits_fn or edits_of
    out = build.build_all()
    shipped = (out, {lib: (out / f"lib{lib}.log").read_text()
                     for lib in libs})
    sources = {n: (build.CSRC, edits_of_(n)) for n in names if edits_of_(n)}
    if baseline:
        sources["baseline"] = (Path(baseline), ())
    res = {n: shipped for n in names if not edits_of_(n)}
    procs = {}
    for name, (src, edits) in sources.items():
        d = variant_dir(name, prefix)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(src, d)
        for fname, old, new in edits:
            text = (d / fname).read_text()
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name!r}: {old!r} not found "
                                   f"once in {fname}")
            (d / fname).write_text(text.replace(old, new))
        for lib in libs:
            cmd = [build._nvcc(), *build.FLAGS, "-I", str(d), "-o",
                   str(d / f"lib{lib}.so"), str(d / f"{lib}.cu")]
            procs[(name, lib)] = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
    logs: Dict[str, Dict[str, str]] = {}
    for (name, lib), proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {name!r} {lib}.cu failed to "
                               f"build:\n{log[-4000:]}")
        logs.setdefault(name, {})[lib] = log
    for name in sources:
        res[name] = (variant_dir(name, prefix), logs[name])
    return res


OPS = {"0": "add22", "1": "mul22", "2": "div22", "3": "sqrt22",
       "4": "two_prod", "5": "two_sum"}


def instance_label(mangled: str) -> Optional[str]:
    """``flat <op> vec <n>``, ``strided <op>``, ``adamw stream`` or
    ``adamw 4-byte`` for a kernel of the two libraries, else None."""
    m = re.search(r"flat_kernelILi(\d)ELi(\d)E", mangled)
    if m:
        return f"flat {OPS[m.group(1)]} vec {m.group(2)}"
    m = re.search(r"elementwise_kernelILi(\d)E", mangled)
    if m:
        return f"strided {OPS[m.group(1)]}"
    if "adamw_stream_kernel" in mangled:
        return "adamw stream"
    if "adamw_kernel" in mangled:
        return "adamw 4-byte"
    return None


def ptxas_info(log: str, label_of: Callable[[str], Optional[str]] = None
               ) -> Dict[str, dict]:
    """Registers, spill and stack bytes of each kernel instance
    (``-Xptxas -v``), by ``label_of`` (this module's ``instance_label``
    unless given)."""
    out = {}
    for block in log.split("Compiling entry function")[1:]:
        label = (label_of or instance_label)(block.split("\n", 1)[0])
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", block)
        stack = re.search(r"(\d+) bytes stack frame", block)
        if label and regs:
            out[label] = {"registers": int(regs.group(1)),
                          "spill_bytes": (int(spill.group(1))
                                          + int(spill.group(2))
                                          if spill else None),
                          "stack_bytes": int(stack.group(1)) if stack
                          else None}
    return out


def main_loops(lib) -> Dict[str, dict]:
    """Each kernel instance's main loop (the loop of the most
    instructions): its instructions and commonest opcodes."""
    out = {}
    for part in cuobjdump_sass(lib).split("Function : ")[1:]:
        name, body = part.split("\n", 1)
        label = instance_label(name)
        found = loops(sass_instructions(body)) if label else []
        if found:
            top = max(found, key=lambda r: r["instructions"])
            out[label] = {"loop_instructions": top["instructions"],
                          "f32": top["f32"], "ops": top["ops"]}
    return out


# -- inputs ---------------------------------------------------------------

def ew_args(op: str, ah, al, bh, bl) -> tuple:
    """The planes of ``op`` from two FF operands a and b (Sqrt22 takes b,
    TwoSum and TwoProd the two hi limbs), as the operators phase of
    ``chip_smoke.py`` passes them."""
    return {"sqrt22": (bh, bl), "two_sum": (ah, bh),
            "two_prod": (ah, bh)}.get(op, (ah, al, bh, bl))


def ff_pair(shape, g, positive: bool = False, device="cuda"):
    """hi ~ N(0, 1) (|N(0, 1)| + 0.5 where ``positive``), lo ~ hi 1e-8
    N(0, 1): the operators phase's operands."""
    h = torch.randn(shape, generator=g, device=device)
    if positive:
        h = h.abs() + 0.5
    return h, h * 1e-8 * torch.randn(shape, generator=g, device=device)


def offset_view(x: torch.Tensor, off: int) -> torch.Tensor:
    """A copy of ``x`` as a view starting ``off`` floats into a larger
    buffer (1-3: off every 16-byte boundary)."""
    buf = torch.empty(x.numel() + off, dtype=x.dtype, device=x.device)
    v = buf[off:].view(x.shape)
    v.copy_(x)
    return v


def elementwise_edges(device, seed: int = 0) -> Dict[str, tuple]:
    """Operand classes at the edges of the elementwise ops' arithmetic, each
    (ah, al, bh, bl), 2048 elements: |hi| about kSplitSafe = 2^100 (where
    Dekker's split is still exact) and about 2^127 (products and quotients
    near overflow), products about and below 2^-100, subnormal limbs,
    signed zero limbs, infinities and NaN, and lo limbs beyond hi."""
    g = torch.Generator().manual_seed(seed)
    n = 2048

    def u(lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=g, dtype=torch.float64)

    def pm(x):
        s = torch.where(torch.rand(n, generator=g) < 0.5, -1.0, 1.0)
        return (x * s).float()

    def lo_of(h, k=-30):
        return (h.double() * 2.0 ** k * u(-1, 1)).float()

    def pair(h, lo=None):
        h = h.float()
        return h, lo_of(h) if lo is None else lo.float()

    out = {}
    # 2^100 times [1/2, 2): below and above kSplitSafe, both operands
    a = pair(pm(2.0 ** 100 * u(0.5, 2.0)))
    b = pair(pm(2.0 ** u(-30, 27).round()))
    out["hi about 2^100"] = a + b
    a = pair(pm(2.0 ** 127 * u(1.0, 1.99)))
    b = pair(pm(u(0.25, 4.0)))
    out["hi about 2^127"] = a + b
    # products 2^-110 .. 2^-90 (the test's 2^-100 inside)
    e = u(-110, -90)
    a = pair(pm(2.0 ** (e / 2) * u(1, 2)))
    b = pair(pm(2.0 ** (e / 2) * u(1, 2)))
    out["products about 2^-100"] = a + b
    # subnormal lo limbs beside small normal hi limbs, and subnormal hi
    h = pm(2.0 ** u(-126, -100).round() * u(1, 2))
    a = pair(h, pm(2.0 ** -140 * u(1, 512)))
    b = pair(pm(2.0 ** -135 * u(1, 2)), pm(2.0 ** -149 * u(0, 4).round()))
    out["subnormal limbs"] = a + b
    # signed zeros in every limb, beside normal limbs
    z = torch.tensor([0.0, -0.0, 1.5, -2.25], dtype=torch.float32)

    def pick():
        return z[torch.randint(0, 4, (n,), generator=g)]

    out["signed zero limbs"] = (pick(), pick() * 2.0 ** -30, pick(),
                                pick() * 2.0 ** -30)
    sp = torch.tensor([float("inf"), float("-inf"), float("nan"), 1.0,
                       -3.0, 0.0], dtype=torch.float32)

    def special():
        return sp[torch.randint(0, 6, (n,), generator=g)]

    out["inf and NaN"] = (special(), special() * 1e-9, special(),
                          special() * 1e-9)
    # lo limbs 2^1 .. 2^30 times their hi
    for_a = pm(u(0.5, 2.0))
    for_b = pm(u(0.5, 2.0))
    out["lo beyond hi"] = (for_a.float(), lo_of(for_a, 15) * 2.0 ** 15,
                           for_b.float(), lo_of(for_b, 15) * 2.0 ** 15)
    return {k: tuple(t.contiguous().to(device) for t in v)
            for k, v in out.items()}


def ew_cases(g) -> List[Tuple[str, str, tuple]]:
    """(what, op, planes): each op on odd and offset shapes, a mixed
    scalar, a row (1, C) beside a full operand, a transposed operand, and
    ``elementwise_edges``."""
    cases = []
    for shape in ((1, 1), (1, 67), (3, 130), (37, 67), (5, 1)):
        ah, al = ff_pair(shape, g)
        bh, bl = ff_pair(shape, g, True)
        for op in ew.EW_OPS:
            cases.append((f"{shape}", op, ew_args(op, ah, al, bh, bl)))
            for off in (1, 2, 3):
                cases.append((f"{shape} operands offset {off} floats", op,
                              tuple(offset_view(x, off)
                                    for x in ew_args(op, ah, al, bh, bl))))
    ah, al = ff_pair((64, 260), g)
    bh, bl = ff_pair((64, 260), g, True)
    edges = elementwise_edges(ah.device)
    for op in ew.EW_OPS:
        a = ew_args(op, ah, al, bh, bl)
        cases.append(("a scalar operand", op,
                      (a[0], a[1][0, 0]) + a[2:]))
        cases.append(("a row operand beside a full one", op,
                      (a[0], a[1][:1]) + a[2:]))
        cases.append(("a transposed operand", op,
                      (a[0].T.contiguous().T,) + a[1:]))
        for what, p in edges.items():
            cases.append((what, op, ew_args(op, *p)))
    return cases


def adamw_leaves(n: int, g, off: int = 0, shape=None) -> List[torch.Tensor]:
    """g, m, v, w, wlo on the card at their typical scales (chip_smoke's
    ``adamw_leaves``), each ``off`` floats into its own buffer."""
    out = []
    for sc in (1.0, 0.1, 0.01, 1.0, 1e-8):
        x = torch.randn(n, generator=g, device="cuda") * sc
        if sc == 0.01:
            x = x.abs()
        x = offset_view(x, off) if off else x
        out.append(x.view(shape) if shape else x)
    return out


def adamw_scalars(device) -> List[torch.Tensor]:
    return [torch.tensor(x, device=device) for x in ADAMW_SCALARS]


def adamw_same(leaves, scal) -> bool:
    """The AdamW kernel in place on ``leaves`` bit for bit the plain
    version on copies taken before (w, wlo, m, v; g unchanged)."""
    want = [t.clone() for t in leaves]
    ff_fused.adamw_update(*leaves, *scal, eps=ADAMW_EPS, wd=ADAMW_WD)
    g0 = want[0].clone()
    ff_fused.adamw_update_plain(*want, *scal, eps=ADAMW_EPS, wd=ADAMW_WD)
    return same_bits(leaves[0], g0) and all(
        same_bits(a, b) for a, b in zip(leaves[1:], want[1:]))


def cuda_ms(fn, iters: int) -> float:
    """Mean device ms of ``fn()`` over ``iters`` calls between CUDA events,
    after one call (for work a CUDA graph cannot capture)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# -- rows -------------------------------------------------------------------

def row_setup(name, lib_dir, baseline_src: Optional[Path]) -> Callable:
    """Swap row ``name``'s libraries and plans in; returns the undo."""
    keys = {("ff_elementwise", "ff_elementwise_f32"):
            [ctypes.c_void_p, ctypes.c_void_p],
            ("ff_elementwise", "ff_elementwise_flat_f32"):
            [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
            ("ff_adamw", "ff_adamw_f32"): ff_fused._ADAMW_ARGTYPES}
    saved = {k: build.entry(k[0], k[1], a) for k, a in keys.items()}
    plans = (ew.elementwise_plan, ff_fused.adamw_plan)
    for (lib, fn), argtypes in keys.items():
        f = getattr(ctypes.CDLL(str(lib_dir / f"lib{lib}.so")), fn, None)
        if f is None:                    # the parent's: strided only
            continue
        f.restype = ctypes.c_int
        if name == "baseline" and fn == "ff_adamw_f32" and len(
                adamw_signature(baseline_src)) == 10:
            f.argtypes = argtypes[:9] + argtypes[10:]

            def old(*a, f=f):            # no path argument: the 4-byte loop
                return f(*a[:9], a[10])
            build._ENTRIES[(lib, fn)] = old
        else:
            f.argtypes = argtypes
            build._ENTRIES[(lib, fn)] = f
    if name in ("strided path", "baseline"):
        ew.elementwise_plan = lambda *a, **k: ew.Plan("strided")
        ff_fused.adamw_plan = lambda leaves: "flat"

    def undo():
        build._ENTRIES.update(saved)
        ew.elementwise_plan, ff_fused.adamw_plan = plans
    return undo


def adamw_signature(csrc: Path) -> List[str]:
    """The parameters of ``ff_adamw_f32`` in ``csrc``'s ff_adamw.cu."""
    src = (csrc / "ff_adamw.cu").read_text()
    sig = re.search(r'extern "C" int ff_adamw_f32\((.*?)\)\s*{', src, re.S)
    return [p.strip() for p in sig.group(1).split(",")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*", default=list(VARIANTS))
    ap.add_argument("--baseline", help="another csrc/ directory, built and "
                    "timed as the row 'baseline'")
    ap.add_argument("--out", help="write the rows as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("stream_variants: no CUDA device", file=sys.stderr)
        return 2
    unknown = set(args.names) - set(VARIANTS)
    if unknown:
        raise KeyError(f"variants {sorted(unknown)}; known: {list(VARIANTS)}")
    libs = build_variants(args.names, args.baseline)
    rows_of = list(args.names) + (["baseline"] if args.baseline else [])
    card = torch.cuda.get_device_name(0)
    g = torch.Generator(device="cuda").manual_seed(11)
    # the bit checks: the plain versions, once
    (ah, al), (bh, bl) = ff_pair(EW_SHAPE, g), ff_pair(EW_SHAPE, g, True)
    timed = {op: ew_args(op, ah, al, bh, bl) for op in ew.EW_OPS}
    checks = [(f"{EW_SHAPE}", op, a) for op, a in timed.items()]
    checks += ew_cases(g)
    want = [ew.elementwise_plain(op, *a) for _w, op, a in checks]
    scal = adamw_scalars("cuda")
    adamw_checks = [(f"{n} elements offset {off}", n, off)
                    for n in (1, 3, 4, 5, 67, 8448, 1_000_003)
                    for off in (0, 1, 2, 3)] + [("2048 x 8192", 2048 * 8192,
                                                 0)]
    leaves = adamw_leaves(
        ADAMW_SHAPE[0] * ADAMW_SHAPE[1] * ADAMW_SHAPE[2], g,
        shape=ADAMW_SHAPE)

    def step():
        ff_fused.adamw_update(*leaves, *scal, eps=ADAMW_EPS, wd=ADAMW_WD)

    rows = []
    for name in rows_of:
        d, logs = libs[name]
        undo = row_setup(name, d, Path(args.baseline) if args.baseline
                         else None)
        try:
            bad = [f"{op} {what}" for (what, op, a), w in zip(checks, want)
                   if not all(same_bits(x, y) for x, y in zip(
                       ew.elementwise(op, *a), w))]
            bad += [f"adamw {what}" for what, n, off in adamw_checks
                    if not adamw_same(adamw_leaves(n, g, off), scal)]
            paths = {}
            for op, a in timed.items():
                ew.elementwise(op, *a)
                paths[op] = ew.elementwise.last_path
            step()
            paths["adamw"] = ff_fused.adamw_update.last_path
        finally:
            undo()
        info = {}
        for lib in LIBS:
            info.update(ptxas_info(logs[lib]))
        row = {"variant": name, "bits_equal": not bad, "card": card,
               "paths": paths, "ptxas": info,
               "main_loops": {k: v for lib in LIBS
                              for k, v in main_loops(
                                  d / f"lib{lib}.so").items()},
               "warnings": [ln for lib in LIBS
                            for ln in logs[lib].splitlines()
                            if "warning" in ln.lower()],
               "ms": {}}
        rows.append(row)
        print(json.dumps({k: row[k] for k in ("variant", "bits_equal",
                                              "paths")}), flush=True)
        if bad:
            raise AssertionError(f"variant {name!r} changed the bits on "
                                 f"{bad[:10]}")
    # the timing: the rows in order, then in reverse
    for order in (rows, rows[::-1]):
        for row in order:
            name = row["variant"]
            undo = row_setup(name, libs[name][0], Path(args.baseline)
                             if args.baseline else None)
            try:
                for op, a in timed.items():
                    row["ms"].setdefault(op, []).append(graph_ms(
                        lambda: ew.elementwise(op, *a), 20))
                row["ms"].setdefault("adamw w_gate", []).append(
                    graph_ms(step, 10))
            finally:
                undo()
    for row in rows:
        print(json.dumps(row), flush=True)
    a64, b64 = ah.double(), bh.double()
    yard = {"float64 add": lambda: torch.add(a64, b64),
            "float64 mul": lambda: torch.mul(a64, b64),
            "float64 div": lambda: torch.div(a64, b64),
            "float64 sqrt": lambda: torch.sqrt(b64)}
    yrow = {"variant": "yardsticks", "card": card,
            "ms": {k: graph_ms(f, 20) for k, f in yard.items()}}
    del a64, b64
    p = torch.nn.Parameter(leaves[3])
    p.grad = leaves[0]
    opt = torch.optim.AdamW([p], lr=ADAMW_SCALARS[0],
                            betas=ADAMW_SCALARS[1:3], eps=ADAMW_EPS,
                            weight_decay=ADAMW_WD, fused=True)
    yrow["ms"]["torch fused AdamW w_gate"] = cuda_ms(opt.step, 10)
    rows.append(yrow)
    print(json.dumps(yrow), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
