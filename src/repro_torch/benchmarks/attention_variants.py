"""The FF flash attention kernel's design (``csrc/ff_attention.cu``), one
choice at a time, on the card::

    python -m repro_torch.benchmarks.attention_variants [NAME ...] \\
        [--baseline CSRC] [--out rows.json]

Each source variant is a copy of ``csrc/`` under ``build/variants/`` with
one design choice of ``ff_attention.cu`` undone (a text edit,
``VARIANTS``): the causal / Skv-edge tile skip, the FMA TwoProd (Dekker's
in the p*v cascade, the f32 scores and the scale), the bf16 score product
as one multiply (a TwoProd instead), the denominator's lane triples and
shuffle tree (one lane a row walking the tile's keys in the reference's
order instead), the longest q tile first (the first first), exp22's own
body inline where the FMA path's test fails (out of line instead), the
p*v loop unrolled by 2 (not unrolled).  Plan variants run the shipped
sources with ``attention_plan`` overridden: each tile configuration (Big,
Small) at every shape, each with another count of blocks an SM or pairs
a thread (an edit of its ``Config``), and one query head a block (no GQA
sharing).  ``--baseline`` builds another ``csrc/`` directory (the
parent commit's) as the row ``baseline``, with its own entry point.

Every row is held to the float64 oracle (<= 2^-40 of each (batch, head)'s
largest output) on ``CASES`` (the main paths' shapes, q tiles that skip
K/V tiles, ``q_offset > 0`` with Sq < Skv, Sq, Skv and heads off the
tiles, G = 1, 3, 4, 7, 8, f32 and bf16 operands, scores spread so that
weights fall below 2^-100 of the row's largest; the head-dim 128 and 192
instances at the decoder-only families' shapes; non-causal at whisper's
encoder and cross shapes; the family training steps' shapes), and its
largest distance from the
plain version is reported.  Then each row is timed by CUDA-graph replay at
the prefill (1, 64), training (4, 128) and long-step (2, 1024) shapes of
granite-3-2b (32 heads, 8 KV heads, hd 64, bf16, causal), in the order of
the rows and then in reverse (``ms`` holds both).  Each row lists its
kernel instances' registers and spill bytes (``-Xptxas -v``) and their two
largest loops' SASS (the score and p*v loops: instructions, f32 ones).  The row
``yardsticks`` holds SDPA's ms at the three shapes.  Needs a CUDA card and
a checkout.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.benchmarks.math_variants import (cuobjdump_sass, graph_ms,
                                                  loops, sass_instructions)
from repro_torch.kernels import build
from repro_torch.kernels import ff_attention as fa

LIB = "ff_attention"
SOURCE = "ff_attention.cu"
ENTRY = "ff_attention_fwd"
TOL = 2.0 ** -40
Edit = Tuple[str, str, str]
# granite-3-2b's attention at the main paths' shapes: (B, S, H, KV, hd)
SHAPES = {"prefill": (1, 64, 32, 8, 64), "train": (4, 128, 32, 8, 64),
          "long step": (2, 1024, 32, 8, 64)}


class Case(NamedTuple):
    what: str
    B: int
    Sq: int
    Skv: int
    H: int
    KV: int
    hd: int
    causal: bool
    q_offset: int
    bf16: bool
    spread: float           # q's scale: 40 spreads scores over ~+-120


CASES = (
    # the main paths' shapes: prefill, training (4 x 128, 2 x 1024)
    Case("prefill", 1, 64, 64, 32, 8, 64, True, 0, True, 1.0),
    Case("train", 4, 128, 128, 32, 8, 64, True, 0, True, 1.0),
    Case("long step", 2, 1024, 1024, 32, 8, 64, True, 0, True, 1.0),
    Case("long keys, f32", 2, 4, 768, 2, 1, 32, False, 0, False, 1.0),
    # partial q tiles and a partial last K/V tile
    Case("ragged tiles", 1, 37, 37, 4, 2, 64, True, 0, False, 1.0),
    Case("ragged, non-causal", 2, 50, 130, 4, 1, 32, False, 0, True, 1.0),
    # q tiles that skip K/V tiles, one head a block
    Case("tiles skipped, G = 1", 2, 300, 300, 8, 8, 64, True, 0, False,
         1.0),
    # continued prefill: q_offset > 0, Sq < Skv
    Case("q_offset 160", 2, 40, 200, 8, 2, 64, True, 160, True, 1.0),
    Case("q_offset 257, ragged", 1, 100, 357, 4, 1, 48, True, 257, False,
         1.0),
    # heads, Sq and Skv off the tiles; G = 4, 3, 1, 8
    Case("G = 4, 12 heads", 1, 77, 77, 12, 3, 64, True, 0, True, 1.0),
    Case("G = 3", 1, 70, 70, 6, 2, 64, True, 0, True, 1.0),
    Case("G = 1, hd 40", 1, 50, 90, 6, 6, 40, False, 0, False, 1.0),
    Case("G = 8", 1, 65, 65, 16, 2, 64, True, 0, True, 1.0),
    # weights below 2^-100 of the row's largest: Dekker's and the FMA's
    # TwoProd differ there
    Case("spread scores, f32", 1, 96, 96, 4, 1, 64, True, 0, False, 40.0),
    Case("spread scores, bf16", 2, 130, 130, 8, 2, 64, True, 0, True,
         40.0),
    # the head-dim 128 and 192 instances: olmoe's prefill (MHA, G = 1),
    # minitron's 24 / 8 heads (G = 3), phi3's 40 / 10 (G = 4), MLA's
    # prefill at 128 + 64 (deepseek-v2's 128 heads, G = 1); ragged tiles,
    # q_offset > 0 with Sq < Skv, f32 operands and spread scores at each
    Case("hd 128, G = 1 (olmoe)", 4, 32, 32, 16, 16, 128, True, 0, True,
         1.0),
    Case("hd 128, G = 3 (minitron)", 2, 32, 32, 24, 8, 128, True, 0, True,
         1.0),
    Case("hd 128, G = 4 (phi3)", 1, 32, 32, 40, 10, 128, True, 0, True,
         1.0),
    Case("hd 128, ragged, f32", 1, 37, 37, 4, 2, 128, True, 0, False, 1.0),
    Case("hd 128, q_offset 100", 2, 40, 140, 8, 2, 128, True, 100, True,
         1.0),
    Case("hd 128, spread scores, f32", 1, 96, 96, 4, 1, 128, True, 0,
         False, 40.0),
    Case("hd 192, G = 1 (MLA)", 2, 32, 32, 128, 128, 192, True, 0, True,
         1.0),
    Case("hd 192, ragged, f32", 1, 37, 37, 4, 4, 192, True, 0, False, 1.0),
    Case("hd 192, q_offset 100", 2, 40, 140, 8, 2, 192, True, 100, True,
         1.0),
    Case("hd 192, spread scores, f32", 1, 96, 96, 4, 1, 192, True, 0,
         False, 40.0),
    # non-causal at whisper-medium's shapes (16 MHA heads at 64): the
    # encoder's self attention over 1500 frames, the decoder's cross
    # attention from a 32-token prompt to them; and spread f32 scores
    Case("whisper encoder, non-causal", 2, 1500, 1500, 16, 16, 64, False,
         0, True, 1.0),
    Case("whisper cross, non-causal", 2, 32, 1500, 16, 16, 64, False, 0,
         True, 1.0),
    Case("spread scores, non-causal, f32", 1, 24, 70, 2, 1, 64, False, 0,
         False, 40.0),
    # the family training steps' shapes: internvl2-1b's 14 / 2 heads (G =
    # 7) over 256 patches + 128 tokens, whisper-medium's decoder self
    # attention and cross attention from 128 tokens, olmoe-1b-7b's
    # head-dim 128 at 4 x 128
    Case("internvl2 train, G = 7", 4, 384, 384, 14, 2, 64, True, 0, True,
         1.0),
    Case("internvl2 train, G = 7, f32", 4, 384, 384, 14, 2, 64, True, 0,
         False, 1.0),
    Case("whisper decoder train", 2, 128, 128, 16, 16, 64, True, 0, True,
         1.0),
    Case("whisper cross train, non-causal", 2, 128, 1500, 16, 16, 64,
         False, 0, True, 1.0),
    Case("hd 128, olmoe train", 4, 128, 128, 16, 16, 128, True, 0, True,
         1.0),
)


def switch(name: str) -> Tuple[Edit, ...]:
    """The edit that turns ``ff_attention.cu``'s design switch ``name``
    off."""
    return ((SOURCE, f"constexpr bool {name} = true;",
             f"constexpr bool {name} = false;"),)


def config_edit(name: str, min_blocks: int,
                tile: Optional[Tuple[int, int]] = None) -> Tuple[Edit, ...]:
    """The edit that sets the blocks an SM (``__launch_bounds__``) of the
    tile configuration ``name`` (Big, Small), and its pairs a thread
    (TR, TK) where ``tile`` is given (its rows stay: the plan reads
    them)."""
    text = (build.CSRC / SOURCE).read_text()
    m = re.search(rf"using {name} = Config<(\d+), (\d+), (\d+), (\d+)>;",
                  text)
    if not m:
        raise RuntimeError(f"{SOURCE}: no configuration {name}")
    r, tr, tk, _ = m.groups()
    tr, tk = tile or (tr, tk)
    return ((SOURCE, m.group(0),
             f"using {name} = Config<{r}, {tr}, {tk}, {min_blocks}>;"),)


# the denominator's tile sum: the shipped shuffle tree of the lanes'
# triples, and the reference's order (one lane a row walks the tile's keys,
# a Neumaier triple each over both limbs, folded in key order)
DEN_TREE = """      ff2 t = two_sum(ds[i], dc[i]);
      ff2 f = fast_two_sum(t.hi, add(t.lo, dcc[i]));
#pragma unroll
      for (int off = 1; off < KX; off <<= 1) {
        const ff2 o = {__shfl_xor_sync(kAll, f.hi, off),
                       __shfl_xor_sync(kAll, f.lo, off)};
        const bool upper = (tx & off) != 0;
        f = add22(upper ? o : f, upper ? f : o);
      }
"""
DEN_LANES = """      float fh = 0.0f, fl = 0.0f;
      if (tx == 0) {
        for (int l = 0; l < jn; ++l) {
          float s1 = 0.0f, c1 = 0.0f, cc1 = 0.0f;
          cascade(s1, c1, cc1, ph[l * C::kQS + TR * ty + i]);
          cascade(s1, c1, cc1, pl[l * C::kQS + TR * ty + i]);
          ff2 t = two_sum(fh, s1);
          ff2 g = fast_two_sum(t.hi, add(t.lo, add(add(fl, c1), cc1)));
          fh = g.hi;
          fl = g.lo;
        }
      }
      ff2 f = {__shfl_sync(kAll, fh, row_lane0),
               __shfl_sync(kAll, fl, row_lane0)};
"""


class Variant(NamedTuple):
    edits: Tuple[Edit, ...] = ()
    config: Optional[int] = None     # attention_plan's configuration
    heads: Optional[int] = None      # query heads a block


VARIANTS: Dict[str, Variant] = {
    "shipped": Variant(),
    "no tile skip": Variant(switch("kSkipTiles")),
    "Dekker TwoProd": Variant(switch("kFmaTwoProd")),
    "bf16 products by TwoProd": Variant(switch("kExactBf16")),
    "denominator in lane order": Variant(((SOURCE, DEN_TREE, DEN_LANES),)),
    "first q tile first": Variant(switch("kLongestFirst")),
    "exp22 fallback out of line": Variant(switch("kExpInline")),
    "pv loop not unrolled": Variant(((
        SOURCE, "#pragma unroll 2\n      for (int j = 0; j < jn; ++j) {",
        "#pragma unroll 1\n      for (int j = 0; j < jn; ++j) {"),)),
    "score loop not unrolled": Variant(((
        SOURCE, "#pragma unroll 2\n  for (int d = 0; d < hd; ++d) {",
        "#pragma unroll 1\n  for (int d = 0; d < hd; ++d) {"),)),
    "score loop unrolled by 4": Variant(((
        SOURCE, "#pragma unroll 2\n  for (int d = 0; d < hd; ++d) {",
        "#pragma unroll 4\n  for (int d = 0; d < hd; ++d) {"),)),
    "weights two sub-tiles at a time": Variant(((
        SOURCE, "#pragma unroll 1\n    for (int j = 0; j < ns; ++j) {",
        "#pragma unroll 2\n    for (int j = 0; j < ns; ++j) {"),)),
    "Big tiles": Variant(config=0),
    "Small tiles": Variant(config=1),
    # capped registers: Big at 128 spills
    "Big tiles, 2 blocks an SM": Variant(config_edit("Big", 2), config=0),
    # other pairs a thread at the same rows
    "Big tiles, 2 x 4 a thread (512 threads)": Variant(
        config_edit("Big", 1, (2, 4)), config=0),
    "Big tiles, 4 x 2 a thread (512 threads)": Variant(
        config_edit("Big", 1, (4, 2)), config=0),
    "Small tiles, 3 blocks an SM": Variant(config_edit("Small", 3),
                                           config=1),
    "no GQA sharing": Variant(heads=1),
}


def forced_plan(config: Optional[int] = None,
                heads: Optional[int] = None) -> Callable[..., fa.Plan]:
    """``attention_plan`` with its configuration and/or heads a block
    fixed (each left to the plan where None)."""
    base = fa.attention_plan

    def plan(B, Sq, H, KV, sms=132, hd=64):
        p = base(B, Sq, H, KV, sms, hd=hd)
        return fa.plan_with(p.config if config is None else config,
                            p.heads if heads is None else heads, B, Sq, H)
    return plan


def variant_dir(name: str) -> Path:
    return build.ROOT / "build" / "variants" / ("attention_" + re.sub(
        r"\W+", "_", name))


def build_variants(names, baseline: Optional[str] = None
                   ) -> Dict[str, Tuple[Path, str]]:
    """Build each source variant's library (and ``baseline``'s, from that
    csrc/ directory as it is), all at once; returns name -> (directory,
    nvcc log).  Plan variants use the port's build."""
    out = build.build_all()
    shipped = (out, (out / f"lib{LIB}.log").read_text())
    sources = {n: (build.CSRC, VARIANTS[n].edits) for n in names
               if VARIANTS[n].edits}
    if baseline:
        sources["baseline"] = (Path(baseline), ())
    res = {n: shipped for n in names if not VARIANTS[n].edits}
    procs = {}
    for name, (src, edits) in sources.items():
        d = variant_dir(name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(src, d)
        apply_edits(d, edits, name)
        cmd = [build._nvcc(), *build.FLAGS, "-I", str(d), "-o",
               str(d / f"lib{LIB}.so"), str(d / SOURCE)]
        procs[name] = (d, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    for name, (d, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {name!r} failed to build:\n"
                               f"{log[-4000:]}")
        res[name] = (d, log)
    return res


def apply_edits(d: Path, edits, name: str) -> None:
    for fname, old, new in edits:
        text = (d / fname).read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name!r}: {old!r} not found once "
                               f"in {fname}")
        (d / fname).write_text(text.replace(old, new))


def instance_label(mangled: str) -> Optional[str]:
    """``Config<R,TR,TK,MINB> f32|bf16`` for an attention kernel instance
    (``Config<...> hd128 bf16`` for a head-dim instance other than 64),
    else None."""
    m = re.search(r"ConfigILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)EEE"
                  r"(?:Li(\d+)E)?(\w+?)EEv", mangled)
    if not m:        # another source's kernel (a --baseline)
        return "ff_attention_kernel " + ("bf16" if "bfloat16" in mangled
                                         else "f32") \
            if "ff_attention_kernel" in mangled else None
    dt = "bf16" if "bfloat16" in m.group(6) else "f32"
    hd = f"hd{m.group(5)} " if m.group(5) not in (None, "64") else ""
    return f"Config<{','.join(m.group(i) for i in range(1, 5))}> {hd}{dt}"


def ptxas_info(log: str) -> Dict[str, dict]:
    """Registers, spill and stack bytes of each kernel instance
    (``-Xptxas -v``), by ``instance_label``."""
    out = {}
    for block in log.split("Compiling entry function")[1:]:
        label = instance_label(block.split("\n", 1)[0])
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


def main_loops(lib, count: int = 3) -> Dict[str, List[dict]]:
    """Each kernel instance's ``count`` largest loops of its SASS (the
    score and p*v loops): instructions, f32 ones, commonest opcodes."""
    out = {}
    for part in cuobjdump_sass(lib).split("Function : ")[1:]:
        name, body = part.split("\n", 1)
        label = instance_label(name)
        found = loops(sass_instructions(body), 64) if label else []
        if found:
            top = sorted(found, key=lambda r: -r["instructions"])[:count]
            out[label] = [{k: r[k] for k in ("instructions", "f32", "ops")}
                          for r in top]
    return out


# -- inputs and the oracle --------------------------------------------------

def case_inputs(case: Case, g, device="cuda"):
    """q (scaled by ``spread``), k, v of a case, normal, in its dtype."""
    dt = torch.bfloat16 if case.bf16 else torch.float32
    q = torch.randn((case.B, case.Sq, case.H, case.hd), generator=g,
                    device=device) * case.spread
    k = torch.randn((case.B, case.Skv, case.KV, case.hd), generator=g,
                    device=device)
    v = torch.randn((case.B, case.Skv, case.KV, case.hd), generator=g,
                    device=device)
    return q.to(dt), k.to(dt), v.to(dt)


def oracle(q, k, v, causal: bool, q_offset: int = 0):
    """float64 softmax attention, scaled by the f32-rounded 1/sqrt(hd) as
    the reference's attention_f64 (an exact f64 scale is itself ~2^-26
    off what the FF tiers compute); causal: key j <= q_offset + i."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    sc = float(torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32))
    q64 = q.double().reshape(B, Sq, KV, G, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", q64, k.double()) * sc
    if causal:
        mask = (torch.arange(Skv, device=q.device)[None, :]
                <= q_offset + torch.arange(Sq, device=q.device)[:, None])
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bkgqd", p, v.double())
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)


def rel_err(got, want) -> float:
    """Largest error relative to each (batch, head)'s largest output."""
    den = want.abs().amax(dim=(1, 3), keepdim=True)
    return float(((got - want).abs() / den).max())


def ff64(pair):
    return pair.hi.double() + pair.lo.double()


def kernel(q, k, v, case: Case):
    return ff64(fa.flash_attention_pallas(q, k, v, causal=case.causal,
                                          q_offset=case.q_offset,
                                          return_ff=True))


# the plain version's rows a block on cases of more than PLAIN_WIDE_PAIRS
# (q, key) pairs a head: ``block_q`` only tiles the rows, and a row's bits
# are the same at any block_q (tests/test_torch_attention_variants.py);
# 256 cut its launches ~8-fold at whisper's 1500 x 1500 frames
PLAIN_BLOCK_Q, PLAIN_WIDE_PAIRS = 256, 1 << 20


def references(cases, g, device="cuda") -> List[tuple]:
    """(case, q, k, v, oracle, plain) for each case; the plain version
    (``flash_attention_ff``) is itself held to the oracle."""
    out = []
    for case in cases:
        q, k, v = case_inputs(case, g, device)
        want = oracle(q, k, v, case.causal, case.q_offset)
        plain = ff64(fa.flash_attention_ff(q, k, v, causal=case.causal,
                                           q_offset=case.q_offset,
                                           block_q=PLAIN_BLOCK_Q
                                           if case.Sq * case.Skv
                                           > PLAIN_WIDE_PAIRS else 32,
                                           return_ff=True))
        e = rel_err(plain, want)
        if not e <= TOL:
            raise AssertionError(f"plain attention {case.what}: "
                                 f"{e:.3e} > 2^-40 of float64")
        out.append((case, q, k, v, want, plain))
    return out


# -- rows -------------------------------------------------------------------

def row_setup(name: str, lib_dir: Path, baseline_src: Optional[Path]
              ) -> Callable[[], None]:
    """Swap row ``name``'s library and plan in; returns the undo."""
    key = (LIB, ENTRY)
    saved = build.entry(LIB, ENTRY, fa._ARGTYPES)
    plan = fa.attention_plan
    f = getattr(ctypes.CDLL(str(lib_dir / f"lib{LIB}.so")), ENTRY)
    f.restype = ctypes.c_int
    if name == "baseline" and len(entry_signature(baseline_src)) == 16:
        f.argtypes = fa._ARGTYPES[:15] + fa._ARGTYPES[17:]

        def old(*a, f=f):                # no plan, no hb_shift
            return f(*a[:15], a[17])
        build._ENTRIES[key] = old
    else:
        f.argtypes = fa._ARGTYPES
        build._ENTRIES[key] = f
    var = VARIANTS.get(name, Variant())
    if var.config is not None or var.heads is not None:
        fa.attention_plan = forced_plan(var.config, var.heads)

    def undo():
        build._ENTRIES[key] = saved
        fa.attention_plan = plan
    return undo


def entry_signature(csrc: Path) -> List[str]:
    """The parameters of ``ff_attention_fwd`` in ``csrc``'s source."""
    src = (csrc / SOURCE).read_text()
    sig = re.search(rf'extern "C" int {ENTRY}\((.*?)\)\s*{{', src, re.S)
    return [p.strip() for p in sig.group(1).split(",")]


def shape_inputs(g) -> Dict[str, tuple]:
    out = {}
    for what, (B, S, H, KV, hd) in SHAPES.items():
        out[what] = tuple(
            torch.randn(shape, generator=g, device="cuda").bfloat16()
            for shape in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*", default=list(VARIANTS))
    ap.add_argument("--baseline", help="another csrc/ directory, built and "
                    "timed as the row 'baseline'")
    ap.add_argument("--out", help="write the rows as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("attention_variants: no CUDA device", file=sys.stderr)
        return 2
    unknown = set(args.names) - set(VARIANTS)
    if unknown:
        raise KeyError(f"variants {sorted(unknown)}; known: {list(VARIANTS)}")
    libs = build_variants(args.names, args.baseline)
    base = Path(args.baseline) if args.baseline else None
    rows_of = list(args.names) + (["baseline"] if args.baseline else [])
    card = torch.cuda.get_device_name(0)
    g = torch.Generator(device="cuda").manual_seed(25)
    refs = references(CASES, g)
    timed = shape_inputs(g)
    rows = []
    for name in rows_of:
        d, log = libs[name]
        undo = row_setup(name, d, base)
        try:
            errs, worst_plain = {}, 0.0
            for case, q, k, v, want, plain in refs:
                got = kernel(q, k, v, case)
                errs[case.what] = rel_err(got, want)
                worst_plain = max(worst_plain,
                                  float((got - plain).abs().max()))
            plans = {what: tuple(fa.attention_plan(
                a[0].shape[0], a[0].shape[1], a[0].shape[2],
                a[1].shape[2])) for what, a in timed.items()}
        finally:
            undo()
        bad = [w for w, e in errs.items() if not e <= TOL]
        row = {"variant": name, "within_2^-40": not bad, "card": card,
               "worst_log2_err": math.log2(max(max(errs.values()), 1e-300)),
               "max_abs_vs_plain": worst_plain, "plans": plans,
               "ptxas": ptxas_info(log),
               "main_loops": main_loops(d / f"lib{LIB}.so"),
               "warnings": [ln for ln in log.splitlines()
                            if "warning" in ln.lower()], "ms": {}}
        rows.append(row)
        print(json.dumps({k: row[k] for k in (
            "variant", "within_2^-40", "worst_log2_err",
            "max_abs_vs_plain")}), flush=True)
        if bad:
            raise AssertionError(f"variant {name!r} beyond 2^-40 of float64 "
                                 f"on {bad}: { {w: errs[w] for w in bad} }")
    for order in (rows, rows[::-1]):
        for row in order:
            name = row["variant"]
            undo = row_setup(name, libs[name][0], base)
            try:
                for what, (q, k, v) in timed.items():
                    row["ms"].setdefault(what, []).append(graph_ms(
                        lambda: fa.flash_attention_pallas(
                            q, k, v, causal=True, return_ff=True),
                        2 if what == "long step" else 20))
            finally:
                undo()
    for row in rows:
        print(json.dumps(row), flush=True)
    import torch.nn.functional as F
    yrow = {"variant": "yardsticks", "card": card, "ms": {
        f"SDPA {what}": graph_ms(lambda: F.scaled_dot_product_attention(
            *(t.transpose(1, 2) for t in a), is_causal=True,
            enable_gqa=True), 50) for what, a in timed.items()}}
    rows.append(yrow)
    print(json.dumps(yrow), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
