#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failed check raises, so the script exits non-zero):

  1. card and build: the card's name and power limit, the torch/CUDA
     versions, and the kernels built from ``src/repro_torch/csrc`` (into
     ``build/``, one ``nvcc`` per source, all at once);
  2. kernel checks: each kernel against its plain PyTorch version on the
     card, at the shapes the serving and training paths give it among
     others (``mean_sq`` also at d_model 3072, 5120, 1024, 896 and 256,
     the family training steps' rows) — ``mean_sq`` to <= 1 ulp, FF
     attention (and its plain version) to <= 2^-40 of a float64 oracle on
     the card on ``attention_variants.CASES`` (the main paths' shapes, q
     tiles that skip K/V tiles, ``q_offset > 0`` with Sq < Skv, ragged
     tiles, G = 1, 3, 4, 7, 8, f32 and bf16, weights below 2^-100 of the
     row's largest, the head-dim 128 and 192 instances at the
     decoder-only families' shapes, non-causal at whisper-medium's
     encoder (2, 1500 over 1500) and cross (2, 32 and 2, 128 over 1500)
     shapes and on spread f32 scores, internvl2-1b's (4, 384, 14 / 2),
     whisper's decoder and olmoe-1b-7b's training shapes), the
     kernel under its own plan, each tile configuration and one head a
     block (its instances' registers and spills logged at the build);
     ``math_elementwise``'s exp and log1p bit for bit their plain versions
     on the SSD's arguments (a 600-token prompt's ``_segsum`` with its
     -inf triangle and differences below -103, the decay vectors,
     softplus's, edge arguments; exp(-inf) = (+0, +0)),
     the AdamW
     update, in place as the optimizer runs it on whole leaves (``tok``,
     ``w_gate``) and on lengths off its 4-wide packs through its 16-byte
     path, and on leaves 1-3 floats into their buffers through its
     4-byte loop, to 0 ulp on all four outputs;
  3. the FF matmul path: the hybrid, Ozaki and Dot2 kernels against their
     plain versions (Ozaki and Dot2 bit for bit, hybrid within 2 bk u S
     and bit for bit on integer operands, hybrid and Dot2 bit for bit on
     transposed views) and within each one's bound of a float64 GEMM on
     the card, at the CPU tests' shapes and granite-3-2b's (512 tokens
     through w_gate, w_down and the unembedding); the Ozaki kernel (its
     SASS must hold HGMMA) also bit for bit on budget-edge integers at
     beta 8 and 12 (and equal to float64), at beta 9-11, slices=5,
     block_k=300 and 2^+-40 rows and columns, with the outputs of tiny
     rows outside its bit contract counted; the Dot2 kernel (its
     registers, spills and main loop's instructions per product logged at
     the build) also bit for bit at K of every slab width, M and N off its
     block tile, exponents over 2^+-40 with alternating signs and signed
     zeros, contiguous and transposed; the hybrid kernel (its instances'
     registers, spills and main loops logged at the build) bit for bit the
     check kernel ``ff_matmul_hybrid_check.cu`` (its earlier design) at
     the tests' and granite-3-2b's shapes, M, N and K off its tiles, bk 1,
     300, 512 and beyond K, its K-blocks split and not, exponents over
     2^+-40 with signed zeros, contiguous and transposed; then
     ``repro_torch.ff.matmul`` at those three shapes through every impl,
     the ``policy(matmul=...)`` route, an FF operand and a forward and
     backward per kernel impl, with the launch counts read around that
     run; each kernel timed there (the Ozaki call also part by part);
     the ``table_ffmatmul`` matrix;
  4. the fused-composite path: ``ff_softmax`` (both modes, both
     classes), ``ff_norm_stats`` and the ``ff.fusion`` Program kernel
     against their plain versions on the card (bit for bit; the fast
     softmax within 1 ulp) and ``ff_softmax`` within its float64 bound,
     at the reference table's shapes, granite-3-2b's d_model rows, the
     longest row, ragged and short ones, rows offset 1-3 floats from a
     16-byte boundary and ``row_variants.row_edges`` (the +-0 max tie,
     NaN, +inf, all -inf: a NaN for a NaN), each case logging the path
     ``row_plan`` gave it; the Program kernel against the AdamW
     (0 ulp) and mean_sq (<= 1 ulp) kernels on their Programs; the
     routing by shape at granite-3-2b's vocabulary (the jnp formulation,
     one warning, no launch); ``table_elementwise`` at its three shapes
     with the kernels' launch counts read around it; each kernel timed;
  5. the paper's operators and ff.math: ``elementwise`` (Add22, Mul22,
     Div22, Sqrt22, TwoSum, TwoProd at scalar, row, column and full
     operands; each path ``elementwise_plan`` picks: 16-byte accesses at
     lengths off the 4-wide packs and beside a scalar, 4-byte ones on
     each operand 1-3 floats off a 16-byte boundary, the strided loop for
     a (1, C) and a transposed operand; the edge classes of
     ``stream_variants.elementwise_edges``), ``ff_rowsum`` and
     ``math_elementwise`` (ten functions on
     inputs that cover every branch; erf and gelu also on the band-sorted
     kernel's cases: bands interleaved, each band alone, ragged edges,
     row and column planes) bit for bit their plain versions on the card,
     and within their NUMERICS.md contracts of a float64 oracle; the
     exact division by the erf series' integers against IEEE division for
     every f32 dividend and each of the 68 divisors (0 mismatches);
     ``ff.tune`` for fifteen ops at four shapes and for matmul at (512,
     2048, 8192) into a temporary sidecar (each bucket's µs per impl and
     its winners), with the launch counts
     read around it; one call of each op with no ``impl=``,
     resolving ``tuned_default`` and launching the winner's kernel; the
     table cleared and the environment restored; each kernel timed, erf
     and gelu also on band-pure inputs; tanh bit for bit at its band
     edges and on mixed bands, and timed there and on band-pure inputs;
     sigmoid and silu (their FMA TwoProd path) bit for bit on its edge
     classes, a strided view, a row and a column plane, and timed also
     on x uniform in (-30, 30) against their bounds; pow, log1p, expm1,
     log and exp the same on theirs, with the elements that expm1, log and
     exp send to the Dekker body counted by the card's own test
     (``ff_math_paths.cu``) and held to its host emulation;
  6. the guard: ``guard_flags`` bit for bit its plain version at
     (3, 130), (4096, 4096) and the full-width KV pool plane, with the
     IEEE codes of the adversarial limb classes (NaN and Inf in each
     limb, subnormal ``lo``, signed zeros, the 2^-24 boundary and the
     float above it, ``|hi|`` below 2^-102); ``guard_probe`` with the
     kernel and the jnp impl giving equal counts; the ``ff.add`` /
     ``sub`` / ``mul`` gradients of the kernel tier bit for bit the plain
     tier's; ``ff.fused`` raising on a gradient-requiring operand; the
     gradients of ``div``, ``sqrt``, ``two_sum``, ``two_prod``,
     ``softmax`` (accurate; the fast one within 4 ulps), ``norm_stats``
     and the ten ``ff.math`` functions on their branch inputs, kernel
     tier bit for bit the plain tier's (the ``ff_math`` launches of the
     backward counted); the ``f64`` attention tier within 2^-40 of
     float64 at the prefill's and the training step's shapes;
  7. serving: a reduced granite-3-2b engine on the card against the same
     engine on the CPU (plain versions), also under ``guard="degrade"``
     with an ``oob``, a ``free`` and a ``dup`` block-table flip (the same
     statuses and tokens, the audit's rebuild, clean metadata after), in
     ``ff_bf16`` pages (the ``lo`` planes not all 0) and under
     ``reserve="prompt"`` with a preemption (the same statuses, tokens
     and preemptions); ``launch.serve --reduced --engine --snapshot-dir``
     and its ``--resume``; then granite-3-2b at full width
     (random weights from a seed) serving 4 requests under
     ``policy("ff_reduce", attention="pallas")``, with the kernels' launch
     counts read around that run and its own ``obs.Observer``: 4 requests
     ``OK`` and the tokens counted, the decode-step histogram's count and
     sum those of ``decode_s``, the ``mean_sq`` resolutions (on
     ``backend="cuda"``) as many as its launches, one ``request`` span a
     request, a Chrome trace that survives a JSON round trip with sorted
     timestamps; then the same 4 through engine
     A with ``reserve="prompt"`` on a pool that forces a preemption,
     ``sync_every=4``, a request journal and ``deadline_steps`` on one,
     snapshotted after a few iterations and dropped, and engine B from
     ``resume_engine`` run to the end: the tokens and both scores bit for
     bit the 4-request run's (the deadline request ``TIMEOUT`` with a
     prefix of them), a preemption, an empty journal, clean metadata and
     exact launch counts (``serve_durable``); then 4 requests under
     ``ff_math=True``
     with ``ff.use(silu="pallas")`` (``ff_math`` launched once per layer
     of every prefill and decode step) and again with the jnp silu (the
     same greedy tokens); then guarded serving, 4 requests: under
     ``guard="check"`` the ``guard="off"`` tokens with every guard count
     0 and ``probe_kv`` equal through the kernel and the jnp impl; under
     ``guard="degrade"`` with NaN written into 2 live K/V positions of
     slot 0 by ``repro_torch.chaos.ChaosMonkey``, the kernel probe
     counting 2, slot 0 ``DEGRADED`` with the
     fast-policy ``greedy_generate`` tokens, ``OK`` rows with the check
     run's, the ``ff_guard`` launches read around it; then one more
     decode step with every row full under ``torch.profiler`` inside
     ``obs.enable()``, for the device-busy share and the step's
     ``serve.decode_step`` range, and one more with its registry and
     trace calls counted and replayed in a timed loop (host µs a step);
  8. the families beyond dense GQA: reduced olmoe-1b-7b (head dim 128;
     also under ``ff_math``), deepseek-v2-236b, internvl2-1b,
     mamba2-370m (also under ``ff_math``), jamba-1.5-large-398b (one
     8-layer period) and whisper-medium (f32) through ``greedy_generate``
     on the card against the CPU (equal tokens, prefill logits within
     SMALL_FAMILY_ATOL);
     olmoe-1b-7b at full size (6.9 B parameters, bf16, random weights from
     a seed) through ``greedy_generate``, 4 prompts of 32 tokens, 8 new
     under ``policy("ff_reduce", attention="pallas")`` (the attention
     kernel's head-dim 128 instance in the prefill, ``mean_sq`` at every
     norm) and 4 under ``ff_math`` with ``ff.use(silu="pallas")`` (the
     experts' silu gate through ``math_elementwise``), the launches
     counted exactly, and under ``attention="ff"`` (prefill logits' gap,
     tokens equal or the plain path's top-2 margin); deepseek-v2-236b at
     full width cut to 2 layers, 2 prompts, 4 new tokens (the MLA prefill
     through the head-dim 192 instance, the absorbed decode on the ff
     tier); minitron-4b at full size through ``ServeEngine``, 2 requests
     of 32 tokens, 4 new (the head-dim 128 instance at G = 3 in the
     paged engine's prefills); mamba2-370m at full size (0.42 B
     parameters), 4 prompts of 32 tokens, 8 new under ``ff_reduce`` +
     ``pallas`` and under ``ff_math`` (the SSD's exp / log1p through
     ``math_elementwise``), one prompt of 600 tokens (3 SSD chunks) under
     ``ff_math``, exact launch counts, each against its plain routes
     (``ff_math``: equal logits and tokens); whisper-medium at full size
     (1.01 B parameters), 2 requests of 1500 seeded frames and 32 tokens
     (the attention kernel non-causal in the encoder and the cross
     attention, 72 launches a prefill; decode on the ff tier), against
     ``attention="fast"``;
  9. chaos: ``python -m repro_torch.chaos`` (every fault class on its own
     small model) on the card and with ``--device cpu``, both exit 0 with
     equal statuses and tokens, ``guard_flags`` launches read around the
     card run; ``repro_torch.chaos.restart.run_scenario`` for ``bf16``,
     ``f32`` and ``ff_bf16`` pages with the child process on the card,
     SIGKILLed mid-decode and resumed bit for bit;
  10. training: a reduced granite-3-2b trained 2 steps on the card against
     the same on the CPU (plain versions), with the whole loss and with
     the sequence-chunked loss, each also under ``ff_math`` with
     ``ff.use(silu="pallas")``; 2 steps with a ``ckpt_dir``, a crash and a
     restored third step, bit for bit 3 uninterrupted steps on the card;
     then, with the serving engine freed,
     granite-3-2b at full width (random weights from a seed) trained 4
     steps on ``SyntheticLM`` batches of 4 x 128 tokens and one step on
     2 x 1024 tokens (longer than ``loss_chunk``: the chunked loss) with
     FF-master-weight AdamW under ``policy("ff_reduce",
     attention="pallas")``, with the kernels' launch counts read around
     those steps; then one more step under ``torch.profiler``; then 3
     steps under ``ff_math`` with ``ff.use(silu="pallas")`` on the same
     weights and optimizer state, ``ff_math`` launched 3 times a layer
     (the forward, remat's recompute, the backward's ``sigmoid22``), the
     launch counts read around them, and one more under the profiler; the serving and training runs launch
     none of the fused-composite kernels, nor (but for the ``ff_math``
     runs) this slice's;
  11. family training: reduced olmoe-1b-7b, deepseek-v2-236b,
     internvl2-1b (16 seeded patches), mamba2-370m (also under
     ``ff_math`` with the SSD's exp / log1p through ``math_elementwise``),
     jamba-1.5-large-398b (one 8-layer period) and whisper-medium (64
     seeded frames), f32, remat, 2 steps on the card against the CPU
     (loss and grad norm within SMALL_TRAIN_RTOL, each card step's
     launches exactly ``train_launches_want``: ``mean_sq`` at every FF
     norm and again in remat's recompute, the attention kernel likewise,
     AdamW once a leaf, the loss's ``ff_softmax`` at the reduced
     vocabulary); reduced jamba's tuple tree 2 steps, a crash, a restored
     third step bit for bit; then mamba2-370m (4 x 512 tokens),
     whisper-medium (2 x 128 tokens, 2 x 1500 frames), internvl2-1b (4 x
     128 tokens, 256 patches a row) and olmoe-1b-7b cut to 4 of its 16
     layers at full width, 3 steps each with FF-master AdamW: finite
     losses, exact launches, step ms, tokens/s and peak memory, and
     olmoe's MoE aux statistic (the blocked FF sum) timed alone;
  12. timing: each kernel, its plain version and a PyTorch yardstick with
     CUDA events at the main paths' shapes, beside its bound (FF
     attention at the prefill, training and long-step shapes, at the
     decoder-only families' prefills at head dims 128 and 192, and
     non-causal at whisper-medium's encoder and cross shapes); the
     elementwise rows at (4096, 4096) and AdamW at ``w_gate`` must have
     taken the 16-byte path (the path each took is logged).

The CPU halves of the card-against-CPU checks of phases 8 (the reduced
families' serving), 9 (the chaos smoke) and 11 (the reduced families'
training) run in a child process (``python3 chip_smoke.py
--cpu-references OUT``, which sees no card) started after the build,
beside the card's phases; each phase waits for its results.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA card, or
outside a checkout, the script exits non-zero and prints no result.
"""

import gc
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
SEED = 0
T0 = 0.0                                 # the script's start (perf_counter)
# the full-width serving run: 4 requests, one wave of max_batch 4 (cut
# from 8 to keep the whole call within its time limit); the lengths of 8
# are drawn, so the 4 prompts are the first 4 of the 8-request stream
FULL_REQUESTS, MAX_NEW = 4, 16
PROMPT_LENS = (16, 64)

# f32 instruction counts of the kernels' device functions (csrc/ff_eft.cuh;
# each add, subtract, multiply, FMA, divide, min/max, convert or select is
# one).  An exact product with its error is two on this card, a multiply
# and an FMA (two_prod_fma), whichever TwoProd a kernel runs: a bound counts
# what the function needs.
TWO_SUM, FAST_TWO_SUM, TWO_PROD = 6, 3, 2
ADD212 = TWO_SUM + 1 + FAST_TWO_SUM                      # 10
MUL212 = TWO_PROD + 2 + FAST_TWO_SUM                     # 7
ADD22 = TWO_SUM + 2 + FAST_TWO_SUM                       # 11
MUL22 = TWO_PROD + 4 + FAST_TWO_SUM                      # 9
DIV22 = 1 + TWO_PROD + 5 + 1 + FAST_TWO_SUM              # 12
CASCADE = 2 * TWO_SUM + 1                                # 13, (s, c, cc) += x
LANE_FOLD = TWO_SUM + 3 + FAST_TWO_SUM                   # 12
FF_FOLD = TWO_SUM + 1 + FAST_TWO_SUM                     # 10, (s, c, cc) -> FF
# exp22: reduction 25, f32 Horner 10, 6 x (Mul22 + Add22), r^2 and r^2 W
# (2 Mul22), r + r^2 W (Add22), 1 + expm1 (Add212), 2^k scaling 10,
# saturation selects 6
EXP22 = 25 + 10 + 6 * (MUL22 + ADD22) + 2 * MUL22 + ADD22 + ADD212 + 10 + 6

# the AdamW kernel per element: the moments 7, the step 7, Add212 10
ADAMW_OPS = 7 + 7 + ADD212                               # 24
ADAMW_BYTES = 9 * 4              # g, m, v, w, wlo read; w, wlo, m, v written
ADAMW_SCALARS = (1e-3, 0.9, 0.95, 0.1, 0.05)   # lr, b1, b2, bc1, bc2
ADAMW_EPS, ADAMW_WD = 1e-8, 0.1
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 4, 4, 128
FF_MATH_TRAIN_STEPS = 3                  # full width under ff_math (+ 1
                                         # profiled)
LONG_BATCH, LONG_SEQ = 2, 1024           # S > loss_chunk: the chunked loss
ADAMW_SLICE = 2048 * 8192                # one layer of w_gate
# card against CPU, f32 compute: the summation orders of the matrix
# products and the kernels' (<= 1 ulp, <= 2^-40) differ from the plain
# versions'; tests/test_torch_train.py holds the port to the reference
# at the same tolerance
SMALL_TRAIN_RTOL = 1e-5

# the FF matmul path at granite-3-2b's widths, 512 tokens (4 x 128): w_gate /
# w_up, w_down (K > 1024: several K-blocks), the unembedding (N ragged)
MM_GRANITE = ((512, 2048, 8192), (512, 8192, 2048), (512, 2048, 49155))
MM_SMALL = ((8, 16, 8), (100, 300, 50), (257, 513, 129), (1, 2048, 1),
            (64, 1100, 8), (17, 100, 5))    # the CPU tests' shapes
U32 = 2.0 ** -24

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 peak memory rate
F32_LANES = 132 * 128            # SMs x f32 lanes; one instruction / cycle
TC_F16_FLOPS = 132 * 4096        # SMs x dense fp16 tensor-core FLOP / cycle


def attention_ops(B, Sq, Skv, H, hd, causal, bf16, scale) -> int:
    """f32 instructions that FF attention needs on these inputs: the
    reference's op sequence over the unmasked pairs only, with every op
    whose result the operands' type fixes left out.  A bf16 x bf16 product
    is exact in f32 (16 significant bits), so a score term is 1 multiply
    with no low part; every other exact product is TWO_PROD; a power-of-two
    scale is exact, so Mul212 by it is 2 multiplies.  The running max is
    taken first, so no tile is rescaled."""
    if causal:
        pairs = sum(min(Skv, i + 1) for i in range(Sq))
    else:
        pairs = Sq * Skv
    pairs *= B * H
    if bf16:
        score_d = 1 + CASCADE                            # exact product
    else:
        score_d = TWO_PROD + CASCADE + 1
    pv_d = TWO_PROD + 2 + CASCADE + 1                    # Mul212(p, v)
    exact_scale = math.frexp(scale)[0] == 0.5
    per_pair = (hd * score_d + FF_FOLD + (2 if exact_scale else MUL212)
                + 1 + ADD212 + EXP22          # max, shift, weight
                + 2 * CASCADE                 # denominator over both limbs
                + hd * pv_d)
    per_cell = FF_FOLD + DIV22                # numerator fold, Div22
    per_row = LANE_FOLD                       # denominator fold
    return pairs * per_pair + B * Sq * H * (hd * per_cell + per_row)


def log(msg=""):
    print(msg, flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0].strip()


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int) -> float:
    """Mean device time of ``fn()`` with the host out of the way: ``iters``
    calls captured in one CUDA graph, replayed between CUDA events (a call
    of a small kernel from Python costs more host time than device time,
    so ``cuda_ms`` of such a call measures the host)."""
    import torch
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


def adamw_leaves(torch, g, shape, off=0):
    """g, m, v, w, wlo on the card: the moments and the master weight's
    low limb at their typical scales (tests/test_fusion.py); each ``off``
    floats into a buffer of its own where ``off`` is not 0."""
    from repro_torch.benchmarks.stream_variants import offset_view
    mk = lambda sc=1.0: torch.randn(shape, generator=g,  # noqa: E731
                                    device="cuda") * sc
    leaves = (mk(), mk(0.1), mk(0.01).abs(), mk(), mk(1e-8))
    return tuple(offset_view(t, off) for t in leaves) if off else leaves


def adamw_check(torch, g, shape, scal, off=0) -> float:
    """The AdamW kernel in place on one leaf (``off`` floats into its
    buffer), against the plain version on copies of the inputs taken
    before it ran, slice by slice (one layer of w_gate at most, where the
    plain version's temporaries fit): 0 ulp on w, wlo, m and v; g
    unchanged; the 16-byte path on aligned leaves, the 4-byte loop on the
    others.  Returns the largest absolute error."""
    from repro_torch.kernels import ff_fused
    leaves = adamw_leaves(torch, g, shape, off)       # g, m, v, w, wlo
    before = [t.clone() for t in leaves]
    ff_fused.adamw_update(*leaves, *scal, eps=ADAMW_EPS, wd=ADAMW_WD)
    torch.cuda.synchronize()
    path = ff_fused.adamw_update.last_path
    if path != ("flat" if off % 4 else "vector"):
        raise AssertionError(f"adamw_update {shape} offset {off}: the "
                             f"{path} path")
    if not torch.equal(leaves[0], before[0]):
        raise AssertionError(f"adamw_update wrote its gradient at {shape}")
    new = [t.view(-1) for t in leaves]
    old = [t.view(-1) for t in before]
    n, worst_u, worst_abs = new[0].numel(), 0, 0.0
    for lo in range(0, n, ADAMW_SLICE):
        sl = slice(lo, min(n, lo + ADAMW_SLICE))
        want = [t[sl].clone() for t in old]
        ff_fused.adamw_update_plain(*want, *scal, eps=ADAMW_EPS,
                                    wd=ADAMW_WD)
        for i in (3, 4, 1, 2):                        # w, wlo, m, v
            worst_u = max(worst_u, ulp_diff(new[i][sl], want[i]))
            worst_abs = max(worst_abs,
                            float((new[i][sl] - want[i]).abs().max()))
    log(f"adamw_update {shape} offset {off} floats in place ({path} "
        f"path): kernel vs plain {worst_u} ulp (w, wlo, m, v; "
        f"{math.ceil(n / ADAMW_SLICE)} slices)")
    if worst_u != 0:
        raise AssertionError(f"adamw_update kernel {worst_u} ulp from "
                             f"plain at {shape} (limit 0)")
    return worst_abs


def ulp_diff(a, b) -> int:
    """The largest distance in f32 steps between a and b; a NaN matches a
    NaN, and a NaN against a number (or two shapes) is 2^32."""
    import torch
    na, nb = torch.isnan(a), torch.isnan(b)
    if a.shape != b.shape or not torch.equal(na, nb):
        return 1 << 32
    ia = a[~na].contiguous().view(torch.int32).long()
    ib = b[~nb].contiguous().view(torch.int32).long()
    return int((ia - ib).abs().max()) if ia.numel() else 0


# ---------------------------------------------------------------------------

def phase_build(torch):
    from repro_torch.kernels import build
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    out = build.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s into "
        f"{out.relative_to(ROOT)}")
    for name in build.SOURCES:
        info = [ln.strip() for ln in (out / f"lib{name}.log").read_text()
                .splitlines() if "registers" in ln or "spill" in ln]
        log(f"  {name}: " + " | ".join(info))
    # the attention kernel's instances: registers and spills
    from repro_torch.benchmarks import attention_variants as av
    for label, info in av.ptxas_info(
            (out / "libff_attention.log").read_text()).items():
        log(f"  ff_attention {label}: {info}")
    # the Ozaki kernel's pair products run on the tensor cores
    cuda = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    sass = subprocess.run([os.path.join(cuda, "bin", "cuobjdump"), "-sass",
                           str(out / "libff_matmul_ozaki.so")],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    hgmma = len(re.findall(r"\bHGMMA\.", sass))
    log(f"  ff_matmul_ozaki: {hgmma} HGMMA instructions in its SASS")
    if not hgmma:
        raise AssertionError("ff_matmul_ozaki.cu compiled without HGMMA")
    # the Dot2 kernel's vec = 8 instance: registers, spills and its main
    # loop's instructions per product
    from repro_torch.benchmarks import dot2_variants as dv
    lib = str(out / "libff_matmul_dot2.so")
    ptx = dv.ptxas_info((out / "libff_matmul_dot2.log").read_text())
    split = dv.sass_split(lib, dv.tile_of("shipped"))
    log(f"  ff_matmul_dot2 (vec 8): {ptx}; main loop per product: f32 "
        f"{split['f32_per_product']:.4f}, other "
        f"{split['other_per_product']:.4f} ({split['loop_instructions']} "
        f"instructions, {split['products_a_pass']} products a pass; other: "
        f"{split['other_ops']})")
    # the hybrid kernel's instances: registers and spills; the forward
    # pass's main loop: FFMA against the rest
    from repro_torch.benchmarks import hybrid_variants as hv
    for label, info in hv.ptxas_info(
            (out / "libff_matmul.log").read_text()).items():
        log(f"  ff_matmul (hybrid) {label}: {info}")
    for label, loop in hv.forward_loops(
            str(out / "libff_matmul.so")).items():
        log(f"  ff_matmul (hybrid) {label}: main loop (one K-tile a pass) "
            f"{loop}")


def attention_checks(torch, g) -> float:
    """FF attention on ``attention_variants.CASES`` (the main paths'
    shapes, q tiles that skip K/V tiles, ``q_offset > 0`` with Sq < Skv,
    Sq, Skv and heads off the tiles, G = 1, 3, 4, 7, 8, f32 and bf16,
    scores spread so that weights fall below 2^-100 of the row's largest,
    the family training steps' shapes): the
    kernel under its own plan, under each tile configuration and with one
    head a block, and its plain version, each within 2^-40 of the float64
    oracle.  Returns the largest |kernel - plain| under the kernel's own
    plan."""
    from repro_torch.benchmarks import attention_variants as av
    from repro_torch.kernels import ff_attention as fa
    worst_abs = 0.0
    plan = fa.attention_plan
    forced = [("own plan", plan)] + [
        (f"config {i}", av.forced_plan(config=i))
        for i in range(len(fa.CONFIGS))] + [
        ("one head a block", av.forced_plan(heads=1))]
    for case, q, k, v, want, plain in av.references(av.CASES, g):
        errs = {}
        try:
            for what, fn in forced:
                fa.attention_plan = fn
                got = av.kernel(q, k, v, case)
                torch.cuda.synchronize()
                errs[what] = av.rel_err(got, want)
                if what == "own plan":
                    used = fa.flash_attention_pallas.last_plan
                    vs_plain = float((got - plain).abs().max())
                    worst_abs = max(worst_abs, vs_plain)
        finally:
            fa.attention_plan = plan
        e_p = av.rel_err(plain, want)
        e_k = max(errs.values())
        log(f"attention {case.what}: q{(case.B, case.Sq, case.H, case.hd)} "
            f"Skv={case.Skv} KV={case.KV} causal={case.causal} q_offset="
            f"{case.q_offset} {'bf16' if case.bf16 else 'f32'}: kernel "
            f"2^{math.log2(max(e_k, 1e-300)):.1f} (worst of "
            f"{len(errs)} plans; own plan {tuple(used)}), plain "
            f"2^{math.log2(max(e_p, 1e-300)):.1f} vs float64; |kernel - "
            f"plain| <= {vs_plain:.3e}")
        if not (e_k <= 2.0 ** -40 and e_p <= 2.0 ** -40):
            raise AssertionError(f"attention {case.what}: error kernel "
                                 f"{errs}, plain {e_p:.3e} > 2^-40")
    log(f"attention: kernel vs plain at most {worst_abs:.3e} (own plans)")
    return worst_abs


def bitwise(x, y) -> bool:
    """Equal bits (signs of zero included) in both limbs."""
    import torch
    return all(torch.equal(a.contiguous().view(torch.int32),
                           b.contiguous().view(torch.int32))
               for a, b in zip(x, y))


def ssd_exp_checks(torch, g):
    """``math_elementwise``'s exp (and log1p) on the SSD's arguments bit
    for bit their plain versions: a 600-token prompt's decays at
    mamba2-370m's 32 heads (dt = softplus of raw draws, A = -1, padded to
    3 chunks of 256), their ``_segsum`` (-inf above each diagonal,
    differences below -103), ``decay_end``, ``chunk_decay`` and
    ``decay_in``; softplus's exp(-|x|) and log1p of it; and edge
    arguments (-inf, -1e30, around f32 exp's underflow at -103.97 and
    its subnormal range, signed zeros).  exp(-inf) must be (+0, +0)."""
    from repro_torch.kernels import ff_math as km
    from repro_torch.models import mamba2
    raw = torch.randn((1, 768, 32), generator=g, device="cuda") * 2
    dt = mamba2._softplus(raw, False)
    dt[:, 600:] = 0.0                               # the chunk padding
    a = (-dt).reshape(1, 3, 256, 32).permute(0, 1, 3, 2)
    a_cum = torch.cumsum(a, dim=-1)
    edges = torch.tensor([float("-inf"), -1e30, -200.0, -150.0, -104.0,
                          -103.97, -103.5, -103.0, -100.0, -87.4, -87.3,
                          -1e-30, -0.0, 0.0], device="cuda")
    args = {"segsum": mamba2._segsum(a), "decay_end": a_cum[..., -1:] - a_cum,
            "chunk_decay": a_cum[..., -1], "decay_in": a_cum,
            "softplus exp": -raw.abs(), "edges": edges}
    n = 0
    for what, x in args.items():
        x = x.contiguous()
        lo = torch.zeros_like(x)
        got = km.math_elementwise("exp", x, lo)
        want = km.math_elementwise_plain("exp", x, lo)
        neg_inf = torch.isneginf(x)
        zero = bool((got[0][neg_inf] == 0).all() and (got[1][neg_inf] == 0)
                    .all() and not torch.signbit(got[0][neg_inf]).any())
        if not (bitwise(got, want) and zero):
            raise AssertionError(f"ff_math exp on the SSD's {what}: kernel "
                                 f"!= plain bits or exp(-inf) != (+0, +0)")
        if what == "softplus exp":
            lg = km.math_elementwise("log1p", *got)
            if not bitwise(lg, km.math_elementwise_plain("log1p", *got)):
                raise AssertionError("ff_math log1p on softplus's exp: "
                                     "kernel != plain bits")
        n += x.numel()
        log(f"ff_math exp on the SSD's {what} {tuple(x.shape)}: bit for bit "
            f"the plain version ({int(neg_inf.sum())} -inf -> (+0, +0), "
            f"{int((x < -103.97).sum())} below -103.97)")
    return n


def phase_kernel_checks(torch):
    from repro_torch.kernels import ff_fused
    g = torch.Generator(device="cuda").manual_seed(SEED)
    checks = {}
    worst_ulp, worst_abs = 0, 0.0
    # decode rows, prefill rows, training rows (4 x 128, 2 x 1024), odd;
    # minitron-4b's and deepseek-v2's d_model (3072, 5120): decode and
    # prefill rows; mamba2-370m's and whisper-medium's 1024 (decode, 4 x
    # 32 prefill, the 600-token prompt, whisper's 2 x 1500 encoder rows)
    # and the reduced families' 256; the family training steps' rows:
    # mamba2's 4 x 512 and whisper's 2 x 128 at 1024, internvl2's 4 x
    # (256 patches + 128) at 896, olmoe's 4 x 128 at 2048 (above), the
    # reduced families' 2 x 16 (and internvl2's 2 x 32) at 256
    for shape in ((4, 2048), (64, 2048), (512, 2048), (2048, 2048),
                  (3, 1000), (2, 3072), (32, 3072), (2, 5120), (64, 5120),
                  (4, 1024), (128, 1024), (600, 1024), (3000, 1024),
                  (24, 256), (2048, 1024), (256, 1024), (1536, 896),
                  (32, 256), (64, 256)):
        x = torch.randn(shape, generator=g, device="cuda") * 10.0 ** (
            torch.rand(shape, generator=g, device="cuda") * 6 - 3)
        got = ff_fused.mean_sq(x)
        want = ff_fused.mean_sq_plain(x)
        torch.cuda.synchronize()
        u = ulp_diff(got, want)
        worst_ulp = max(worst_ulp, u)
        worst_abs = max(worst_abs, float((got - want).abs().max()))
        log(f"mean_sq {shape}: kernel vs plain {u} ulp")
        if u > 1:
            raise AssertionError(f"mean_sq kernel {u} ulp from plain at "
                                 f"{shape} (limit 1)")
    checks["mean_sq"] = worst_abs

    checks["attention"] = attention_checks(torch, g)
    ssd_exp_checks(torch, g)

    worst_abs = 0.0
    scal = [torch.tensor(x, device="cuda") for x in ADAMW_SCALARS]
    # odd sizes, and the leaves tok (vocab x d) and w_gate (L x d x d_ff)
    # whole, as the optimizer updates them; lengths off the 4-wide packs,
    # and leaves 1-3 floats into their buffers (the 4-byte loop)
    for shape in ((33, 257), (1_000_003,), (49155, 2048), (40, 2048, 8192),
                  (1,), (3,), (5,), (67,)):
        worst_abs = max(worst_abs, adamw_check(torch, g, shape, scal))
    for off in (1, 2, 3):
        for shape in ((33, 257), (1_000_003,)):
            worst_abs = max(worst_abs, adamw_check(torch, g, shape, scal,
                                                   off))
    checks["adamw_update"] = worst_abs
    return checks


# ---------------------------------------------------------------------------
# the FF matmul path
# ---------------------------------------------------------------------------

def mm_operands(torch, g, mkn, integers=None):
    """(A, B) on the card: standard normal, or integers in the closed range
    ``integers``."""
    M, K, N = mkn
    if integers:
        lo, hi = integers
        return tuple(torch.randint(lo, hi + 1, s, generator=g, device="cuda")
                     .float() for s in ((M, K), (K, N)))
    return (torch.randn((M, K), generator=g, device="cuda"),
            torch.randn((K, N), generator=g, device="cuda"))


def same_bits(x, y) -> bool:
    """Equal values in both limbs (-0 == +0), no NaN."""
    import torch
    return all(torch.equal(a, b) and not torch.isnan(a).any()
               for a, b in zip(x, y))


def mm_bound_ok(name, got, exact, scale, K, rounded=False) -> float:
    """Each kernel's bound against float64 (the CPU tests' contracts):
    hybrid 2 K u S, Ozaki 2^-42 S, Dot2 u |E| + 2 K^2 u^2 S.  ``rounded``:
    ``got`` is an FF result rounded to f32 (a gradient), so u |E| for that
    rounding plus the impl's S term.  Returns the worst log2 |err| / S."""
    v = got[0].double() + got[1].double()
    err = (v - exact).abs()
    s_term = {"hybrid": 2 * K * U32, "ozaki": 2.0 ** -42,
              "dot2": 2 * K * K * U32 * U32}[name] * scale
    lim = s_term + (U32 * exact.abs() if rounded or name == "dot2" else 0)
    if not bool((err <= lim + 1e-30).all()):
        raise AssertionError(f"{name} kernel outside its float64 bound")
    return math.log2(max(float((err / scale).max()), 2.0 ** -80))


def ozaki_error_split(torch, A, B, exact, scale):
    """Where the Ozaki result's error against float64 comes from, each
    part's worst |part| / S as log2: the FF fold of the kept pair blocks
    (against their float64 sum), the dropped pairs (i + j > max_order), the
    f32 residual GEMM (against the same GEMM in float64), the final fold."""
    from repro_torch.core import ffmatmul
    from repro_torch.kernels import ff_matmul as km
    n, beta, bk, max_order = ffmatmul.ozaki_params(A.shape[1], block_k=512)
    pa, ra = ffmatmul.extract_slices(A, 1, n, beta)
    pb, rb = ffmatmul.extract_slices(B, 0, n, beta)
    pairs = km.ozaki_pairs(n, max_order)
    oh, ol = km.ozaki_accumulate(km.ozaki_operands(A, B, n, beta, bk), pairs)
    kept = sum(pa[i].double() @ sum(pb[j].double() for i2, j in pairs
                                    if i2 == i)
               for i in sorted({i for i, _ in pairs}))
    every = (A - ra).double() @ (B - rb).double()
    ra_a, b_rb = torch.cat([ra, A - ra], 1), torch.cat([B, rb], 0)
    res = torch.matmul(ra_a, b_rb)
    res64 = ra_a.double() @ b_rb.double()
    fh, fl = km.ff_matmul_ozaki(A, B)
    acc = oh.double() + ol.double()
    parts = {"total": fh.double() + fl.double() - exact,
             "fold": acc - kept, "dropped": every - kept,
             "residual_gemm": res.double() - res64,
             "final_fold": fh.double() + fl.double() - acc - res.double()}
    return {k: math.log2(max(float((v.abs() / scale).max()), 2.0 ** -80))
            for k, v in parts.items()}


def ozaki_flagged(torch, A, B, slices=0, bk=512):
    """Outputs outside the Ozaki kernel's bit contract: a row or column
    with a flushed slice (``2^g`` below 2^-149: ``_sigma`` flushed, the
    slice is the unrounded remainder) or a kept pair whose products' quantum
    ``2^(ga + gb)`` is below 2^-149 (the plain version's f32 products round
    there).  Returns the (M, N) mask."""
    from repro_torch.core import ffmatmul
    from repro_torch.kernels import ff_matmul as km
    n, beta, bk, max_order = ffmatmul.ozaki_params(
        A.shape[1], slices=slices, block_k=bk)
    ops = km.ozaki_operands(A, B, n, beta, bk)
    flag = torch.zeros((A.shape[0], B.shape[1]), dtype=torch.bool,
                       device=A.device)
    for i, j in km.ozaki_pairs(n, max_order):
        ga, gb = ops.ga[i][:, None], ops.gb[j][None, :]
        flag |= (ga < -149) | (gb < -149) | (ga + gb < -149)
    return flag


def phase_ozaki_cases(torch):
    """The Ozaki kernel bit for bit its plain version on the inputs where
    its integer form is at an edge: budget-edge operands (every slice
    integer 2^(beta-1), one sign, or alternating signs with positive
    products) at beta 8 (bk 512) and 12 (K = 2), also equal to float64
    (the tensor cores' f32 sums of those integers exact); beta 9, 10, 11
    (K = 100, 64, 16); slices=5 and 9; block_k=300 on K = 1000 (a K-block edge
    inside a K tile of the plain K); rows of A and columns of B spread over
    2^+-40; and rows near 2^-100..2^-120 (slices below the normal range,
    ``ozaki_flagged``), where the mismatching outputs are counted and must
    all be flagged.  Returns the largest kernel-vs-plain difference."""
    from repro_torch.kernels import ff_matmul as km
    g = torch.Generator(device="cuda").manual_seed(SEED + 9)

    def ones(M, K, N, alternate):
        A = torch.ones((M, K), device="cuda")
        B = torch.ones((K, N), device="cuda")
        if alternate:
            A[:, 1::2] = -1.0
            B[1::2, :] = -1.0
        return A, B

    def randn(M, K, N):
        return (torch.randn((M, K), generator=g, device="cuda"),
                torch.randn((K, N), generator=g, device="cuda"))

    def pow2(shape, lo, hi):
        return torch.randint(lo, hi + 1, shape, generator=g,
                             device="cuda").float().exp2()

    def spread(M, K, N):
        A, B = randn(M, K, N)
        return A * pow2((M, 1), -40, 40), B * pow2((1, N), -40, 40)

    cases = [("budget edge beta 8, one sign", ones(256, 2048, 256, False),
              {}),
             ("budget edge beta 8, alternating", ones(256, 2048, 256, True),
              {}),
             ("budget edge beta 12 (K = 2), one sign", ones(256, 2, 256, False),
              {}),
             ("budget edge beta 12 (K = 2), alternating",
              ones(256, 2, 256, True), {}),
             ("beta 9 (K = 100)", randn(300, 100, 200), {}),
             ("beta 10 (K = 64)", randn(300, 64, 200), {}),
             ("beta 11 (K = 16)", randn(300, 16, 200), {}),
             ("slices=5", randn(300, 1000, 200), {"slices": 5}),
             # more slices than a block stages exponents for (kExpSlices)
             ("slices=9", randn(300, 100, 200), {"slices": 9}),
             ("block_k=300 on K = 1000", randn(300, 1000, 200), {"bk": 300}),
             ("rows and columns over 2^+-40", spread(512, 2048, 1024), {})]
    worst = 0.0
    for what, (A, B), kw in cases:
        got = km.ff_matmul_ozaki(A, B, **kw)
        want = km.ff_matmul_ozaki_plain(A, B, **kw)
        if not same_bits(got, want):
            raise AssertionError(f"ozaki kernel != plain: {what}")
        note = ""
        if what.startswith("budget"):
            if not torch.equal(got[0].double() + got[1].double(),
                               A.double() @ B.double()):
                raise AssertionError(f"ozaki not exact: {what}")
            note = " and == float64"
        worst = max(worst, float((got[0] - want[0]).abs().max()))
        log(f"ozaki {what} {tuple(A.shape)} x {tuple(B.shape)}: kernel == "
            f"plain bit for bit{note}")
    # tiny rows: slices below the normal range, the FTZ policy's band
    A, B = randn(512, 2048, 1024)
    A[::2] *= pow2((256, 1), -120, -100)
    got, want = km.ff_matmul_ozaki(A, B), km.ff_matmul_ozaki_plain(A, B)
    bad = (got[0] != want[0]) | (got[1] != want[1])
    flag = ozaki_flagged(torch, A, B)
    log(f"ozaki rows near 2^-100..2^-120 (512, 2048, 1024): "
        f"{int(flag.sum())} outputs outside the bit contract (a slice or a "
        f"pair's quantum below 2^-149), {int(bad.sum())} differ from the "
        f"plain version, {int((bad & ~flag).sum())} of them elsewhere")
    if bool((bad & ~flag).any()):
        raise AssertionError("ozaki kernel != plain outside the flagged "
                             "outputs")
    return worst


def phase_matmul_checks(torch):
    """The three FF matmul kernels against their plain versions on the
    card, at the CPU tests' shapes and granite-3-2b's: Dot2 and Ozaki bit
    for bit (Ozaki's pair accumulation is exact, and the residual GEMM is
    the same call), hybrid within 2 bk u S (f32 block products of two GEMM
    orders) and bit for bit on integer operands, as Ozaki; hybrid and Dot2
    on transposed views bit for bit as on contiguous operands; each kernel
    within its bound of a float64 GEMM on the card; Ozaki's error split
    into its parts at the granite shapes; hybrid bit for bit and exact on
    non-negative integers whose sum needs lo.  Returns the largest
    kernel-vs-plain difference per kernel and the plain versions' times at
    the granite shapes."""
    from repro_torch.kernels import ff_matmul as km
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    kernels = {"hybrid": (km.ff_matmul, km.ff_matmul_plain),
               "ozaki": (km.ff_matmul_ozaki, km.ff_matmul_ozaki_plain),
               "dot2": (km.ff_matmul_dot2, km.ff_matmul_dot2_plain)}
    worst = {k: 0.0 for k in kernels}
    plain_ms = {k: {} for k in kernels}
    for mkn in MM_SMALL + MM_GRANITE:
        M, K, N = mkn
        A, B = mm_operands(torch, g, mkn)
        exact = A.double() @ B.double()
        scale = A.double().abs() @ B.double().abs()
        line = []
        for name, (kern, plain) in kernels.items():
            got, want = kern(A, B), plain(A, B)
            if mkn in MM_GRANITE:
                plain_ms[name][str(list(mkn))] = cuda_ms(
                    lambda: plain(A, B), 1)
            diff = (got[0].double() + got[1].double() - want[0].double()
                    - want[1].double()).abs()
            worst[name] = max(worst[name], float(diff.max()))
            if name == "hybrid":
                if not bool((diff <= 2 * min(512, K) * U32 * scale
                             + 1e-30).all()):
                    raise AssertionError(f"hybrid kernel vs plain at {mkn}")
            elif not same_bits(got, want):
                raise AssertionError(f"{name} kernel != plain at {mkn}")
            e = mm_bound_ok(name, got, exact, scale, K)
            line.append(f"{name} 2^{e:.1f}")
        if mkn in MM_SMALL or mkn == MM_GRANITE[0]:
            # transposed views, as the backward pass hands them over: the
            # kernels read through the strides, same bits as contiguous
            At, Bt = A.T.contiguous().T, B.T.contiguous().T
            for name in ("hybrid", "dot2"):
                if not same_bits(kernels[name][0](At, Bt),
                                 kernels[name][0](A, B)):
                    raise AssertionError(f"{name} on strided views at {mkn}")
            del At, Bt
        if mkn in MM_GRANITE:
            split = ozaki_error_split(torch, A, B, exact, scale)
            line.append("ozaki error parts " + ", ".join(
                f"{k} 2^{v:.1f}" for k, v in split.items()))
        Ai, Bi = mm_operands(torch, g, mkn, integers=(-8, 8))
        for name in ("hybrid", "ozaki"):
            kern, plain = kernels[name]
            got, want = kern(Ai, Bi), plain(Ai, Bi)
            if not (same_bits(got, want) and torch.equal(
                    got[0].double() + got[1].double(),
                    Ai.double() @ Bi.double())):
                raise AssertionError(f"{name} on integers at {mkn}")
        del A, B, exact, scale, Ai, Bi
        log(f"matmul {mkn}: vs float64 {', '.join(line)}; kernel vs plain: "
            f"ozaki, dot2 bitwise, hybrid within 2 bk u S; integers bitwise"
            + ("; strided views bitwise" if mkn in MM_SMALL
               or mkn == MM_GRANITE[0] else ""))
    # non-negative integers at w_down's shape: every 512-long block product
    # is exact (below 2^24), their sum is not, so hybrid's FF fold must
    # carry it in lo
    mkn = MM_GRANITE[1]
    Ai, Bi = mm_operands(torch, g, mkn, integers=(0, 127))
    got, want = km.ff_matmul(Ai, Bi), km.ff_matmul_plain(Ai, Bi)
    carried = int((got[1] != 0).sum())
    if not (same_bits(got, want) and carried and torch.equal(
            got[0].double() + got[1].double(), Ai.double() @ Bi.double())):
        raise AssertionError(f"hybrid on integers in [0, 127] at {mkn}")
    log(f"matmul {mkn}, integers in [0, 127]: hybrid kernel == plain == "
        f"float64 bit for bit; lo non-zero in {carried} of "
        f"{got[1].numel()} outputs")
    del Ai, Bi, got, want
    worst["ozaki"] = max(worst["ozaki"], phase_ozaki_cases(torch))
    phase_dot2_cases(torch)
    phase_hybrid_cases(torch)
    torch.cuda.synchronize()
    return worst, plain_ms


# the Dot2 kernel's edges: K of every slab width (dot2_vec: K = 1..7 give
# vec = K, 11 gives 1, 9 gives 3, 14 gives 7, 300 gives 8), M and N off its
# 64 x 64 block tile
DOT2_SLAB_K = (1, 2, 3, 4, 5, 6, 7, 11, 9, 14, 300)
DOT2_MN = tuple((m, n) for m in (1, 63, 65, 257) for n in (1, 5, 129))


def phase_dot2_cases(torch):
    """The Dot2 kernel bit for bit (signs of zero included) its plain
    version on the card, and within its float64 bound: K of every slab
    width, each with one (M, N) off the block tile, and every such (M, N)
    at K = 14 and 300; on operands whose exponents spread over 2^+-40, with
    signs alternating along K and signed zeros
    (``dot2_variants.spread_operands``: the sums cancel), contiguous and as
    transposed views."""
    from repro_torch.benchmarks import dot2_variants as dv
    from repro_torch.kernels import ff_matmul as km
    g = torch.Generator(device="cuda").manual_seed(SEED + 13)
    cases = ([(DOT2_MN[i % len(DOT2_MN)][0], k, DOT2_MN[i % len(DOT2_MN)][1])
              for i, k in enumerate(DOT2_SLAB_K)]
             + [(m, k, n) for k in (14, 300) for m, n in DOT2_MN])
    worst = -math.inf
    for mkn in cases:
        A, B = dv.spread_operands(mkn, g)
        want = km.ff_matmul_dot2_plain(A, B)
        for what, (a, b) in (("", (A, B)), (" (transposed views)", (
                A.T.contiguous().T, B.T.contiguous().T))):
            got = km.ff_matmul_dot2(a, b)
            if not dv.same_bits(got, want):
                raise AssertionError(f"dot2 kernel != plain at {mkn}{what}")
        worst = max(worst, mm_bound_ok(
            "dot2", got, A.double() @ B.double(),
            A.double().abs() @ B.double().abs(), mkn[1]))
    vecs = sorted({km.dot2_vec(k, 128, 8) for k in DOT2_SLAB_K})
    if vecs != list(range(1, 9)):
        raise AssertionError(f"dot2 cases cover vec {vecs}")
    log(f"dot2 edge cases: kernel == plain bit for bit at {len(cases)} "
        f"shapes (vec {vecs}; M, N off the 64 x 64 tile; exponents over "
        f"2^+-40, alternating signs, signed zeros), contiguous and "
        f"transposed; vs float64 2^{worst:.1f} of S at worst")


# the hybrid kernel's edges: M and N off its 128 x 64 tile and off its
# 4-wide copies, K off its K-tiles of 16; bk 1, 300, 512 and beyond K; the
# K-blocks split as hybrid_plan splits them, and over 1, 3 and 4 blocks
HYBRID_CASES = ((129, 300, 65), (1, 7, 1), (63, 1100, 129), (257, 513, 200),
                (130, 37, 70), (200, 1000, 131))
HYBRID_BK = (1, 300, 512, 4096)
HYBRID_SPLITS = (1, 3, 4)


def phase_hybrid_cases(torch):
    """The hybrid kernel bit for bit (signs of zero included) its earlier
    design, the check kernel ``csrc/ff_matmul_hybrid_check.cu``: on
    MM_SMALL and MM_GRANITE (normal operands; MM_SMALL also as transposed
    views), and on HYBRID_CASES at every bk of HYBRID_BK, on operands whose
    exponents spread over 2^+-40 with alternating signs and signed zeros
    (``dot2_variants.spread_operands``), contiguous and as transposed
    views, with the K-blocks split as ``hybrid_plan`` splits them and over
    each of HYBRID_SPLITS blocks."""
    from repro_torch.benchmarks import dot2_variants as dv
    from repro_torch.kernels import ff_matmul as km
    g = torch.Generator(device="cuda").manual_seed(SEED + 14)
    t0 = time.perf_counter()
    n = 0
    for mkn in MM_SMALL + MM_GRANITE:
        A, B = mm_operands(torch, g, mkn)
        want = km.ff_matmul_hybrid_check(A, B)
        forms = [("", A, B)]
        if mkn in MM_SMALL:
            forms.append((" (transposed views)", A.T.contiguous().T,
                          B.T.contiguous().T))
        for what, a, b in forms:
            if not dv.same_bits(km.ff_matmul(a, b), want):
                raise AssertionError(f"hybrid kernel != the check kernel at "
                                     f"{mkn}{what}")
            n += 1
        del A, B, want, forms
    for mkn in HYBRID_CASES:
        A, B = dv.spread_operands(mkn, g)
        forms = (("", A, B), (" (transposed views)", A.T.contiguous().T,
                              B.T.contiguous().T))
        for bk in HYBRID_BK:
            want = km.ff_matmul_hybrid_check(A, B, bk=bk)
            for what, a, b in forms:
                got = [("plan", km.ff_matmul(a, b, bk=bk))] + [
                    (f"{splits} splits", km.hybrid_launch(a, b, bk, splits))
                    for splits in HYBRID_SPLITS]
                for how, out in got:
                    if not dv.same_bits(out, want):
                        raise AssertionError(
                            f"hybrid kernel ({how}) != the check kernel at "
                            f"{mkn} bk {bk}{what}")
                    n += 1
    torch.cuda.synchronize()
    log(f"hybrid edge cases: kernel == the check kernel (the earlier design) "
        f"bit for bit in {n} comparisons: MM_SMALL and MM_GRANITE; "
        f"{len(HYBRID_CASES)} shapes off the tile x bk {list(HYBRID_BK)} x "
        f"the plan's split and {list(HYBRID_SPLITS)} splits, exponents over "
        f"2^+-40 with signed zeros, contiguous and transposed "
        f"({time.perf_counter() - t0:.1f} s)")


def launch_fns():
    """Every kernel's wrapper, by the name the launch counts use."""
    from repro_torch.kernels import (ff_attention, ff_elementwise, ff_fused,
                                     ff_guard, ff_math, ff_reduce)
    from repro_torch.kernels import ff_matmul as km
    return {"mean_sq": ff_fused.mean_sq,
            "attention": ff_attention.flash_attention_pallas,
            "adamw_update": ff_fused.adamw_update, "hybrid": km.ff_matmul,
            "ozaki": km.ff_matmul_ozaki, "dot2": km.ff_matmul_dot2,
            "ff_softmax": ff_fused.ff_softmax,
            "ff_norm_stats": ff_fused.ff_norm_stats,
            "ff_program": ff_fused.run_program,
            "ff_elementwise": ff_elementwise.elementwise,
            "ff_rowsum": ff_reduce.ff_rowsum,
            "ff_math": ff_math.math_elementwise,
            "ff_guard": ff_guard.guard_flags}


def launch_counts():
    """Every kernel's launches since the last reset_launch_counts()."""
    return {name: fn.launches for name, fn in launch_fns().items()}


def reset_launch_counts():
    for fn in launch_fns().values():
        fn.launches = 0


def path_counts(launches, name):
    """``launches``: {path: {kernel: launches}}, every kernel read around
    each path's run.  Returns ``name``'s total and its count per path."""
    by_path = {path: c[name] for path, c in launches.items()}
    return dict(launches=sum(by_path.values()), launches_by_path=by_path)


def phase_matmul_path(torch):
    """``repro_torch.ff.matmul`` at granite-3-2b's widths: the default and
    every kernel impl at the three shapes (one launch of the expected
    kernel per call, none for f64), the policy route, one FF-operand call,
    and one forward and backward per kernel impl at (512, 2048) @ (2048,
    8192) (three launches: the forward and the two backward products).
    Every result is finite, of its shape, and within its impl's bound of a
    float64 GEMM on the card."""
    import repro_torch.ff as ff
    from repro_torch.core.ff import FF
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    kernel_of = {"hybrid": "hybrid", "pallas_hybrid": "hybrid",
                 "dot2": "dot2", "pallas_dot2": "dot2", "ozaki": "ozaki",
                 "pallas_ozaki": "ozaki", "f64": None}
    bound_class = {"hybrid": "hybrid", "dot2": "dot2", "ozaki": "ozaki",
                   None: "ozaki"}

    def call(what, fn, kernel, exact, scale, K, shape):
        before = launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        after = launch_counts()
        got = {k: after[k] - before[k] for k in after}
        want = {k: int(k == kernel) for k in after}
        if got != want:
            raise AssertionError(f"{what}: launches {got} != {want}")
        if tuple(out.hi.shape) != shape or not (
                torch.isfinite(out.hi).all() and torch.isfinite(out.lo).all()):
            raise AssertionError(f"{what}: bad result")
        e = mm_bound_ok(bound_class[kernel], (out.hi, out.lo), exact, scale,
                        K)
        return f"{what} {ms:.1f} ms 2^{e:.1f}"

    reset_launch_counts()
    for mkn in MM_GRANITE:
        M, K, N = mkn
        A, B = mm_operands(torch, g, mkn)
        exact = A.double() @ B.double()
        scale = A.double().abs() @ B.double().abs()
        if ff.resolve_name("matmul", device=A.device) != "hybrid":
            raise AssertionError("the matmul default is not hybrid")
        rec = [call("default", lambda: ff.matmul(A, B), "hybrid", exact,
                    scale, K, (M, N))]
        for impl, kern in kernel_of.items():
            rec.append(call(impl, lambda impl=impl: ff.matmul(A, B, impl=impl),
                            kern, exact, scale, K, (M, N)))
        with ff.policy("ff_full", matmul="dot2"):
            rec.append(call("policy dot2", lambda: ff.matmul(A, B), "dot2",
                            exact, scale, K, (M, N)))
        if mkn == MM_GRANITE[0]:
            # an FF left operand: (A, A * 2^-30) as hi and lo
            lo = A * 2.0 ** -30
            ex = exact + (lo.double() @ B.double())
            rec.append(call("FF operand", lambda: ff.matmul(FF(A, lo), B),
                            "hybrid", ex, scale, K, (M, N)))
            del lo, ex
        log(f"ff.matmul {mkn}: " + "; ".join(rec))
        del A, B, exact, scale
    mkn = MM_GRANITE[0]
    for impl in ("hybrid", "dot2", "ozaki"):
        A, B = mm_operands(torch, g, mkn)
        A.requires_grad_()
        B.requires_grad_()
        before = launch_counts()
        out = ff.matmul(A, B, impl=impl)
        w = torch.randn(out.hi.shape, generator=g, device="cuda")
        (out.hi * w).sum().backward()
        torch.cuda.synchronize()
        after = launch_counts()
        got = {k: after[k] - before[k] for k in after}
        if got[impl] != 3 or sum(got.values()) != 3:
            raise AssertionError(f"backward {impl}: launches {got}")
        # the gradient against float64: dA = w @ B^T, dB = A^T @ w, each
        # the impl's FF product rounded to f32
        A64, B64, w64 = (t.detach().double() for t in (A, B, w))
        errs = []
        for grad, ex, sc, k in (
                (A.grad, w64 @ B64.T, w64.abs() @ B64.abs().T, mkn[2]),
                (B.grad, A64.T @ w64, A64.abs().T @ w64.abs(), mkn[0])):
            if not torch.isfinite(grad).all():
                raise AssertionError(f"backward {impl}: non-finite gradient")
            errs.append(mm_bound_ok(impl, (grad, torch.zeros_like(grad)), ex,
                                    sc, k, rounded=True))
        del A64, B64, w64
        log(f"ff.matmul {mkn} forward + backward ({impl}): launches {got}; "
            f"dA, dB vs float64 2^{errs[0]:.1f}, 2^{errs[1]:.1f} (bound "
            f"u |E| + the impl's S term)")
        del A, B, out, w
    launches = launch_counts()
    log(f"matmul path launches: {launches}")
    return launches


def matmul_ops(name, M, K, N, nk=0, vec=8) -> int:
    """f32 instructions the kernel's function needs on these inputs (FMA
    counted once): hybrid M N K FMAs and one fold (Add212) per output and
    K-block; Dot2 per slab of vec products each product's TwoProd and the
    add of its error, the tree's vec - 1 TwoSums, the adds of their errors
    and of each level's sum, the cascade (two TwoSums, two adds), and per
    output the final Fast2Sum and add."""
    if name == "hybrid":
        return M * N * K + M * N * nk * ADD212
    levels = (vec - 1).bit_length()                  # ceil(log2 vec)
    slab = (vec * (TWO_PROD + 1) + (vec - 1) * (TWO_SUM + 1) + levels
            + CASCADE + 1)
    return M * N * (-(-K // vec) * slab + 1 + FAST_TWO_SUM)


def ozaki_bound(ops, M, K, N, npairs, clock_hz):
    """The Ozaki kernel's least time on ``ozaki_operands``' outputs ``ops``,
    s, and what sets it: the pair products, 2 npairs M N K FLOP on the
    fp16 tensor cores; the fold, Add212 and its two scalings per output,
    K-block and pair on the f32 lanes; or the bytes (the fp16 operands and
    exponents read, both outputs written)."""
    nkb = -(-K // ops.bk)
    times = {"tensor cores": 2 * npairs * M * N * K / (TC_F16_FLOPS * clock_hz),
             "fold": npairs * nkb * M * N * (ADD212 + 2) / (F32_LANES
                                                            * clock_hz),
             "bytes": (2 * (ops.qa.numel() + ops.qb.numel())
                       + 4 * (ops.ga.numel() + ops.gb.numel())
                       + 8 * M * N) / HBM_BYTES_PER_S}
    what = max(times, key=times.get)
    return times[what], what, times


def ozaki_call_parts(torch, A, B):
    """ms of each part of one ``ff_matmul_ozaki`` call: the slicing (both
    operands' ``extract_slices``), ``ozaki_operands`` (the slicing
    included), the kernel (CUDA-graph replay), the residual GEMM with its
    concatenations, the final fold, and the whole call."""
    from repro_torch.core import ffmatmul
    from repro_torch.core import transforms as T
    from repro_torch.kernels import ff_matmul as km
    n, beta, bk, max_order = ffmatmul.ozaki_params(A.shape[1], block_k=512)
    pairs = km.ozaki_pairs(n, max_order)
    ops = km.ozaki_operands(A, B, n, beta, bk)
    oh, ol = km.ozaki_accumulate(ops, pairs)

    def residual():
        return torch.matmul(torch.cat([ops.ra, A - ops.ra], 1),
                            torch.cat([B, ops.rb], 0))

    res = residual()

    def final():
        sh, sl = T.two_sum(oh, res)
        return T.fast_two_sum(sh, sl + ol)

    return {"slicing": cuda_ms(lambda: (ffmatmul.extract_slices(
                A, 1, n, beta), ffmatmul.extract_slices(B, 0, n, beta)), 3),
            "ozaki_operands": cuda_ms(
                lambda: km.ozaki_operands(A, B, n, beta, bk), 3),
            "kernel": graph_ms(lambda: km.ozaki_accumulate(ops, pairs), 3),
            "residual_gemm": cuda_ms(residual, 3),
            "final_fold": cuda_ms(final, 3),
            "call": cuda_ms(lambda: km.ff_matmul_ozaki(A, B), 3)}


def phase_matmul_timing(torch, plain_ms, clock_hz):
    """Each matmul kernel at the three granite shapes: kernel ms from
    CUDA-graph replay, call ms of the wrapper from Python, the plain
    version's ms (phase_matmul_checks), the bound, and the PyTorch
    yardstick of each: an f64 torch.matmul on f64 copies (the same function
    at FF quality, before its rounding to FF; ``library_ms``), and for
    hybrid also an f32 torch.matmul (TF32 off; ``library_f32_ms``), which
    computes another function (no low limb) and was hybrid's earlier
    yardstick.  The Ozaki kernel runs on ``ozaki_operands``' outputs; its
    call is also timed part by part."""
    from repro_torch.core import ffmatmul
    from repro_torch.kernels import ff_matmul as km
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    peak_ops = F32_LANES * clock_hz
    rows = {k: [] for k in ("hybrid", "ozaki", "dot2")}
    for mkn in MM_GRANITE:
        M, K, N = mkn
        A, B = mm_operands(torch, g, mkn)
        A64, B64 = A.double(), B.double()
        nk = -(-K // 512)
        n, beta, bk, max_order = ffmatmul.ozaki_params(K, block_k=512)
        pairs = km.ozaki_pairs(n, max_order)
        ops = km.ozaki_operands(A, B, n, beta, bk)
        io = (M * K + K * N) * 4 + 2 * M * N * 4

        def f32_bound(byts, count):
            t_b, t_o = byts / HBM_BYTES_PER_S, count / peak_ops
            return (max(t_b, t_o), "bytes" if t_b >= t_o else "f32 lanes",
                    {"bytes": t_b, "f32 lanes": t_o})

        spec = {
            "hybrid": (lambda: km.ff_matmul(A, B),
                       lambda: km.ff_matmul(A, B),
                       f32_bound(io, matmul_ops("hybrid", M, K, N, nk=nk)),
                       lambda: torch.matmul(A64, B64)),
            "ozaki": (lambda: km.ozaki_accumulate(ops, pairs),
                      lambda: km.ff_matmul_ozaki(A, B),
                      ozaki_bound(ops, M, K, N, len(pairs), clock_hz),
                      lambda: torch.matmul(A64, B64)),
            "dot2": (lambda: km.ff_matmul_dot2(A, B),
                     lambda: km.ff_matmul_dot2(A, B),
                     f32_bound(io, matmul_ops("dot2", M, K, N)),
                     lambda: torch.matmul(A64, B64))}
        for name, (kern, call, (t, what, times), lib) in spec.items():
            rows[name].append(dict(
                shape=list(mkn), ms=graph_ms(kern, 3),
                call_ms=cuda_ms(call, 3),
                plain_ms=plain_ms[name][str(list(mkn))],
                bound_ms=1e3 * t,
                bound_by="bytes" if what == "bytes" else "operations",
                bound_of=what,
                bound_parts_ms={k: 1e3 * v for k, v in times.items()},
                library_ms=cuda_ms(lib, 5)))
        rows["hybrid"][-1]["library_f32_ms"] = cuda_ms(
            lambda: torch.matmul(A, B), 5)
        del ops
        rows["ozaki"][-1]["call_parts_ms"] = ozaki_call_parts(torch, A, B)
        del A, B, A64, B64
        torch.cuda.empty_cache()
    for name, recs in rows.items():
        for r in recs:
            log(f"{name} {r['shape']}: kernel {r['ms']:.4f} ms (call "
                f"{r['call_ms']:.4f}), plain {r['plain_ms']:.3f} ms, bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_of']}; "
                + ", ".join(f"{k} {v:.4f}" for k, v in
                            r["bound_parts_ms"].items())
                + f"), library {r['library_ms']:.4f} ms"
                + (f" (f64), f32 torch.matmul {r['library_f32_ms']:.4f} ms"
                   if "library_f32_ms" in r else "")
                + ("; call parts ms: " + ", ".join(
                    f"{k} {v:.4f}" for k, v in r["call_parts_ms"].items())
                   if "call_parts_ms" in r else ""))
    return rows


def matmul_kernel_entries(launches, worst, rows):
    """The kernels-line entries of the three matmul kernels: ``launches``
    as in :func:`path_counts`; the numbers of the first granite shape,
    every shape under ``by_shape``."""
    src = {"hybrid": ("ff_matmul_hybrid", "ff_matmul.cu", 89),
           "ozaki": ("ff_matmul_ozaki", "ff_matmul_ozaki.cu", 163),
           "dot2": ("ff_matmul_dot2", "ff_matmul_dot2.cu", 287)}
    out = []
    for name, (label, cu, line) in src.items():
        first = rows[name][0]
        out.append(dict(
            name=label, route="cuda", source=f"src/repro_torch/csrc/{cu}",
            replaces=f"src/repro/kernels/ff_matmul.py:{line}",
            **path_counts(launches, name), max_abs_err=worst[name],
            **{k: first[k] for k in (
                "ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "shape")}, by_shape=rows[name]))
    return out


def phase_matmul_table(torch):
    """The port's benchmark table at M = N = 128, K = 512 and 4096."""
    from repro_torch.benchmarks import table_ffmatmul
    rows = table_ffmatmul.run((512, 4096), M=128, N=128, device="cuda")
    log(table_ffmatmul.render(rows))
    log(f"table_ffmatmul: {json.dumps(rows)}")
    for r in rows:
        if r["path"] != "naive" and r["resolved_impl"] in (
                "dot2", "ozaki", "f64") and not r["log2_err"] <= -44:
            raise AssertionError(f"table_ffmatmul {r['path']} K={r['K']}: "
                                 f"2^{r['log2_err']:.1f} > 2^-44")


def phase_matmul(torch, clock_hz):
    worst, plain_ms = phase_matmul_checks(torch)
    launches = phase_matmul_path(torch)
    gc.collect()
    torch.cuda.empty_cache()
    rows = phase_matmul_timing(torch, plain_ms, clock_hz)
    phase_matmul_table(torch)
    gc.collect()
    torch.cuda.empty_cache()
    return launches, worst, rows


# ---------------------------------------------------------------------------
# the fused-composite path: ff_softmax, ff_norm_stats, the Program executor
# ---------------------------------------------------------------------------

# whole-row shapes: the reference table's two, granite-3-2b's d_model rows
# of a 4 x 128 step, the longest row the kernels take, ragged ones (cols
# % 4 != 0: streamed or re-read, or 4-byte copies), rows shorter than
# 128, the chaos smoke's token scores (1-3 rows over its vocabulary
# of 256), the reduced family training steps' loss (2 x 16 rows over 512)
ROW_SHAPES = ((4096, 4096), (256, 1024), (512, 2048), (64, 16384),
              (3, 1000), (5, 1001), (7, 3), (6, 100), (301, 4097),
              (1, 256), (2, 256), (3, 256), (32, 512))
TABLE_SHAPES = ((256, 1024), (4096, 4096), (512, 2048))
# per element: the 128-lane cascade of one value, TwoSum, the row max,
# Div22; the f32 builtins expf/logf counted as one instruction each (a
# floor: they take several)
SOFTMAX_OPS = {(False, "softmax"): 1 + 1 + 1 + CASCADE + 1,
               (False, "logsumexp"): 1 + 1 + 1 + CASCADE,
               (True, "softmax"): 1 + TWO_SUM + EXP22 + 2 * CASCADE + DIV22,
               (True, "logsumexp"): 1 + TWO_SUM + EXP22 + 2 * CASCADE}
NORM_STATS_OPS = CASCADE + 2 + CASCADE          # x; (x - mu)^2
AXPY_OPS = MUL212 + ADD22


def softmax_oracle(x, mode):
    """float64 softmax / log-sum-exp on the card."""
    x64 = x.double()
    m = x64.amax(-1, keepdim=True)
    s = (x64 - m).exp().sum(-1, keepdim=True)
    if mode == "softmax":
        return (x64 - m).exp() / s
    return (m + s.log())[..., 0]


def softmax_bound_ok(got, want, x, mode, accurate) -> float:
    """Each mode's bound against float64, with u = 2^-24: accurate, 2 u of
    the value (the FF exponentials and sum carry ~2^-44: only the final
    rounding shows).  Fast: the rounded shift x - m puts |x - m| u into
    exp and expf adds up to 2 ulp (4 u), so a term e_j is within
    (d_j + 4) u, the sum within S u with S the e-weighted mean of
    (d_k + 4); softmax within (d_j + 4 + S + 1) u of the value,
    logsumexp within (|lse| + 2 |log s| + S) u (logf 1 ulp, the final
    add).  Returns the worst error in units of u of the value."""
    err = (got.double() - want).abs()
    tiny = 2.0 ** -126
    x64 = x.double()
    d = (x64 - x64.amax(-1, keepdim=True)).abs()
    w = (-d).exp()
    s = w.sum(-1, keepdim=True)
    S = ((w / s) * (d + 4.0)).sum(-1, keepdim=True)
    if accurate:
        lim = 2.0 * U32 * want.abs() + tiny
    elif mode == "softmax":
        lim = (d + 5.0 + S) * U32 * want.abs() + tiny
    else:
        lim = (want.abs() + 2.0 * s[..., 0].log().abs() + S[..., 0]) * U32
    if not bool((err <= lim).all()):
        raise AssertionError(f"ff_softmax {mode} accurate={accurate} "
                             f"outside its float64 bound")
    return float((err / (want.abs() * U32 + tiny)).max())


def program_cases(torch, g):
    """(name, fused chain, operands) on the card for the Program checks:
    axpy at each of the table's shapes; a chain with every op class; row,
    column and scalar leaves; a ragged rowsum and a column-broadcast
    rowsum; the mean_sq program."""
    from repro_torch.core.ff import FF
    from repro_torch.ff import fusion as m

    def rn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale

    def pair(*shape):
        h = rn(*shape)
        return FF(h, h * 1e-8 * rn(*shape))

    def every_op(a, x, y, f, p):
        t = x * y + a
        u = t / y
        s = m.sqrt(u * u + 1.0)
        z = -m.fma(x, y, s) - x
        f2 = (f * f - f / p) + m.sqrt(p)
        q = m.pack(f2, -f) * 2.0
        return (z, s.hi, -f2, q, q.hi + z.lo, m.scale(x, 0.5) - 1.0,
                m.exp(x * 0.5), m.log(m.pack(p, p * 0.0)), m.tanh(x),
                m.sigmoid(y), m.tanh(f * 0.3), m.exp(f * 0.5),
                m.log(p + 1.0), (f2 * f).sum(), f.sum())

    R, C = 512, 2048
    a = torch.tensor(1.618, device="cuda")
    return [
        (f"axpy {shape}", lambda a, x, y: a * x + y,
         (a, pair(*shape), pair(*shape))) for shape in TABLE_SHAPES] + [
        ("every op class", every_op,
         (1.5, pair(R, C), pair(R, C), rn(R, C), rn(R, C).abs() + 0.1)),
        ("row, column and scalar leaves",
         lambda x, c, r, s: (x * c + r, (c * r).sum(), c.sum(),
                             (x.hi * s).sum(), r * s),
         (pair(R, C), rn(R, 1), rn(C), a)),
        ("ragged and column-broadcast rowsums",
         lambda v, w, c: ((v * w).sum(), (c * 2.0).sum(), v + w),
         (rn(3, 1000), rn(1000), rn(3, 1))),
        ("mean_sq program", lambda v: (v * v).sum(), (rn(R, C),)),
    ]


def flat_limbs(outs):
    from repro_torch.core.ff import FF
    for o in outs:
        if isinstance(o, FF):
            yield o.hi
            yield o.lo
        else:
            yield o


def check_row_kernels(torch, name, x, worst):
    """ff_softmax (both modes, both classes) and ff_norm_stats on the
    rows x against their plain versions: bit for bit, the fast softmax
    within 1 ulp, a NaN for a NaN; rows of finite x also within their
    float64 bounds.  Logs the path each kernel took."""
    from repro_torch.kernels import ff_fused
    fin = torch.isfinite(x).all(-1)
    line, paths = [], set()
    for mode in ("softmax", "logsumexp"):
        want64 = softmax_oracle(x[fin], mode)
        for accurate in (False, True):
            got = ff_fused.ff_softmax(x, mode, accurate)
            paths.add(f"ff_softmax {ff_fused.ff_softmax.last_path}")
            want = ff_fused.ff_softmax_plain(x, mode, accurate)
            u = ulp_diff(got, want)
            if u > (0 if accurate else 1):
                raise AssertionError(
                    f"ff_softmax {mode} accurate={accurate} {name}: "
                    f"kernel {u} ulp from plain")
            worst["ff_softmax"] = max(worst["ff_softmax"], float(
                torch.nan_to_num((got - want).abs(), nan=0.0).max()))
            e = (softmax_bound_ok(got[fin], want64, x[fin], mode, accurate)
                 if bool(fin.any()) else float("nan"))
            line.append(f"{mode}{' acc' if accurate else ''} {u} ulp "
                        f"({e:.1f} u vs float64)")
    mu, var = ff_fused.ff_norm_stats(x)
    paths.add(f"ff_norm_stats {ff_fused.ff_norm_stats.last_path}")
    pmu, pvar = ff_fused.ff_norm_stats_plain(x)
    if ulp_diff(mu, pmu) or ulp_diff(var, pvar):
        raise AssertionError(f"ff_norm_stats {name}: kernel != plain "
                             f"({ulp_diff(mu, pmu)}, {ulp_diff(var, pvar)} "
                             f"ulp)")
    v64, m64 = torch.var_mean(x[fin].double(), -1, correction=0)
    if not (bool(((mu[fin].double() - m64).abs() <= 2.0 ** -20
                  * x[fin].abs().amax(-1)).all())
            and bool(((var[fin].double() - v64).abs() <= 2.0 ** -20
                      * v64).all())):
        raise AssertionError(f"ff_norm_stats {name} vs float64")
    log(f"fused {name}: ff_softmax kernel vs plain: {'; '.join(line)}"
        f"; ff_norm_stats bitwise; {int((~fin).sum())} non-finite rows "
        f"(a NaN for a NaN); paths {', '.join(sorted(paths))}")


def phase_fused_checks(torch):
    """Each new kernel against its plain version on the card: ff_softmax
    (both modes, both classes) bit for bit when accurate and within 1 ulp
    with expf, each within its float64 bound; ff_norm_stats bit for bit;
    at ``ROW_SHAPES``, on rows offset 1-3 floats from a 16-byte boundary
    and on ``row_variants.row_edges`` (+-0 max tie, NaN, +inf, all -inf;
    ``check_row_kernels``);
    the Program kernel bit for bit on every case of ``program_cases``,
    and against the two dedicated kernels on their Programs: the AdamW
    kernel at 0 ulp, mean_sq at <= 1 ulp.  Returns the largest
    kernel-vs-plain differences and the plain versions' times."""
    import repro_torch.ff as ff
    from repro_torch.benchmarks.row_variants import row_edges
    from repro_torch.benchmarks.stream_variants import offset_view
    from repro_torch.kernels import ff_fused
    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    worst = {"ff_softmax": 0.0, "ff_norm_stats": 0.0, "ff_program": 0.0}
    plain_ms = {}
    cases = [(f"{shape}", torch.randn(shape, generator=g, device="cuda")
              * 3.0) for shape in ROW_SHAPES]
    cases += [(f"{shape} offset {o}", offset_view(torch.randn(
        shape, generator=g, device="cuda") * 3.0, o))
        for shape, o in (((271, 2048), 1), ((271, 4096), 2),
                         ((3, 16384), 3))]
    cases += [(f"edge: {k}", v) for k, v in row_edges("cuda").items()]
    for name, x in cases:
        check_row_kernels(torch, name, x, worst)
        if name == f"{ROW_SHAPES[0]}":
            for mode in ("softmax", "logsumexp"):
                for accurate in (False, True):
                    plain_ms[(mode, accurate)] = cuda_ms(
                        lambda: ff_fused.ff_softmax_plain(x, mode,
                                                          accurate), 1)
            plain_ms["norm_stats"] = cuda_ms(
                lambda: ff_fused.ff_norm_stats_plain(x), 1)
        del x
    del cases
    torch.cuda.synchronize()

    for name, fn, ops in program_cases(torch, g):
        f = ff.fused(fn)
        prog = f.program(*ops)
        n0 = ff_fused.run_program.launches
        got = f(*ops)
        got = got if isinstance(got, tuple) else (got,)
        if ff_fused.run_program.launches != n0 + 1:
            raise AssertionError(f"ff.fused {name}: not one launch")
        want = ff_fused.run_program_plain(prog, ops)
        if name == "axpy (4096, 4096)":
            plain_ms["axpy"] = cuda_ms(
                lambda: ff_fused.run_program_plain(prog, ops), 1)
        bad = [i for i, (a, b) in enumerate(zip(flat_limbs(got),
                                                flat_limbs(want)))
               if a.shape != b.shape or ulp_diff(a, b) != 0]
        for a, b in zip(flat_limbs(got), flat_limbs(want)):
            worst["ff_program"] = max(worst["ff_program"], float(
                (a - b).abs().max()))
        if bad:
            raise AssertionError(f"ff.fused {name}: kernel != plain in "
                                 f"output limbs {bad}")
        log(f"ff.fused {name}: {len(prog.instrs)} instructions, "
            f"{len(prog.out_ids)} outputs: kernel == plain bit for bit")
    del ops

    # the general executor against the dedicated kernels
    scal = [torch.tensor(s, device="cuda") for s in ADAMW_SCALARS]
    leaves = adamw_leaves(torch, g, (2048, 8192))
    chain = ff.fused(lambda *a: adamw_chain(*a, ADAMW_EPS, ADAMW_WD))
    new, m2, v2 = chain(*leaves, *scal)
    ff_fused.adamw_update(*leaves, *scal, eps=ADAMW_EPS, wd=ADAMW_WD)
    u = max(ulp_diff(a, b) for a, b in ((new.hi, leaves[3]),
                                        (new.lo, leaves[4]),
                                        (m2, leaves[1]), (v2, leaves[2])))
    if u != 0:
        raise AssertionError(f"Program AdamW vs the AdamW kernel: {u} ulp")
    x = torch.randn((512, 2048), generator=g, device="cuda")
    ms_prog = ff_fused.div_n(ff.fused(lambda v: (v * v).sum())(x).hi,
                             x.shape[-1])
    u2 = ulp_diff(ms_prog, ff_fused.mean_sq(x))
    if u2 > 1:
        raise AssertionError(f"Program mean_sq vs the mean_sq kernel: "
                             f"{u2} ulp")
    log(f"Program executor vs dedicated kernels: AdamW (2048, 8192) {u} "
        f"ulp on w, wlo, m, v; mean_sq (512, 2048) {u2} ulp")
    del leaves, new, m2, v2, x
    torch.cuda.synchronize()
    return worst, plain_ms


def adamw_chain(g, m, v, w, wlo, lr, b1, b2, bc1, bc2, eps, wd):
    """The reference's ``_adamw_chain`` over ``ff.fusion`` nodes."""
    from repro_torch.ff import fusion
    m2 = b1 * m + (1.0 - b1) * g
    v2 = b2 * v + (1.0 - b2) * g * g
    upd = (m2 / bc1) / (fusion.sqrt(v2 / bc2) + eps)
    upd = upd + wd * w
    delta = -lr * upd
    return fusion.pack(w, wlo) + delta, m2, v2


def phase_fused_routing(torch):
    """At granite-3-2b's vocabulary (4, 49155) the whole-row kernels do not
    apply: ff.logsumexp and ff.softmax take the jnp formulation with one
    warning each and launch no ff_softmax, as the reference does."""
    import warnings
    import repro_torch.ff as ff
    from repro_torch.ff import dispatch
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    x = torch.randn((4, 49155), generator=g, device="cuda") * 4.0
    for op, jnp_fn in (("logsumexp", dispatch._logsumexp_jnp),
                       ("softmax", dispatch._softmax_jnp)):
        if ff.resolve_name(op, device=x.device) != "pallas":
            raise AssertionError(f"{op} does not resolve to pallas")
        n0 = launch_counts()["ff_softmax"]
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            got = getattr(ff, op)(x)
        torch.cuda.synchronize()
        n = launch_counts()["ff_softmax"] - n0
        if len(rec) != 1 or n:
            raise AssertionError(f"{op} (4, 49155): {len(rec)} warnings, "
                                 f"{n} launches")
        if not torch.equal(got, jnp_fn(x)):
            raise AssertionError(f"{op} (4, 49155) != the jnp formulation")
    log("routing by shape at (4, 49155): logsumexp and softmax take the "
        "jnp formulation, one warning each, 0 ff_softmax launches")


def phase_table(torch):
    """``repro_torch.benchmarks.table_elementwise`` at its three shapes on
    the card (its accuracy gate raises on a miss), with every kernel's
    launches over the run: each of the five kernels of its chains at least
    once, no other."""
    from repro_torch.benchmarks import table_elementwise
    reset_launch_counts()
    t0 = time.perf_counter()
    rows = table_elementwise.run(TABLE_SHAPES, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    log(table_elementwise.render(rows))
    log(f"table_elementwise: {json.dumps(rows)}")
    log(f"table path: {wall:.1f} s, launches {launches}")
    used = {k for k, n in launches.items() if n}
    if used != {"ff_softmax", "ff_norm_stats", "ff_program", "mean_sq",
                "adamw_update"}:
        raise AssertionError(f"table path launched {launches}")
    resolved = {r["chain"]: r["resolved_impl"] for r in rows}
    if resolved != {"adamw": "fused", "softmax": "pallas",
                    "logsumexp": "pallas", "rmsnorm_stats": "fused",
                    "norm_stats": "pallas", "axpy": "fused(cuda)"}:
        raise AssertionError(f"table resolved {resolved}")
    return launches


def time_kernel(kern, call, plain, lib, byts, ops, peak_ops, iters):
    """Kernel ms (CUDA-graph replay), call ms, the bound and the library
    call's ms of one kernel at one shape."""
    t_b, t_o = byts / HBM_BYTES_PER_S, ops / peak_ops
    return dict(ms=graph_ms(kern, iters), call_ms=cuda_ms(call, iters),
                plain_ms=plain, bound_ms=1e3 * max(t_b, t_o),
                bound_by="bytes" if t_b >= t_o else "operations",
                library_ms=None if lib is None else graph_ms(lib, iters))


def phase_fused_timing(torch, plain_ms, clock_hz):
    """Each new kernel at the table's (4096, 4096) and at (512, 2048):
    kernel ms by CUDA-graph replay, the call's ms, the plain version's ms
    (phase_fused_checks), the bound, and the library call's ms."""
    import repro_torch.ff as ff
    from repro_torch.core.ff import FF
    from repro_torch.kernels import ff_fused
    g = torch.Generator(device="cuda").manual_seed(SEED + 8)
    peak_ops = F32_LANES * clock_hz
    rows = {"ff_softmax": [], "ff_norm_stats": [], "ff_program": []}
    for R, C in ((4096, 4096), (512, 2048)):
        x = torch.randn((R, C), generator=g, device="cuda") * 3.0
        n = R * C
        for mode in ("softmax", "logsumexp"):
            for acc in (False, True):
                byts = 4 * n + (4 * n if mode == "softmax" else 4 * R)
                ops = n * SOFTMAX_OPS[(acc, mode)] + R * LANE_FOLD
                lib = (lambda: torch.softmax(x, -1)) if mode == "softmax" \
                    else (lambda: torch.logsumexp(x, -1))
                rec = time_kernel(
                    lambda m=mode, a=acc: ff_fused.ff_softmax(x, m, a),
                    lambda m=mode, a=acc: ff_fused.ff_softmax(x, m, a),
                    plain_ms.get((mode, acc)) if R == 4096 else None, lib,
                    byts, ops, peak_ops, 20)
                rows["ff_softmax"].append(dict(
                    shape=[R, C], mode=mode, accurate=acc,
                    path=ff_fused.ff_softmax.last_path, **rec))
        rows["ff_norm_stats"].append(dict(shape=[R, C], **time_kernel(
            lambda: ff_fused.ff_norm_stats(x),
            lambda: ff_fused.ff_norm_stats(x),
            plain_ms["norm_stats"] if R == 4096 else None,
            lambda: torch.var_mean(x, -1, correction=0), 4 * n + 8 * R,
            n * NORM_STATS_OPS + 2 * R * LANE_FOLD, peak_ops, 20),
            path=ff_fused.ff_norm_stats.last_path))
        a = torch.tensor(1.618, device="cuda")
        xf = FF(x, x * 1e-8)
        yf = FF(x * 0.5, x * 1e-9)
        axpy = ff.fused(lambda a, x, y: a * x + y)
        prog = axpy.program(a, xf, yf)
        rows["ff_program"].append(dict(shape=[R, C], program="axpy",
                                       **time_kernel(
            lambda: ff_fused.run_program(prog, (a, xf, yf)),
            lambda: axpy(a, xf, yf),
            plain_ms["axpy"] if R == 4096 else None, None, 6 * 4 * n + 4,
            n * AXPY_OPS, peak_ops, 20)))
        del x, xf, yf
    for name, recs in rows.items():
        for r in recs:
            what = (f" {r['mode']}{' accurate' if r['accurate'] else ''}"
                    if name == "ff_softmax" else "")
            log(f"{name}{what} {r['shape']}: kernel {r['ms']:.4f} ms (call "
                f"{r['call_ms']:.4f}), plain {r['plain_ms']}, bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}), library "
                f"{r['library_ms']}"
                + (f", path {r['path']}" if "path" in r else ""))
    return rows


def fused_kernel_entries(launches, worst, rows):
    """The kernels-line entries of the three fused-composite kernels:
    ``launches`` as in :func:`path_counts`; the numbers of the first timed row (fast softmax, axpy) at (4096,
    4096), every timed row under ``by_shape``."""
    src = {"ff_softmax": ("ff_softmax.cu", 407),
           "ff_norm_stats": ("ff_norm_stats.cu", 469),
           "ff_program": ("ff_program.cu", 188)}
    out = []
    for name, (cu, line) in src.items():
        first = rows[name][0]
        out.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/csrc/{cu}",
            replaces=f"src/repro/kernels/ff_fused.py:{line}",
            **path_counts(launches, name), max_abs_err=worst[name], **{k: first[k] for k in (
                "ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "shape")}, by_shape=rows[name]))
    return out


def phase_fused(torch, clock_hz):
    worst, plain_ms = phase_fused_checks(torch)
    phase_fused_routing(torch)
    gc.collect()
    torch.cuda.empty_cache()
    launches = phase_table(torch)
    gc.collect()
    torch.cuda.empty_cache()
    rows = phase_fused_timing(torch, plain_ms, clock_hz)
    gc.collect()
    torch.cuda.empty_cache()
    return launches, worst, rows


# ---------------------------------------------------------------------------
# the paper's operators, ff.math and ff.tune

EW_SHAPES = ((3, 130), (4096, 4096), (512, 2048))
ROWSUM_SHAPES = ((3, 64), (5, 300), (4096, 4096), (512, 49155))
MATH_BIG = (512, 8192)                   # the silu gate of 512 tokens
TUNE_SHAPES = ((256, 1024), (4096, 4096), (512, 2048), (512, 8192))
TUNE_OPS = ("add", "mul", "div", "sqrt", "sum", "exp", "expm1", "log",
            "log1p", "tanh", "sigmoid", "erf", "gelu", "silu", "pow")
DEFAULT_SHAPE = (512, 2048)
FF_MATH_REQUESTS, FF_MATH_MAX_NEW = 4, 4
# the one-kernel tier of each tuned op, by the launch counts' names
KERNEL_TIER = {"pallas": {**{op: "ff_elementwise" for op in
                             ("add", "mul", "div", "sqrt")},
                          **{op: "ff_math" for op in TUNE_OPS[5:]}},
               "pallas_rowsum": {"sum": "ff_rowsum"}}

# f32 instructions per element (csrc/ff_eft.cuh, counted as above); a
# function with branches counts the branch each element takes
SQRT22 = 1 + TWO_PROD + 3 + 2 + FAST_TWO_SUM              # 11
EW_OPS_COUNT = {"add22": ADD22, "mul22": MUL22, "div22": DIV22,
                "sqrt22": SQRT22, "two_sum": TWO_SUM, "two_prod": TWO_PROD}
EW_BYTES = {"add22": 24, "mul22": 24, "div22": 24, "sqrt22": 16,
            "two_sum": 16, "two_prod": 16}
EXPM1_OPS = EXP22 + ADD212 + 4
ATANH = MUL22 + 10 + 4 * (MUL22 + ADD22)                  # 99
LOG22_OPS = 8 + 2 * ADD212 + DIV22 + ATANH + MUL22 + 2 + MUL212 + ADD22 + 6
LOG1P_NEAR = ADD212 + DIV22 + ATANH + MUL22 + 2 + 4
LOG1P_FAR = TWO_SUM + 1 + FAST_TWO_SUM + LOG22_OPS + 4
TANH_SMALL = MUL22 + 10 + 6 * (MUL22 + ADD22) + MUL22 + 4
TANH_LARGE = 3 + EXPM1_OPS + ADD212 + DIV22 + 2 + 4
TANH_IDENTITY = 2                        # |x| and the band test
SIGMOID_OPS = 3 + EXP22 + ADD212 + DIV22 + 2
SILU_OPS = SIGMOID_OPS + MUL22 + 3
ERF_PRO = 6                              # sign, |x|, clamp, band selects
ERF_SMALL = MUL22 + 16 * (MUL22 + 2 * DIV22 + ADD22 + 2) + 2 * MUL22
ERF_MID = MUL22 + 2 + 59 * (MUL22 + DIV22 + ADD22) + EXP22 + 3 * MUL22
ERF_BIG = MUL22 + 1 + 24 + EXP22 + MUL212 + MUL22 + DIV22 + ADD212
GELU_EXTRA = 2 * MUL22 + ADD212 + 5
# the divisors of erf's series: n = 1..16, 2n + 1 = 3..119
ERF_DIVISORS = list(range(1, 17)) + list(range(17, 120, 2))
# erf's three bands of |x| (gelu's |x| / sqrt2), for band-pure timing rows
ERF_BANDS = {"small": (0.0, 1.0), "mid": (1.0, 4.0), "big": (4.0, 8.0)}
POW_OPS = LOG22_OPS + MUL22 + EXP22 + 6
# NUMERICS.md's full-domain contracts of ff.math, with the ranges the CPU
# tests sample (tests/test_torch_math.py)
MATH_CONTRACT = {"exp": ((-55, 88), 2.0 ** -42),
                 "expm1": ((-20, 20), 2.0 ** -41),
                 "log": ((0.01, 1e6), 2.0 ** -42),
                 "log1p": ((-0.29, 0.41), 2.0 ** -43),
                 "tanh": ((-20, 20), 2.0 ** -41),
                 "sigmoid": ((-30, 30), 2.0 ** -42),
                 "erf": ((-6, 6), 2.0 ** -42), "gelu": ((-1, 20), 2.0 ** -42),
                 "silu": ((-30, 30), 2.0 ** -42)}


def math_ops(op, x) -> int:
    """f32 instructions ``op`` needs on the hi limbs ``x``: each element
    counted on the branch it takes."""
    n = x.numel()
    a = x.abs()
    if op == "log1p":
        near = int(((x >= -0.2928932) & (x <= 0.41421354)).sum())
        return near * LOG1P_NEAR + (n - near) * LOG1P_FAR
    if op == "tanh":
        ident = int((a < 2.0 ** -45).sum())
        small = int((a <= 0.35).sum()) - ident
        return (ident * TANH_IDENTITY + small * TANH_SMALL
                + (n - small - ident) * TANH_LARGE)
    if op in ("erf", "gelu"):
        v = a if op == "erf" else a * 0.70710677
        small = int((v <= 1.0).sum())
        mid = int(((v > 1.0) & (v <= 4.0)).sum())
        ops = (n * ERF_PRO + small * ERF_SMALL + mid * ERF_MID
               + (n - small - mid) * ERF_BIG)
        return ops + (n * GELU_EXTRA if op == "gelu" else 0)
    return n * {"exp": EXP22, "expm1": EXPM1_OPS, "log": LOG22_OPS,
                "sigmoid": SIGMOID_OPS, "silu": SILU_OPS,
                "pow": POW_OPS}[op]


def same_nan(a, b) -> bool:
    """The same bits (a NaN matches any NaN: its sign and payload are the
    arithmetic's, not the algorithm's)."""
    import torch
    a, b = a.contiguous(), b.contiguous()
    na, nb = torch.isnan(a), torch.isnan(b)
    if a.shape != b.shape or not torch.equal(na, nb):
        return False
    return bool(((a.view(torch.int32) == b.view(torch.int32)) | na).all())


def ff_limbs(torch, x64):
    """FF limbs (hi = fl32(x), lo = fl32(x - hi)) of float64 values on the
    card; lo is 0 where x is not finite."""
    hi = x64.to(torch.float32)
    lo = torch.where(torch.isfinite(x64), x64 - hi.double(), 0.0)
    return hi, lo.to(torch.float32)


def math_branch_inputs(torch, op, g):
    """Inputs on the card that cover each branch of ``op`` (erf's three
    bands, also interleaved element by element, log1p near and far,
    tanh's two forms, the identity bands, the saturations, +-0, +-inf,
    nan) with normal limbs; for sigmoid and silu also the edge classes of
    their FMA path (``math_variants.sigmoid_edges``: subnormal z, k ln2
    cancelled by lo, |x| from 2^-150, signed-zero and subnormal limbs,
    exact products, lo beyond hi, non-finite limbs), for pow and log1p
    those of theirs (``math_variants.log_pow_edges``: a = 1, tiny atanh
    arguments, |b| from 2^100 and below 2^-90, the saturations, lo beyond
    hi, 2 + x near 0, exact products, subnormal and non-finite limbs), for
    expm1 and log those of theirs (``math_variants.exp_log_edges``: the
    identity edge, k flipping at +-ln2/2, r cancelling near k ln2, lo +-0
    at k == 0, x = 2^k (1 + tiny), powers of two, s near +-2^6.8, exact
    products, lo beyond hi, the clip edges, subnormal and non-finite
    limbs), for exp its own of them (+-0 and |x| around 2^-48, r cancelling
    near k ln2 down to x = -104, the overflow and clip edges)."""
    def u(a, b, n=4096):
        return torch.rand(n, generator=g, device="cuda",
                          dtype=torch.float64) * (b - a) + a
    tiny = u(-1, 1, 512) * 10.0 ** u(-30, -14, 512)
    spec = torch.tensor([0.0, -0.0, math.inf, -math.inf, math.nan],
                        device="cuda", dtype=torch.float64)
    parts = {
        "exp": [u(-0.34, 0.34), u(-60, 88), u(88.5, 120, 64),
                u(-200, -106, 64)],
        "expm1": [u(-0.34, 0.34), u(-20, 20), u(-85, 88), tiny],
        "log": [u(0.7, 1.42), torch.exp(u(-50, 50))],
        "log1p": [u(-0.29, 0.41), torch.exp(u(-30, 4)), u(-0.99, -0.3),
                  tiny],
        "tanh": [u(-0.35, 0.35), u(-20, 20), tiny],
        "sigmoid": [u(-30, 30), u(-65, -30)],
        "erf": [u(-1, 1), u(-4, 4), u(-8.2, 8.2), u(31, 1e6, 64),
                torch.stack([u(-1, 1, 2048), u(1, 4, 2048),
                             u(4, 8.2, 2048)], -1).flatten()],
        "gelu": [u(-1, 11.5), u(-8, -1), u(-0.5, 0.5),
                 torch.stack([u(-1.4, 1.4, 2048), u(1.5, 5.6, 2048),
                              u(5.7, 11.5, 2048)], -1).flatten()],
        "silu": [u(-30, 30), u(-65, 80)],
        "pow": [torch.exp(u(-3, 3))],
    }[op]
    x = torch.cat(parts + ([] if op == "pow" else [spec]))
    hi, lo = ff_limbs(torch, x)
    if op in ("sigmoid", "silu", "expm1", "log", "exp"):   # FMA path edges
        from repro_torch.benchmarks import math_variants as mv
        edges = (mv.sigmoid_edges("cuda", seed=SEED) if op in ("sigmoid",
                 "silu") else mv.exp_log_edges("cuda", seed=SEED)[op])
        return (torch.cat([hi] + [h for h, _ in edges.values()]),
                torch.cat([lo] + [e for _, e in edges.values()]))
    if op not in ("pow", "log1p"):
        return (hi, lo)
    from repro_torch.benchmarks.math_variants import log_pow_edges
    edges = log_pow_edges("cuda", seed=SEED)[op].values()
    planes = (hi, lo)
    if op == "pow":
        bh, bl = ff_limbs(torch, u(-8, 8, x.numel()))
        edge = torch.tensor([[0.0, 1.5], [0.0, -1.5], [0.0, 0.0],
                             [math.inf, 2.0], [math.inf, -2.0],
                             [math.inf, 0.0], [-2.0, 0.5], [-2.0, 0.0]],
                            device="cuda")
        planes = (torch.cat([hi, edge[:, 0]]), torch.cat([lo, edge[:, 0] * 0]),
                  torch.cat([bh, edge[:, 1]]), torch.cat([bl, edge[:, 1] * 0]))
    return tuple(torch.cat([p] + [c[i] for c in edges])
                 for i, p in enumerate(planes))


def band_schedule_inputs(torch, op, g):
    """(name, planes) of erf or gelu for the band-sorted kernel, at
    MATH_BIG: erf's argument (gelu's x / sqrt2) from the three bands
    interleaved element by element, of either sign, with +-0, +-inf and
    nan every 97th element; each band alone; ragged edges (a strided
    (517, 8191) view, and (3, 130)); a row and a column operand plane."""
    R, C = MATH_BIG
    scale = 1.0 if op == "erf" else math.sqrt(2.0)

    def band(b0, b1):
        x = b0 + (b1 - b0) * (1.0 - torch.rand((R, C), generator=g,
                                               device="cuda",
                                               dtype=torch.float64))
        neg = torch.rand((R, C), generator=g, device="cuda") < 0.5
        return torch.where(neg, -x, x) * scale
    parts = [band(b0, b1) for b0, b1 in ERF_BANDS.values()]
    idx = torch.arange(R * C, device="cuda").reshape(R, C)
    mixed = torch.where(idx % 3 == 0, parts[0],
                        torch.where(idx % 3 == 1, parts[1], parts[2]))
    spec = torch.tensor([0.0, -0.0, math.inf, -math.inf, math.nan],
                        device="cuda", dtype=torch.float64)
    mixed = torch.where(idx % 97 == 0, spec[(idx // 97) % 5], mixed)
    hi, lo = ff_limbs(torch, mixed)
    cases = [("bands interleaved", (hi, lo))]
    cases += [(f"{name} band alone", ff_limbs(torch, x))
              for name, x in zip(ERF_BANDS, parts)]
    cases += [("ragged strided (517, 8191)", (hi[:517, :8191],
                                              lo[:517, :8191])),
              ("ragged (3, 130)", (hi[:3, :130].contiguous(),
                                   lo[:3, :130].contiguous())),
              ("row lo plane", (hi, lo[:1])),
              ("column hi plane", (hi[:, :1], lo))]
    return cases


def math_oracle(torch, op, x):
    """float64 ``op`` on the card."""
    if op == "sigmoid":
        return 1.0 / (1.0 + torch.exp(-x))
    if op == "gelu":
        return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))
    if op == "silu":
        return x / (1.0 + torch.exp(-x))
    return getattr(torch, op)(x)


def phase_ops_checks(torch):
    """Each new kernel against its plain version on the card, bit for bit,
    and within its NUMERICS.md contract of a float64 oracle on the card:
    ``elementwise`` (six ops; scalar, row, column and full operands) at
    EW_SHAPES, then on each of its paths and the edge classes,
    ``ff_rowsum`` at ROWSUM_SHAPES, ``math_elementwise`` (ten
    functions) on inputs that cover each branch and at (512, 8192), erf
    and gelu also on band_schedule_inputs; then int_division_check.
    Returns the largest kernel-vs-plain differences (0: bit for bit)."""
    from repro_torch.kernels import ff_elementwise as ew
    from repro_torch.kernels import ff_math as fm
    from repro_torch.kernels import ff_reduce as fr
    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    worst = {"ff_elementwise": 0.0, "ff_rowsum": 0.0, "ff_math": 0.0}

    def rn(*shape, sc=1.0):
        return torch.randn(shape, generator=g, device="cuda") * sc

    def check(name, what, got, want):
        for a, b in zip(got, want):
            if not same_nan(a, b):
                raise AssertionError(f"{name} {what}: kernel != plain")
            fin = torch.isfinite(a)
            if fin.any():
                worst[name] = max(worst[name],
                                  float((a[fin] - b[fin]).abs().max()))

    def ff64(h, lo):
        return h.double() + lo.double()

    # elementwise: bitwise, then each op's contract
    for R, C in EW_SHAPES:
        ah, bh = rn(R, C), rn(R, C).abs() + 0.5
        al, bl = ah * 1e-8 * rn(R, C), bh * 1e-8 * rn(R, C)
        forms = {"full": (bh, bl), "row": (bh[:1], bl[:1]),
                 "column": (bh[:, :1], bl[:, :1]),
                 "scalar": (bh[0, 0], bl[0, 0])}
        errs = {}
        for op in ew.EW_OPS:
            for form, (xh, xl) in forms.items():
                if op == "sqrt22" and form != "full":
                    continue
                args = {"sqrt22": (xh, xl), "two_sum": (ah, xh),
                        "two_prod": (ah, xh)}.get(op, (ah, al, xh, xl))
                got = ew.elementwise(op, *args)
                check("ff_elementwise", f"{op} {form} {(R, C)}", got,
                      ew.elementwise_plain(op, *args))
                a64, b64 = ff64(ah, al), ff64(xh, xl)
                g64 = ff64(*got)
                if op == "add22":
                    # the sloppy Add22 has no relative bound under
                    # cancellation: held to 2^-44 where the signs agree
                    ex = a64 + b64
                    same = (ah > 0) == (xh > 0)
                    rel = ((g64 - ex).abs() / ex.abs().clamp_min(
                        1e-300))[same]
                    e = float(rel.max())
                    ok = e <= 2.0 ** -44
                    txt = (f"2^{math.log2(max(e, 1e-300)):.1f} where the "
                           f"signs agree (bound 2^-44)")
                elif op in ("two_sum", "two_prod"):    # exact
                    ex = (ah.double() + xh.double() if op == "two_sum"
                          else ah.double() * xh.double())
                    e = float((g64 - ex).abs().max())
                    ok, txt = e == 0.0, f"{e} (exact)"
                else:
                    ex, bound = {"mul22": (a64 * b64, 2.0 ** -44),
                                 "div22": (a64 / b64, 2.0 ** -43),
                                 "sqrt22": (b64.sqrt(), 2.0 ** -44)}[op]
                    e = float(((g64 - ex).abs()
                               / ex.abs().clamp_min(1e-300)).max())
                    ok = e <= bound
                    txt = (f"2^{math.log2(max(e, 1e-300)):.1f} (bound "
                           f"2^{math.log2(bound):.0f})")
                if not ok:
                    raise AssertionError(f"elementwise {op} {form} "
                                         f"{(R, C)} outside its float64 "
                                         f"bound: {txt}")
                errs.setdefault(op, txt)
        log(f"elementwise {(R, C)}: kernel == plain bit for bit (6 ops x "
            f"full/row/column/scalar); vs float64 (full operands): "
            + "; ".join(f"{k} {v}" for k, v in errs.items()))
        del ah, bh, al, bl

    # the paths elementwise_plan picks, each held bit for bit to the plain
    # version: aligned dense planes (16-byte accesses) at lengths off the
    # 4-wide packs, each operand 1-3 floats off a 16-byte boundary (the
    # 4-byte flat loop), a scalar beside full planes, a (1, C) and a
    # transposed operand (the strided loop), and elementwise_edges' classes
    from repro_torch.benchmarks import stream_variants as sv
    paths = {}

    def run(what, op, args, want):
        got = ew.elementwise(op, *args)
        path = ew.elementwise.last_path
        check("ff_elementwise", f"{op} {what}", got,
              ew.elementwise_plain(op, *args))
        if path != want:
            raise AssertionError(f"elementwise {op} {what}: the {path} "
                                 f"path, not the {want} one")
        paths[path] = paths.get(path, 0) + 1

    (ah, al), (bh, bl) = sv.ff_pair((37, 67), g), sv.ff_pair((37, 67), g,
                                                             True)
    edges = sv.elementwise_edges("cuda", SEED)
    for op in ew.EW_OPS:
        a = sv.ew_args(op, ah, al, bh, bl)
        run("(37, 67)", op, a, "vector")
        for n in (1, 2, 3, 5, 7, 66, 67, 2477):
            run(f"(1, {n})", op, tuple(x.reshape(-1)[:n] for x in a),
                "vector")
        for off in (1, 2, 3):
            for k in range(len(a)):
                run(f"operand {k} {off} floats off", op, a[:k] + (
                    sv.offset_view(a[k], off),) + a[k + 1:], "flat")
        run("a scalar operand", op, (a[0], a[1][0, 0]) + a[2:], "vector")
        run("a (1, C) operand beside full ones", op,
            (a[0], a[1][:1]) + a[2:], "strided")
        run("a transposed operand", op, (a[0].T.contiguous().T,) + a[1:],
            "strided")
        for what, p in edges.items():
            run(what, op, sv.ew_args(op, *p), "vector")
    log(f"elementwise paths: kernel == plain bit for bit (6 ops; lengths "
        f"1-67 and 2477, operands 1-3 floats off, scalar, (1, C), "
        f"transposed; edge classes {', '.join(edges)}); launches by path "
        f"{paths}")
    del ah, bh, al, bl, edges

    # the row sum: bitwise, then within 2^-44 of sum |x|
    for R, C in ROWSUM_SHAPES:
        x = rn(R, C) * 10.0 ** (torch.rand((R, C), generator=g,
                                           device="cuda") * 6 - 3)
        got = fr.ff_rowsum(x)
        check("ff_rowsum", f"{(R, C)}", got, fr.ff_rowsum_plain(x))
        ex = x.double().sum(-1)
        mag = x.double().abs().sum(-1)
        e = float(((ff64(*got) - ex).abs() / mag).max())
        if not e <= 2.0 ** -44:
            raise AssertionError(f"ff_rowsum {(R, C)}: 2^{math.log2(e)} "
                                 f"of sum |x| from float64")
        log(f"ff_rowsum {(R, C)} (lanes {fr.lanes_for(C)}): kernel == "
            f"plain bit for bit; vs float64 2^{math.log2(max(e, 1e-300)):.1f}"
            f" of sum |x|")
        del x

    # ff.math: bitwise on each branch and at (512, 8192), then the contract
    for op in fm.MATH_OPS:
        args = math_branch_inputs(torch, op, g)
        check("ff_math", f"{op} branches", fm.math_elementwise(op, *args),
              fm.math_elementwise_plain(op, *args))
        h = rn(*MATH_BIG)
        big = ((h.abs(), h * 1e-8, h, h * 1e-8) if op == "pow" else
               (h.abs() + 1e-3 if op in ("log", "log1p") else h, h * 1e-8))
        check("ff_math", f"{op} {MATH_BIG}", fm.math_elementwise(op, *big),
              fm.math_elementwise_plain(op, *big))
        if op == "pow":
            a = torch.exp(torch.rand(65536, generator=g, device="cuda",
                                     dtype=torch.float64) * 6 - 3)
            b = torch.rand(65536, generator=g, device="cuda",
                           dtype=torch.float64) * 16 - 8
            (ah, al), (bh, bl) = ff_limbs(torch, a), ff_limbs(torch, b)
            got = ff64(*fm.math_elementwise("pow", ah, al, bh, bl))
            a64, b64 = ff64(ah, al), ff64(bh, bl)
            ex = torch.pow(a64, b64)
            rel = (got - ex).abs() / ex.abs()
            e = float((rel / (1.0 + (b64 * a64.log()).abs())).max())
            bound = 2.0 ** -42
        else:
            (lo_, hi_), bound = MATH_CONTRACT[op]
            x = torch.rand(65536, generator=g, device="cuda",
                           dtype=torch.float64) * (hi_ - lo_) + lo_
            xh, xl = ff_limbs(torch, x)
            x64 = ff64(xh, xl)
            ex = math_oracle(torch, op, x64)
            got = ff64(*fm.math_elementwise(op, xh, xl))
            e = float(((got - ex).abs() / ex.abs().clamp_min(1e-300)).max())
        if not e <= bound:
            raise AssertionError(f"ff_math {op}: 2^{math.log2(e):.1f} from "
                                 f"float64 > 2^{math.log2(bound):.0f}")
        log(f"ff_math {op}: kernel == plain bit for bit ({args[0].numel()} "
            f"branch inputs, {MATH_BIG}); vs float64 2^"
            f"{math.log2(max(e, 1e-300)):.1f} (contract 2^"
            f"{math.log2(bound):.0f}{' x (1 + |b ln a|)' if op == 'pow' else ''})")
    # erf and gelu: the band-sorted schedule, then the exact division
    for op in ("erf", "gelu"):
        for what, args in band_schedule_inputs(torch, op, g):
            check("ff_math", f"{op} {what}", fm.math_elementwise(op, *args),
                  fm.math_elementwise_plain(op, *args))
        log(f"ff_math {op}: kernel == plain bit for bit on the band-sorted "
            f"schedule's cases (bands interleaved with +-0/+-inf/nan, each "
            f"band alone, ragged edges, row and column planes)")
    # tanh: only the branch an element takes runs, the plain version
    # evaluates both and selects; the band edges and mixed bands
    from repro_torch.benchmarks.math_variants import tanh_edges
    edges = tanh_edges("cuda")
    x = torch.rand((512, 8192), generator=g, device="cuda") * 2 - 1
    mixed = (x, x * 1e-8 * torch.randn(x.shape, generator=g, device="cuda"))
    for what, args in (("band edges", edges), ("uniform (-1, 1)", mixed)):
        check("ff_math", f"tanh {what}", fm.math_elementwise("tanh", *args),
              fm.math_elementwise_plain("tanh", *args))
    log(f"ff_math tanh: kernel == plain bit for bit at the band edges "
        f"({edges[0].numel()} inputs: 0.35 and 2^-45 with their neighbours, "
        f"17-20, both signs, lo 0/-0/+-hi 2^-25, +-0, +-inf, nan) and on x "
        f"uniform in (-1, 1) at (512, 8192)")
    # sigmoid and silu: the FMA path's edge classes one by one, the flat
    # loop (contiguous planes) and for_each_element (a strided view, a row
    # and a column plane) at MATH_BIG
    from repro_torch.benchmarks.math_variants import sigmoid_edges
    t0 = time.perf_counter()
    edges = sigmoid_edges("cuda", seed=SEED + 1)
    x = torch.rand(MATH_BIG, generator=g, device="cuda") * 60 - 30
    xl = x * 1e-8 * torch.randn(x.shape, generator=g, device="cuda")
    layouts = {"contiguous": (x, xl), "strided view": (x[:, 1::3],
                                                      xl[:, 1::3]),
               "row lo plane": (x, xl[:1]), "column hi plane": (x[:, :1], xl)}
    for op in ("sigmoid", "silu"):
        for what, args in list(edges.items()) + list(layouts.items()):
            check("ff_math", f"{op} {what}", fm.math_elementwise(op, *args),
                  fm.math_elementwise_plain(op, *args))
    log(f"ff_math sigmoid, silu: kernel == plain bit for bit on the FMA "
        f"path's edge classes ("
        + ", ".join(f"{k} {v[0].numel()}" for k, v in edges.items())
        + f") and, x uniform in (-30, 30), {MATH_BIG} contiguous, a strided "
        f"view, a row lo plane and a column hi plane "
        f"({time.perf_counter() - t0:.1f} s)")
    # pow, log1p, expm1, log and exp the same: their edge classes one by
    # one (for expm1, log and exp with the elements each sends to the Dekker
    # body counted by the card's own test, held to its host emulation), then
    # the layouts at MATH_BIG (pow: a ~ |N(0,1)| + 0.5, b ~ N(0,1), also a
    # broadcast b; log1p: x uniform in (-0.29, 4), near and far branches
    # interleaved; expm1: x uniform in (-1, 1), both branches; log: x =
    # exp(U(-50, 50)); exp: x uniform in (-20, 20))
    from repro_torch.benchmarks.math_variants import (
        dekker_elements, exp_log_edges, log_pow_edges)
    t0 = time.perf_counter()
    lp = {**log_pow_edges("cuda", seed=SEED + 1),
          **exp_log_edges("cuda", seed=SEED + 1)}
    ah = rn(*MATH_BIG).abs() + 0.5
    bh = rn(*MATH_BIG)
    a, b = (ah, ah * 1e-8 * rn(*MATH_BIG)), (bh, bh * 1e-8 * rn(*MATH_BIG))

    def unary(x):
        x = (x, x * 1e-8 * torch.randn(x.shape, generator=g, device="cuda"))
        return {"contiguous": x, "strided view": tuple(p[:, 1::3] for p in x),
                "row lo plane": (x[0], x[1][:1]),
                "column hi plane": (x[0][:, :1], x[1])}
    u = torch.rand(MATH_BIG, generator=g, device="cuda", dtype=torch.float64)
    layouts = {"pow": {"contiguous": a + b,
                       "strided view": tuple(p[:, 1::3] for p in a + b),
                       "row lo plane": (a[0], a[1][:1]) + b,
                       "column hi plane": (a[0][:, :1], a[1]) + b,
                       "column b": a + (b[0][:, :1], b[1][:, :1]),
                       "scalar b": a + (b[0][0, 0], b[1][0, 0])},
               "log1p": unary((4.29 * u - 0.29).float()),
               "expm1": unary((2.0 * u - 1.0).float()),
               "log": unary(torch.exp(100.0 * u - 50.0).float()),
               "exp": unary((40.0 * u - 20.0).float())}
    for op in ("pow", "log1p", "expm1", "log", "exp"):
        for what, args in list(lp[op].items()) + list(layouts[op].items()):
            check("ff_math", f"{op} {what}", fm.math_elementwise(op, *args),
                  fm.math_elementwise_plain(op, *args))
        far = {}
        for k, v in (lp[op].items() if op in ("expm1", "log", "exp")
                     else ()):
            mask = dekker_mask(torch, op, *v).cpu()
            host = dekker_elements(op, *(p.cpu() for p in v))
            if not torch.equal(mask, host):
                raise AssertionError(
                    f"ff_math {op} {k}: the card's element test differs "
                    f"from its host emulation on "
                    f"{int((mask != host).sum())} elements")
            far[k] = int(mask.sum())
        if far and not any(far.values()):
            raise AssertionError(f"ff_math {op}: no edge class reaches the "
                                 f"Dekker body")
        log(f"ff_math {op}: kernel == plain bit for bit on the FMA path's "
            f"edge classes (elements"
            f"{'/to the Dekker body, by the card test' if far else ''}: "
            + ", ".join(f"{k} {v[0].numel()}"
                        + (f"/{far[k]}" if far else "")
                        for k, v in lp[op].items())
            + f") and at {MATH_BIG}: " + ", ".join(layouts[op]))
    log(f"ff_math pow, log1p, expm1, log, exp: edge classes and layouts "
        f"{time.perf_counter() - t0:.1f} s")
    int_division_check(torch)
    torch.cuda.synchronize()
    return worst


def int_division_check(torch):
    """ff_eft.cuh's exact division by the erf series' integers against
    IEEE division on the card: div_int against __fdiv_rn and div22_int
    against div22, for every f32 bit pattern as the dividend (hi; lo +-0
    or a few ulps of hi) and each of the 68 divisors, each both as an
    immediate and read at run time.  Both counts 0."""
    import ctypes
    from repro_torch.kernels import build
    fn = build.entry("ff_math", "ff_math_div_check",
                     [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
    bad = torch.zeros(2, dtype=torch.int64, device="cuda")
    divisors = torch.tensor(ERF_DIVISORS, dtype=torch.int32, device="cuda")
    t0 = time.perf_counter()
    err = fn(bad.data_ptr(), divisors.data_ptr(),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"ff_math_div_check: CUDA error {err}")
    torch.cuda.synchronize()
    n_div, n_div22 = bad.tolist()
    log(f"exact integer division: {n_div} div_int != __fdiv_rn and "
        f"{n_div22} div22_int != div22 mismatches over 2^32 dividends x 68 "
        f"divisors ({time.perf_counter() - t0:.1f} s)")
    if n_div or n_div22:
        raise AssertionError("the exact integer division differs from "
                             "IEEE division")


def dekker_mask(torch, op, xh, xl):
    """The card's own element test of math_kernel<EXP> / <EXPM1> / <LOG>
    (csrc/ff_math_paths.cu, the functions those instances inline): True
    where the kernel sends the element to the Dekker body (exp22 / expm122
    / log22).  A check kernel: no count, not in the kernels line."""
    import ctypes
    from repro_torch.kernels import build
    fn = build.entry("ff_math_paths", "ff_math_dekker_elements",
                     [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p])
    xh, xl = xh.contiguous(), xl.contiguous()
    if xh.shape != xl.shape or xh.dtype != torch.float32:
        raise ValueError("dekker_mask: two f32 planes of one shape")
    mask = torch.empty(xh.shape, dtype=torch.uint8, device="cuda")
    err = fn({"exp": 0, "expm1": 1, "log": 2}[op], mask.data_ptr(),
             xh.data_ptr(),
             xl.data_ptr(), xh.numel(),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"ff_math_dekker_elements: CUDA error {err}")
    return mask.bool()


def tune_operands(torch, op, shape, g):
    """One call's operands at ``shape``, as the tuner builds them."""
    from repro_torch.core.ff import FF

    def pair(positive):
        h = torch.randn(shape, generator=g, device="cuda")
        if positive:
            h = h.abs() + 0.5
        return FF(h, h * 1e-8 * torch.randn(shape, generator=g,
                                            device="cuda"))
    if op == "sum":
        return (torch.randn(shape, generator=g, device="cuda"),), {
            "axis": -1}
    if op in ("add", "mul"):
        return (pair(False), pair(False)), {}
    if op in ("div", "pow"):
        return (pair(True), pair(op == "div")), {}
    return (pair(True),), {}


def phase_tune(torch):
    """``ff.tune`` on the card for TUNE_OPS at TUNE_SHAPES into a temporary
    sidecar, with the launch counts read around it; then one call of each
    op at DEFAULT_SHAPE with no ``impl=``, which resolves ``tuned_default``
    and launches the winner's kernel (if it has one) once; then the table
    cleared and the environment restored, so that the later phases resolve
    and launch as before.  Returns the two paths' launch counts and the
    table."""
    import os
    import shutil
    import tempfile
    import repro_torch.ff as ff
    from repro_torch.ff import dispatch, tuning
    env_old = os.environ.get(tuning.CACHE_ENV)
    tmp = tempfile.mkdtemp(prefix="tune-", dir=ROOT / "build")
    os.environ[tuning.CACHE_ENV] = os.path.join(tmp, tuning.SIDECAR)
    tuning.clear()
    reset_launch_counts()
    t0 = time.perf_counter()
    table = {}
    for op in TUNE_OPS:
        t1 = time.perf_counter()
        out = ff.tune(op, shapes=TUNE_SHAPES, device="cuda")
        for key in sorted(out["table"], key=lambda k: [int(d) for d in
                                                        k.split("x")]):
            rec = out["table"][key]
            table[(op, key)] = rec
            per = ", ".join(f"{n} {r['us']:.1f}" for n, r in
                            sorted(rec["impls"].items(),
                                   key=lambda kv: kv[1]["us"]))
            log(f"tune {op} {key}: us {per}; fast {rec['fast']['impl']}"
                f"{rec['fast']['opts'] or ''}, accurate "
                f"{rec.get('accurate', {}).get('impl')}")
        log(f"tune {op}: {time.perf_counter() - t1:.1f} s")
    # the matmul impls at granite-3-2b's w_gate shape: the Ozaki kernel's
    # call against f64, Dot2 and the hybrid
    t1 = time.perf_counter()
    out = ff.tune("matmul", shapes=(MM_GRANITE[0],), device="cuda")
    for key, rec in out["table"].items():
        per = ", ".join(f"{n} {r['us']:.1f}" for n, r in
                        sorted(rec["impls"].items(),
                               key=lambda kv: kv[1]["us"]))
        log(f"tune matmul {key}: us {per}; fast {rec['fast']['impl']}, "
            f"accurate {rec.get('accurate', {}).get('impl')} "
            f"({time.perf_counter() - t1:.1f} s)")
    torch.cuda.synchronize()
    tune_launches = launch_counts()
    log(f"tuning run: {time.perf_counter() - t0:.1f} s, launches "
        f"{tune_launches}")
    for k in ("ff_elementwise", "ff_rowsum", "ff_math"):
        if not tune_launches[k]:
            raise AssertionError(f"the tuning run launched no {k}")
    # default calls at a tuned shape
    g = torch.Generator(device="cuda").manual_seed(SEED + 10)
    key = tuning.bucket_key(DEFAULT_SHAPE)
    default_launches = {k: 0 for k in launch_counts()}
    winners = {}
    for op in TUNE_OPS:
        rec = table[(op, key)]["fast"]
        args, kw = tune_operands(torch, op, DEFAULT_SHAPE, g)
        res_key = (op, rec["impl"], "tuned_default", "cuda", key)
        n0, before = dispatch.RESOLUTIONS[res_key], launch_counts()
        out = getattr(ff, op)(*args, **kw)
        torch.cuda.synchronize()
        after = launch_counts()
        got = {k: after[k] - before[k] for k in after}
        for k, v in got.items():
            default_launches[k] += v
        kern = KERNEL_TIER.get(rec["impl"], {}).get(op)
        want = {k: int(k == kern) for k in after}
        if dispatch.RESOLUTIONS[res_key] != n0 + 1 or got != want:
            raise AssertionError(f"default ff.{op} {DEFAULT_SHAPE}: "
                                 f"resolutions {dict(dispatch.RESOLUTIONS)}, "
                                 f"launches {got} != {want}")
        ref = getattr(ff, op)(*args, impl=rec["impl"], **rec["opts"], **kw)
        if not (same_nan(out.hi, ref.hi) and same_nan(out.lo, ref.lo)):
            raise AssertionError(f"default ff.{op} != impl={rec['impl']}")
        winners[op] = (rec["impl"], kern)
    log(f"default calls at {DEFAULT_SHAPE}: each resolved tuned_default "
        f"(op: winner, kernel launched once) " + ", ".join(
            f"{op}: {w} {k or '-'}" for op, (w, k) in winners.items())
        + f"; launches {default_launches}")
    # clear the table, restore the environment: static defaults again
    tuning.clear()
    if env_old is None:
        os.environ.pop(tuning.CACHE_ENV)
    else:
        os.environ[tuning.CACHE_ENV] = env_old
    shutil.rmtree(tmp)
    for op in TUNE_OPS:
        name = dispatch.resolve_name(op, None, "cuda", DEFAULT_SHAPE)
        if name != dispatch.resolve_name(op, device="cuda"):
            raise AssertionError(f"{op} still resolves {name} after clear")
    log("tuning table cleared: every op resolves its static default again")
    return tune_launches, default_launches, table


def phase_ops_timing(torch, clock_hz):
    """Each new kernel, its plain version and a float64 yardstick at
    (4096, 4096) (and the math functions at (512, 8192), the rows at
    (512, 49155)): kernel ms by CUDA-graph replay, the call's ms, the
    bound from this run's inputs."""
    import torch.nn.functional as F
    from repro_torch.kernels import ff_elementwise as ew
    from repro_torch.kernels import ff_math as fm
    from repro_torch.kernels import ff_reduce as fr
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    peak_ops = F32_LANES * clock_hz
    rows = {"ff_elementwise": [], "ff_rowsum": [], "ff_math": []}
    far = []     # (exp / expm1 / log row, elements the card test sends away)

    def pair(shape, positive=True):
        h = torch.randn(shape, generator=g, device="cuda")
        if positive:
            h = h.abs() + 0.5
        return h, h * 1e-8 * torch.randn(shape, generator=g, device="cuda")

    R, C = 4096, 4096
    n = R * C
    (ah, al), (bh, bl) = pair((R, C), False), pair((R, C))
    a64, b64 = ah.double(), bh.double()
    lib = {"add22": lambda: torch.add(a64, b64),
           "mul22": lambda: torch.mul(a64, b64),
           "div22": lambda: torch.div(a64, b64),
           "sqrt22": lambda: torch.sqrt(b64),
           "two_sum": lambda: torch.add(a64, b64),
           "two_prod": lambda: torch.mul(a64, b64)}
    for op in ew.EW_OPS:
        args = {"sqrt22": (bh, bl), "two_sum": (ah, bh),
                "two_prod": (ah, bh)}.get(op, (ah, al, bh, bl))
        rows["ff_elementwise"].append(dict(op=op, shape=[R, C], **time_kernel(
            lambda: ew.elementwise(op, *args),
            lambda: ew.elementwise(op, *args),
            cuda_ms(lambda: ew.elementwise_plain(op, *args), 2), lib[op],
            EW_BYTES[op] * n, EW_OPS_COUNT[op] * n, peak_ops, 20),
            library="float64 " + {"add22": "add", "two_sum": "add",
                                  "mul22": "mul", "two_prod": "mul",
                                  "div22": "div", "sqrt22": "sqrt"}[op],
            path=ew.elementwise.last_path))
    log("elementwise timed calls' paths: " + ", ".join(
        f"{r['op']} {r['shape']} {r['path']}"
        for r in rows["ff_elementwise"]))
    if any(r["path"] != "vector" for r in rows["ff_elementwise"]):
        raise AssertionError("elementwise: a timed call missed the 16-byte "
                             "path")
    del a64, b64, al, bl
    for shape in ((R, C), (512, 49155)):
        x = torch.randn(shape, generator=g, device="cuda")
        r, c = shape
        rows["ff_rowsum"].append(dict(shape=list(shape), **time_kernel(
            lambda: fr.ff_rowsum(x), lambda: fr.ff_rowsum(x),
            cuda_ms(lambda: fr.ff_rowsum_plain(x), 2),
            lambda: torch.sum(x, -1, dtype=torch.float64), 4 * r * c + 8 * r,
            r * c * CASCADE + r * 128 * LANE_FOLD, peak_ops, 20),
            library="torch.sum(x, -1, dtype=float64)"))
        del x
    f64 = {"gelu": lambda t: F.gelu(t), "silu": lambda t: F.silu(t),
           "sigmoid": torch.sigmoid}
    for shape in ((R, C), MATH_BIG):
        (h, lo), (ph, pl) = pair(shape), pair(shape, False)
        x64, p64 = h.double() + lo.double(), ph.double() + pl.double()
        for op in fm.MATH_OPS:
            args = (h, lo, ph, pl) if op == "pow" else (h, lo)
            if op == "pow":
                yard = lambda: torch.pow(x64, p64)          # noqa: E731
            else:
                fn = f64[op] if op in f64 else getattr(torch, op)
                yard = lambda fn=fn: fn(x64)                # noqa: E731
            nbytes = (16 if op == "pow" else 8) * h.numel() + 8 * h.numel()
            iters = 5 if op in ("erf", "gelu") else 10
            rows["ff_math"].append(dict(op=op, shape=list(shape), **time_kernel(
                lambda: fm.math_elementwise(op, *args),
                lambda: fm.math_elementwise(op, *args),
                cuda_ms(lambda: fm.math_elementwise_plain(op, *args), 1),
                yard, nbytes, math_ops(op, h), peak_ops, iters),
                library=f"float64 {op}"))
            if op in ("exp", "expm1", "log"):
                far.append((f"{op} {list(shape)}",
                            int(dekker_mask(torch, op, h, lo).sum())))
        del h, lo, ph, pl, x64, p64
    # band-pure rows: erf's argument (gelu's x / sqrt2) uniform in one band
    for op in ("erf", "gelu"):
        scale = 1.0 if op == "erf" else math.sqrt(2.0)
        f64_fn = f64[op] if op in f64 else getattr(torch, op)
        for band, (b0, b1) in ERF_BANDS.items():
            x = b0 + (b1 - b0) * (1.0 - torch.rand((R, C), generator=g,
                                                   device="cuda",
                                                   dtype=torch.float64))
            h = (x * scale).float()
            lo = h * 1e-8 * torch.randn((R, C), generator=g, device="cuda")
            x64 = h.double() + lo.double()
            rows["ff_math"].append(dict(op=op, band=band, shape=[R, C],
                                        **time_kernel(
                lambda: fm.math_elementwise(op, h, lo),
                lambda: fm.math_elementwise(op, h, lo),
                cuda_ms(lambda: fm.math_elementwise_plain(op, h, lo), 1),
                lambda: f64_fn(x64), 16 * h.numel(), math_ops(op, h),
                peak_ops, 3), library=f"float64 {op}"))
            del x, h, lo, x64
    # tanh on mixed bands (x uniform in (-1, 1): about 35% in the small
    # band) and uniform in each of its series' bands alone; sigmoid and
    # silu on x uniform in (-30, 30) (both signs: z = exp(-|x|) to e^-30);
    # log1p on its near branch (the timed |N(0,1)| + 0.5 takes the far one)
    from repro_torch.benchmarks.math_variants import LOG1P_BAND, TANH_BANDS
    banded = [("tanh", band, b) for band, b in
              {"uniform (-1, 1)": (-1.0, 1.0), **TANH_BANDS}.items()]
    banded += [(op, "uniform (-30, 30)", (-30.0, 30.0))
               for op in ("sigmoid", "silu")]
    banded.append(("log1p", "near (-0.29, 0.41)", LOG1P_BAND))
    # expm1 on its k == 0 branch alone and on both; log on exp(U(-50, 50))
    banded += [("expm1", "k == 0 (-0.34, 0.34)", (-0.34, 0.34)),
               ("expm1", "uniform (-1, 1)", (-1.0, 1.0)),
               ("log", "exp(U(-50, 50))", (-50.0, 50.0))]
    for op, band, (b0, b1) in banded:
        x = b0 + (b1 - b0) * (1.0 - torch.rand((R, C), generator=g,
                                               device="cuda",
                                               dtype=torch.float64))
        h = (torch.exp(x) if op == "log" else x).float()
        lo = h * 1e-8 * torch.randn((R, C), generator=g, device="cuda")
        x64 = h.double() + lo.double()
        yard = f64[op] if op in f64 else getattr(torch, op)
        rows["ff_math"].append(dict(op=op, band=band, shape=[R, C],
                                    **time_kernel(
            lambda: fm.math_elementwise(op, h, lo),
            lambda: fm.math_elementwise(op, h, lo),
            cuda_ms(lambda: fm.math_elementwise_plain(op, h, lo), 1),
            lambda: yard(x64), 16 * h.numel(), math_ops(op, h),
            peak_ops, 10), library=f"float64 {op}"))
        if op in ("exp", "expm1", "log"):
            far.append((f"{op} {band} {[R, C]}",
                        int(dekker_mask(torch, op, h, lo).sum())))
        del x, h, lo, x64
    for name, recs in rows.items():
        for r in recs:
            band = f" band {r['band']}" if "band" in r else ""
            log(f"{name} {r.get('op', '')}{band} {r['shape']}: kernel "
                f"{r['ms']:.4f} ms (call {r['call_ms']:.4f}), plain "
                f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}), {r['library']} {r['library_ms']:.4f} ms")
    # no element of exp's, expm1's or log's timed inputs runs the Dekker
    # body
    log("ff_math exp, expm1, log: elements of the timed inputs that the "
        "card's element test (ff_math_paths.cu) sends to the Dekker body: "
        + ", ".join(f"{what} {n}" for what, n in far))
    if any(n for _what, n in far):
        raise AssertionError("ff_math exp / expm1 / log: timed elements run "
                             "the Dekker body")
    for ops in (("sigmoid", "silu"), ("pow", "log1p"), ("expm1", "log"),
                ("exp",)):
        log(f"ff_math {' / '.join(ops)} (FMA TwoProd): kernel / bound "
            + "; ".join(f"{r['op']}{' ' + r['band'] if 'band' in r else ''} "
                        f"{r['shape']} {r['ms']:.4f} / {r['bound_ms']:.4f} "
                        f"ms = {r['ms'] / r['bound_ms']:.2f}x"
                        for r in rows["ff_math"] if r["op"] in ops))
    return rows


def ops_kernel_entries(launches, worst, rows):
    """The kernels-line entries of the three new kernels; the headline
    numbers are those of the main path's op and shape (Add22 and the row
    sum at (4096, 4096), silu at (512, 8192)), every timed row under
    ``by_shape``."""
    src = {"ff_elementwise": ("ff_elementwise.cu", "ff_elementwise.py:169",
                              ("add22", [4096, 4096])),
           "ff_rowsum": ("ff_rowsum.cu", "ff_reduce.py:75",
                         (None, [4096, 4096])),
           "ff_math": ("ff_math.cu", "ff_math.py:63",
                       ("silu", list(MATH_BIG)))}
    out = []
    for name, (cu, ref, (op, shape)) in src.items():
        head = next(r for r in rows[name]
                    if r.get("op") == op and r["shape"] == shape)
        out.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/csrc/{cu}",
            replaces=f"src/repro/kernels/{ref}",
            **path_counts(launches, name), max_abs_err=worst[name],
            **{k: head[k] for k in ("ms", "call_ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms", "library",
                                    "shape")},
            op=op, by_shape=rows[name]))
    return out


def phase_ops(torch, clock_hz):
    worst = phase_ops_checks(torch)
    gc.collect()
    torch.cuda.empty_cache()
    tune_launches, default_launches, _table = phase_tune(torch)
    gc.collect()
    torch.cuda.empty_cache()
    rows = phase_ops_timing(torch, clock_hz)
    gc.collect()
    torch.cuda.empty_cache()
    return tune_launches, default_launches, worst, rows


# ---------------------------------------------------------------------------
# the guard: guard_flags, the add/sub/mul gradients, guarded serving

GUARD_ENGINE = dict(max_batch=4, page_size=16, max_ctx=128)
GUARD_REQUESTS, GUARD_MAX_NEW = 4, 4
GUARD_OPS = 7            # f32 ops an element: multiply, compare, 3 selects,
                         # 2 adds (the integer bit tests not counted)
GUARD_BYTES = 12         # hi and lo read, the code written


def pool_plane(cfg):
    """The full-width KV pool flattened as the guard probe reads it: (L x
    pages x page_size, KV x hd) at GUARD_ENGINE."""
    pages = GUARD_ENGINE["max_batch"] * -(-GUARD_ENGINE["max_ctx"]
                                          // GUARD_ENGINE["page_size"])
    return (cfg.num_layers * pages * GUARD_ENGINE["page_size"],
            cfg.num_kv_heads * cfg.resolved_head_dim)


# (hi, lo, IEEE code) of the adversarial classes: NaN and Inf in each limb,
# subnormal lo of both signs, signed zeros, the 2^-24 boundary and the next
# float above it, |hi| below 2^-102 (a subnormal bound), hi = 0 beside a
# subnormal lo (6 here, 4 under the reference's XLA:CPU)
TINY = 1e-40
GUARD_CLASSES = (
    (math.nan, 0.0, 1), (0.0, math.nan, 1), (math.inf, 0.0, 1),
    (0.0, -math.inf, 1), (-math.inf, math.nan, 1), (math.nan, TINY, 1),
    (1.0, TINY, 4), (1.0, -TINY, 4), (-2.0, TINY, 4),
    (0.0, 0.0, 0), (0.0, -0.0, 0), (-0.0, -0.0, 0), (5.0, -0.0, 0),
    (3.0, 3.0 * 2.0 ** -24, 0), (3.0, 3.0 * 2.0 ** -24 + 2.0 ** -46, 2),
    (1.0, 2.0 ** -24, 0), (1.0, 2.0 ** -23, 2),
    (2.0 ** -110, 0.0, 0), (2.0 ** -110, 2.0 ** -120, 2),
    (2.0 ** -110, TINY, 6), (0.0, TINY, 6), (0.0, -TINY, 6),
    (0.0, 1e-3, 2), (TINY, 0.0, 0))


def guard_operands(torch, g, shape):
    """(hi, lo) on the card: normal pairs around the 2^-24 surrogate, the
    first lanes overwritten with GUARD_CLASSES (where they fit)."""
    hi = torch.randn(shape, generator=g, device="cuda") * 10.0 ** (
        torch.rand(shape, generator=g, device="cuda") * 6 - 3)
    lo = hi * 2.0 ** -24 * torch.rand(shape, generator=g, device="cuda") * 2
    n = min(len(GUARD_CLASSES), hi.numel())
    cls = torch.tensor([c[:2] for c in GUARD_CLASSES[:n]], device="cuda")
    hi.view(-1)[:n], lo.view(-1)[:n] = cls[:, 0], cls[:, 1]
    return hi, lo


def grad_bits(torch, ff, op, impl, args, w):
    """The gradient limbs of ``(r.hi * w[0] + r.lo * w[1]).sum()`` for
    ``r = ff.<op>(*args, impl=impl)``; each arg an f32 tensor or a (hi,
    lo) pair, fresh leaves each call."""
    from repro_torch.core.ff import FF
    leaves, xs = [], []
    for x in args:
        if isinstance(x, tuple):
            ls = [t.detach().clone().requires_grad_() for t in x]
            xs.append(FF(*ls))
        else:
            ls = [x.detach().clone().requires_grad_()]
            xs.append(ls[0])
        leaves += ls
    r = getattr(ff, op)(*xs, impl=impl)
    (r.hi * w[0] + r.lo * w[1]).sum().backward()
    return [t.grad for t in leaves]


def phase_guard_checks(torch, cfg):
    """``guard_flags`` against its plain version on the card, bit for bit,
    at (3, 130), (4096, 4096) and the full-width pool plane, and against
    the IEEE codes of the adversarial classes; ``guard_probe`` with
    ``impl="pallas"`` and ``"jnp"`` giving the same counts; the ``ff.add``
    / ``sub`` / ``mul`` gradients of the kernel tier (``impl="pallas"``,
    one ``ff_elementwise`` launch a forward) bit for bit the plain tier's
    for FF and f32 operands, full and broadcast, with the fault table's
    2 and 2 b rows; ``ff.fused`` raising on a gradient-requiring operand.
    Returns the largest kernel-vs-plain difference (0: bit for bit)."""
    import repro_torch.ff as ff
    from repro_torch.kernels import ff_elementwise as ew
    from repro_torch.kernels import ff_guard as fg
    g = torch.Generator(device="cuda").manual_seed(SEED + 13)
    want_cls = torch.tensor([float(c[2]) for c in GUARD_CLASSES],
                            device="cuda")
    for shape in ((3, 130), (4096, 4096), pool_plane(cfg)):
        hi, lo = guard_operands(torch, g, shape)
        got = fg.guard_flags(hi, lo)
        want = fg.guard_flags_plain(hi, lo)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"guard_flags {shape}: kernel != plain")
        if not torch.equal(got.view(-1)[:len(GUARD_CLASSES)], want_cls):
            raise AssertionError(f"guard_flags {shape}: adversarial codes "
                                 f"{got.view(-1)[:len(GUARD_CLASSES)]}")
        counts = {impl: [int(c) for c in ff.guard_probe(hi, lo, impl=impl)]
                  for impl in ("pallas", "jnp")}
        if counts["pallas"] != counts["jnp"]:
            raise AssertionError(f"guard_probe {shape}: {counts}")
        log(f"guard_flags {shape}: kernel == plain bit for bit, the "
            f"{len(GUARD_CLASSES)} adversarial codes as IEEE gives them; "
            f"guard_probe pallas == jnp {counts['jnp']}")
        del hi, lo, got, want

    R, C = 512, 2048
    ah, bh = torch.randn((R, C), generator=g, device="cuda"), torch.randn(
        (R, C), generator=g, device="cuda")
    a = (ah, ah * 2.0 ** -25 * torch.rand((R, C), generator=g,
                                          device="cuda"))
    b = (bh, bh * 2.0 ** -25 * torch.rand((R, C), generator=g,
                                          device="cuda"))
    w = [torch.randn((R, C), generator=g, device="cuda") for _ in range(2)]
    n_cases = 0
    for op in ("add", "sub", "mul"):
        for x, y in ((a, b), (a, bh), (ah, b), (a, (b[0][0], b[1][0])),
                     (ah[:, :1], b)):
            grads = {}
            for impl in ("jnp", "pallas"):
                n0 = ew.elementwise.launches
                grads[impl] = grad_bits(torch, ff, op, impl, (x, y), w)
                n = ew.elementwise.launches - n0
                if n != (impl == "pallas"):
                    raise AssertionError(f"{op} grad ({impl}): {n} "
                                         f"elementwise launches")
            torch.cuda.synchronize()
            for p, q in zip(grads["pallas"], grads["jnp"]):
                if not (p.shape == q.shape and same_nan(p, q)):
                    raise AssertionError(f"{op} grad: kernel tier != plain "
                                         f"tier")
            n_cases += 1
    for op, want in (("add", lambda bb: torch.full_like(bb, 2.0)),
                     ("mul", lambda bb: 2.0 * bb)):
        for impl in ("jnp", "pallas"):
            ones = [torch.ones_like(ah), torch.ones_like(ah)]
            d_hi, d_lo, _ = grad_bits(torch, ff, op, impl, (a, bh), ones)
            if not (torch.equal(d_hi, want(bh)) and not d_lo.any()):
                raise AssertionError(f"{op} ({impl}): d/d a = ({d_hi}, "
                                     f"{d_lo}), want (2{'b' * (op == 'mul')},"
                                     f" 0)")
    axpy = ff.fused(lambda s, x, y: s * x + y)
    try:
        axpy(1.5, ah, bh.detach().clone().requires_grad_())
    except NotImplementedError:
        pass
    else:
        raise AssertionError("ff.fused ran on a gradient-requiring operand")
    log(f"add/sub/mul gradients: kernel tier == plain tier bit for bit in "
        f"{n_cases} cases (FF and f32 operands, full and broadcast, "
        f"{(R, C)}), d/d a = (2, 0) and (2 b, 0); ff.fused raises on a "
        f"gradient-requiring CUDA operand")
    del a, b, ah, bh, w
    torch.cuda.synchronize()
    return 0.0


# the FF functions a kernel-tier backward runs through the ff_math kernel
# (autodiff.MATH_BWD; the rest of each rule is plain FF products): sigmoid22
# for silu, exp22 for erf, erf22 and exp22 for gelu, log22 for pow
MATH_BWD_LAUNCHES = {"silu": 1, "erf": 1, "gelu": 2, "pow": 1}
# the f64 attention tier's shapes (B, S): the prefill and the training step
F64_ATTENTION_SHAPES = ((1, 64), (4, 128))


def grads_equal(torch, name, got, want):
    torch.cuda.synchronize()
    for i, (p, q) in enumerate(zip(got, want)):
        if not (p.shape == q.shape and same_nan(p, q)):
            raise AssertionError(f"{name}: kernel tier != plain tier in "
                                 f"gradient plane {i}")


def phase_grad_checks(torch, cfg):
    """The gradients of the ops whose backward the port gained, kernel tier
    against plain tier on the card, bit for bit: ``div``, ``sqrt``,
    ``two_sum``, ``two_prod`` (``impl="pallas"``: one ``ff_elementwise``
    launch a forward, the backward's Div22 / Mul22 / Mul212 plain) against
    ``impl="jnp"``, FF and f32 operands, full and broadcast; ``softmax``
    (accurate) and ``norm_stats`` through their kernels against the same
    Function over the kernels' plain versions (the fast softmax, whose
    forward is within 1 ulp of its plain version, within 4 ulps of
    max |g| |y| a row); the ten ``ff.math`` functions on
    ``math_branch_inputs``, FF and f32 operands: ``impl="pallas"`` (the
    forward and the backward's FF functions through the ``ff_math``
    kernel, its launches counted) against ``impl="jnp"``.  Then the
    ``f64`` attention tier at granite-3-2b's heads within 2^-40 of a
    float64 oracle at the prefill's and the training step's shapes, and
    its gradient (the fast recurrence's) finite."""
    import repro_torch.ff as ff
    from repro_torch.benchmarks import attention_variants as av
    from repro_torch.ff import autodiff
    from repro_torch.kernels import ff_elementwise as ew
    from repro_torch.kernels import ff_fused
    from repro_torch.kernels import ff_math as km
    g = torch.Generator(device="cuda").manual_seed(SEED + 17)
    R, C = 512, 2048

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    ah, bh = randn(R, C), randn(R, C)
    a = (ah, ah * 2.0 ** -25 * torch.rand((R, C), generator=g,
                                          device="cuda"))
    b = (bh, bh * 2.0 ** -25 * torch.rand((R, C), generator=g,
                                          device="cuda"))
    w = [randn(R, C), randn(R, C)]
    forms = {"div": ((a, b), (a, bh), (ah, b), (a, (b[0][0], b[1][0])),
                     (ah[:, :1], b)),
             "sqrt": (((a[0].abs(), a[1].abs()),), (ah.abs(),)),
             "two_sum": ((ah, bh), (ah, bh[0]), (ah[:, :1], bh)),
             "two_prod": ((ah, bh), (ah, bh[0]), (ah[:, :1], bh))}
    n_cases = 0
    for op, cases in forms.items():
        for args in cases:
            grads = {}
            for impl in ("jnp", "pallas"):
                n0 = ew.elementwise.launches
                grads[impl] = grad_bits(torch, ff, op, impl, args, w)
                if ew.elementwise.launches - n0 != (impl == "pallas"):
                    raise AssertionError(f"{op} grad ({impl}): "
                                         f"{ew.elementwise.launches - n0} "
                                         f"elementwise launches")
            grads_equal(torch, f"{op} grad", grads["pallas"], grads["jnp"])
            n_cases += 1
    log(f"div/sqrt/two_sum/two_prod gradients: kernel tier == plain tier "
        f"bit for bit in {n_cases} cases (FF and f32 operands, full and "
        f"broadcast, {(R, C)})")
    del a, b, ah, bh

    x = randn(R, C) * 3.0
    wx = randn(R, C)
    line = []
    for impl, accurate in (("ff", True), ("pallas", False)):
        n0 = ff_fused.ff_softmax.launches
        xk = x.clone().requires_grad_()
        y = ff.softmax(xk, impl=impl)
        (y * wx).sum().backward()
        if ff_fused.ff_softmax.launches - n0 != 1:
            raise AssertionError(f"softmax grad ({impl}): not one launch")
        xp = x.clone().requires_grad_()
        yp = autodiff.Softmax.apply(
            xp, lambda t, axis, acc=accurate: ff_fused.ff_softmax_plain(
                t, "softmax", acc), -1)
        (yp * wx).sum().backward()
        y, yp = y.detach(), yp.detach()
        torch.cuda.synchronize()
        if accurate:
            grads_equal(torch, "softmax (accurate) grad", [xk.grad],
                        [xp.grad])
            line.append("accurate bit for bit")
        else:
            scale = (wx.abs() * yp).amax(-1, keepdim=True) \
                + wx.abs().amax(-1, keepdim=True) * yp
            d = (xk.grad - xp.grad).abs()
            u = float((d / (scale * 2.0 ** -24)).max())
            if not u <= 4:
                raise AssertionError(f"softmax (fast) grad: {u:.2f} ulps of "
                                     f"max |g| |y| from the plain version's")
            line.append(f"fast {u:.2f} ulps of max |g| |y| "
                        f"({'bit for bit' if not d.any() else 'not bitwise'};"
                        f" forward {ulp_diff(y, yp)} ulp)")
    xn = randn(R, C) * 2.0 + 1.0
    wm, wv = randn(R), randn(R)
    n0 = ff_fused.ff_norm_stats.launches
    xk = xn.clone().requires_grad_()
    mu, var = ff.norm_stats(xk, impl="pallas")
    (mu * wm + var * wv).sum().backward()
    xp = xn.clone().requires_grad_()
    mu, var = autodiff.NormStats.apply(xp, ff_fused.ff_norm_stats_plain)
    (mu * wm + var * wv).sum().backward()
    if ff_fused.ff_norm_stats.launches - n0 != 1:
        raise AssertionError("norm_stats grad: not one launch")
    grads_equal(torch, "norm_stats grad", [xk.grad], [xp.grad])
    log(f"softmax gradient, kernel vs plain version {(R, C)}: "
        f"{'; '.join(line)}; norm_stats gradient bit for bit")
    del x, wx, xn, xk, xp

    counts = {}
    for op in km.MATH_OPS:
        planes = math_branch_inputs(torch, op, g)
        wm = [torch.randn(planes[0].shape, generator=g, device="cuda")
              for _ in range(2)]
        forms = ([(planes[0], planes[1]), (planes[2], planes[3])],
                 [planes[0], planes[2]]) if op == "pow" else \
            ([(planes[0], planes[1])], [planes[0]])
        for args in forms:
            grads = {}
            for impl in ("jnp", "pallas"):
                n0 = km.math_elementwise.launches
                grads[impl] = grad_bits(torch, ff, op, impl, args, wm)
                n = km.math_elementwise.launches - n0
                want = (1 + MATH_BWD_LAUNCHES.get(op, 0)) \
                    if impl == "pallas" else 0
                if n != want:
                    raise AssertionError(f"{op} grad ({impl}): {n} ff_math "
                                         f"launches, want {want}")
            grads_equal(torch, f"{op} grad", grads["pallas"], grads["jnp"])
        counts[op] = planes[0].numel()
    log(f"ff.math gradients: kernel tier == plain tier bit for bit, FF and "
        f"f32 operands, on the branch inputs (elements {counts}); "
        f"ff_math launches a forward and backward: 1 + {MATH_BWD_LAUNCHES}")

    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    errs = []
    for B, S in F64_ATTENTION_SHAPES:
        q = randn(B, S, H, hd).bfloat16()
        k, v = randn(B, S, KV, hd).bfloat16(), randn(B, S, KV, hd).bfloat16()
        got = ff.attention(q, k, v, impl="f64", return_ff=True)
        e = av.rel_err(av.ff64(got), av.oracle(q, k, v, causal=True))
        errs.append(e)
        if not e <= 2.0 ** -40:
            raise AssertionError(f"f64 attention {(B, S)}: {e:.3e} > 2^-40 "
                                 f"of float64")
        qg = q.clone().requires_grad_()
        ff.attention(qg, k, v, impl="f64").float().sum().backward()
        if not bool(torch.isfinite(qg.grad).all()):
            raise AssertionError(f"f64 attention {(B, S)}: gradient not "
                                 f"finite")
    log(f"f64 attention tier, causal bf16, {H} heads / {KV} KV, hd {hd}: "
        + ", ".join(f"{shape} 2^{math.log2(max(e, 1e-300)):.1f}"
                    for shape, e in zip(F64_ATTENTION_SHAPES, errs))
        + " of float64 (<= 2^-40); gradients finite")
    torch.cuda.synchronize()


def phase_serve_guard(torch, params, cfg):
    """granite-3-2b at full width under ``policy("ff_reduce",
    attention="pallas")``, GUARD_REQUESTS requests: (1) ``guard="check"``,
    healthy: every status OK, the tokens of the same requests under
    ``guard="off"``, every guard count 0, ``probe_kv()`` with the kernel
    (``ff.use(guard_probe="pallas")``) equal to the jnp impl's; (2)
    ``guard="degrade"`` with NaN written into 2 live K/V positions of slot
    0 after one step by the port's injector (``ChaosMonkey(SEED +
    6).corrupt_kv_limbs``): the kernel probe counts exactly 2 non-finite, every
    request ends terminal, slot 0's DEGRADED; each DEGRADED row's tokens
    are ``greedy_generate`` on the card under the engine's fast policy,
    each OK row's those of run (1).  Returns the launch counts of the
    check and degrade runs."""
    import numpy as np
    import repro_torch.ff as ff
    from repro_torch.chaos import ChaosMonkey
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.train.serve_step import greedy_generate
    t0 = time.perf_counter()
    reqs = serve_requests(np.random.default_rng(SEED + 5),
                          cfg.vocab_size)[:GUARD_REQUESTS]

    runs = {}

    def serve(guard, inject=None):
        with ff.policy("ff_reduce", attention="pallas"):
            eng = ServeEngine(params, cfg, guard=guard, **GUARD_ENGINE)
        t = time.perf_counter()
        for r in reqs:
            if eng.submit(Request(uid=r.uid, prompt=r.prompt,
                                  max_new=GUARD_MAX_NEW)) != "QUEUED":
                raise AssertionError(f"guarded serving: {r.uid} not queued")
        if inject is not None:
            eng.step()
            inject(eng)
        res = eng.run()
        torch.cuda.synchronize()
        # host clock: each prefill and decode step ends in a sync; the
        # degrade run's wall includes the poison, its probe and the retries
        runs[guard] = {"wall_s": time.perf_counter() - t,
                       "prefills": len(eng.prefill_s),
                       "decode_steps": eng.decode_steps,
                       "prefill_ms": 1e3 * float(np.mean(eng.prefill_s)),
                       "decode_step_ms": 1e3 * float(np.mean(eng.decode_s))}
        return eng, res

    off = serve("off")[1]
    reset_launch_counts()
    eng, checked = serve("check")
    with ff.use(guard_probe="pallas"):
        probe_k = [int(c) for c in eng.probe_kv()]
    probe_j = [int(c) for c in eng.probe_kv()]
    stats = dict(eng.guard_stats)
    del eng
    for r in reqs:
        a, b = checked[r.uid], off[r.uid]
        if a.status != "OK" or not np.array_equal(a.tokens, b.tokens):
            raise AssertionError(f"guard=check uid {r.uid}: {a.status} "
                                 f"{a.tokens} vs guard=off {b.tokens}")
    if any(stats.values()) or probe_k != probe_j or any(probe_k[:2]):
        raise AssertionError(f"guard=check: stats {stats}, probe_kv "
                             f"kernel {probe_k} jnp {probe_j}")
    log(f"guard=check at full width: {len(reqs)} requests OK, tokens == "
        f"guard=off, guard_stats all 0; probe_kv kernel == jnp {probe_k}")

    seen = {}

    def inject(eng):
        seen["coords"] = ChaosMonkey(SEED + 6).corrupt_kv_limbs(
            eng.kv, 0, kind="nan", n=2)
        with ff.use(guard_probe="pallas"):
            seen["probe"] = [int(c) for c in eng.probe_kv()]

    eng, res = serve("degrade", inject)
    launches = launch_counts()
    stats, fast = dict(eng.guard_stats), eng._fast_policy()
    slot0 = reqs[0].uid
    # the whole-pool probe, host clock (it ends in the counts' sync)
    with ff.use(guard_probe="pallas"):
        probe_ms = {"pallas": host_ms(eng.probe_kv, 3)}
    probe_ms["jnp"] = host_ms(eng.probe_kv, 3)
    del eng
    if seen["probe"][0] != 2:
        raise AssertionError(f"poisoned pool: probe_kv {seen['probe']}")
    statuses = {u: r.status for u, r in res.items()}
    if sorted(res) != sorted(r.uid for r in reqs) or res[slot0].status \
            != "DEGRADED" or not set(statuses.values()) <= {"OK",
                                                             "DEGRADED"}:
        raise AssertionError(f"guard=degrade: statuses {statuses}")
    for r in reqs:
        out = res[r.uid]
        if out.status == "DEGRADED":
            prompt = torch.as_tensor(r.prompt[None], dtype=torch.long,
                                     device="cuda")
            want = greedy_generate(params, cfg, prompt, GUARD_MAX_NEW,
                                   cache_len=len(r.prompt) + GUARD_MAX_NEW,
                                   policy=fast)[0].cpu().numpy()
        else:
            want = checked[r.uid].tokens
        if not np.array_equal(out.tokens, want):
            raise AssertionError(f"guard=degrade uid {r.uid} "
                                 f"({out.status}): {out.tokens} != {want}")
    if stats["quarantined"] < 1 or stats["flagged_rows"] < 1:
        raise AssertionError(f"guard=degrade: guard_stats {stats}")
    if launches["ff_guard"] < 2:
        raise AssertionError(f"guarded serving launched ff_guard "
                             f"{launches['ff_guard']} times")
    wall = time.perf_counter() - t0
    log(f"guarded serving runs: {json.dumps(runs)}; probe_kv host ms per "
        f"call: {json.dumps(probe_ms)}")
    log(f"guard=degrade at full width: NaN at {seen['coords']}, kernel "
        f"probe {seen['probe']}; statuses {statuses}; DEGRADED tokens == "
        f"greedy_generate under the fast policy, OK tokens == guard=check; "
        f"guard_stats {stats}; launches {launches}; phase wall "
        f"{wall:.1f} s")
    return launches


def guard_timing(torch, cfg, counts, err, clock_hz):
    """The guard_flags kernel at (4096, 4096) and at the full-width pool
    plane: kernel ms by CUDA-graph replay, the call's ms, the plain
    version's ms, the bound.  No single PyTorch call computes the flag
    plane, so there is no library time."""
    from repro_torch.kernels import ff_guard as fg
    g = torch.Generator(device="cuda").manual_seed(SEED + 14)
    rows = []
    for shape in ((4096, 4096), pool_plane(cfg)):
        hi, lo = guard_operands(torch, g, shape)
        n = hi.numel()
        rows.append(dict(shape=list(shape), **time_kernel(
            lambda: fg.guard_flags(hi, lo), lambda: fg.guard_flags(hi, lo),
            cuda_ms(lambda: fg.guard_flags_plain(hi, lo), 5), None,
            GUARD_BYTES * n, GUARD_OPS * n, F32_LANES * clock_hz, 50)))
        del hi, lo
    for r in rows:
        log(f"ff_guard {r['shape']}: kernel {r['ms']:.4f} ms (call "
            f"{r['call_ms']:.4f}), plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), library none")
    return dict(name="ff_guard", route="cuda",
                source="src/repro_torch/csrc/ff_guard.cu",
                replaces="src/repro/kernels/ff_guard.py:79", **counts,
                max_abs_err=err, **{k: rows[0][k] for k in (
                    "ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "shape")}, by_shape=rows)


def serve_requests(rng, vocab: int):
    import numpy as np
    from repro_torch.serve import Request
    lens = rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1,
                        size=8)[:FULL_REQUESTS]
    return [Request(uid=i, prompt=rng.integers(1, vocab, size=int(n))
                    .astype(np.int32), max_new=MAX_NEW)
            for i, n in enumerate(lens)]


def to_device(tree, device):
    """A copy of a tree of tensors on ``device``."""
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.to(device, copy=True), tree)


def phase_small_engine(torch):
    """A reduced granite engine (f32 compute) on the card against the same
    engine on the CPU, where every kernel is its plain version."""
    import numpy as np
    import repro_torch.ff as ff
    from repro_torch.chaos import ChaosMonkey
    from repro_torch.configs.granite_3_2b import CONFIG
    from repro_torch.models import init_params
    from repro_torch.serve import Request, ServeEngine
    cfg = CONFIG.reduced(compute_dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in (9, 20, 33)]
    results = {}
    for dev in ("cuda", "cpu"):
        with ff.policy("ff_reduce", attention="pallas"):
            eng = ServeEngine(to_device(params, dev), cfg, device=dev,
                              max_batch=2, page_size=16, max_ctx=64)
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=p, max_new=4))
        results[dev] = eng.run()
    for uid in range(len(prompts)):
        a, b = results["cuda"][uid], results["cpu"][uid]
        if a.status != "OK" or not np.array_equal(a.tokens, b.tokens):
            raise AssertionError(f"reduced engine uid {uid}: card "
                                 f"{a.status} {a.tokens} vs CPU {b.tokens}")
        err = float(np.abs(a.logprobs_ff.sum(1) - b.logprobs_ff.sum(1))
                    .max())
        if not err <= 1e-4:
            raise AssertionError(f"reduced engine uid {uid}: FF score "
                                 f"card vs CPU {err:.2e} > 1e-4")
    log(f"reduced engine (2 layers, f32): card == CPU tokens for "
        f"{len(prompts)} requests")

    # ff_bf16 limb pages, and reserve="prompt" on a pool small enough to
    # preempt (sync_every=3): the same statuses, tokens and preemptions
    for name, kw in (("ff_bf16 pages", dict(kv_mode="ff_bf16")),
                     ("reserve=prompt, 6 pages", dict(
                         reserve="prompt", num_pages=6, sync_every=3))):
        runs = {}
        for dev in ("cuda", "cpu"):
            with ff.policy("ff_reduce", attention="pallas"):
                eng = ServeEngine(to_device(params, dev), cfg, device=dev,
                                  max_batch=3, page_size=16, max_ctx=64,
                                  **kw)
            for i, p in enumerate(prompts):
                eng.submit(Request(uid=i, prompt=p, max_new=12))
            res = eng.run()
            runs[dev] = ({u: (r.status, r.tokens.tolist())
                          for u, r in res.items()},
                         eng.guard_stats["preempted"])
            lo = float(eng.kv.planes["k_lo"].abs().max()) \
                if "k_lo" in eng.kv.planes else None
            if dev == "cuda" and name.startswith("ff_bf16") and not lo:
                raise AssertionError("ff_bf16 pages: the lo planes are 0")
        if runs["cuda"] != runs["cpu"] or any(
                v[0] != "OK" for v in runs["cuda"][0].values()) or (
                "reserve" in kw and runs["cuda"][1] < 1):
            raise AssertionError(f"reduced engine, {name}: card "
                                 f"{runs['cuda']} vs CPU {runs['cpu']}")
        log(f"reduced engine, {name}: card == CPU statuses and tokens, "
            f"{runs['cuda'][1]} preemptions on each"
            + (f"; the card's k_lo plane up to {lo:.3g}" if lo else ""))

    # the serving launcher on the card, with snapshots and the journal
    import tempfile
    from repro_torch.launch import serve as launch_serve
    with tempfile.TemporaryDirectory() as tmp:
        snap = os.path.join(tmp, "snap")
        res = launch_serve.main(["--arch", "granite-3-2b", "--reduced",
                                 "--engine", "--snapshot-dir", snap,
                                 "--snapshot-every", "2", "--max-new", "6"])
        wal = os.path.getsize(os.path.join(snap, "wal.jsonl"))
        back = launch_serve.main(["--arch", "granite-3-2b", "--reduced",
                                  "--engine", "--snapshot-dir", snap,
                                  "--resume", "--max-new", "6"])
    if any(r.status != "OK" for r in res.values()) or wal or {
            u: r.tokens.tolist() for u, r in back.items()} != {
            u: r.tokens.tolist() for u, r in res.items()}:
        raise AssertionError(f"launch.serve --engine --snapshot-dir: "
                             f"{res} / journal {wal} B / resumed {back}")
    log(f"launch.serve --reduced --engine --snapshot-dir on the card: "
        f"{len(res)} requests OK, journal empty, --resume gives the same "
        f"results")

    # guard="degrade" with one block-table flip of slot 1 after one step,
    # the same flip on both devices: the audit quarantines the untrusted
    # rows (DEGRADED, the fast-tier retry) and rebuilds the free list
    for mode in ("oob", "free", "dup"):
        results, stats = {}, {}
        for dev in ("cuda", "cpu"):
            with ff.policy("ff_reduce", attention="pallas"):
                eng = ServeEngine(to_device(params, dev), cfg, device=dev,
                                  max_batch=2, page_size=16, max_ctx=64,
                                  guard="degrade")
            for i, p in enumerate(prompts):
                eng.submit(Request(uid=i, prompt=p, max_new=4))
            eng.step()
            ChaosMonkey(SEED + 7).flip_block_table(eng.kv, 1, mode=mode)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", ff.FFGuardWarning)
                results[dev] = eng.run()
            stats[dev] = dict(eng.guard_stats)
            if eng.kv.check_integrity() != ([], set()) \
                    or stats[dev]["integrity_rebuilds"] < 1:
                raise AssertionError(f"{mode} flip on {dev}: {stats[dev]}, "
                                     f"{eng.kv.check_integrity()}")
        got = {u: (r.status, r.tokens.tolist())
               for u, r in results["cuda"].items()}
        want = {u: (r.status, r.tokens.tolist())
                for u, r in results["cpu"].items()}
        if got != want or "DEGRADED" not in {v[0] for v in got.values()}:
            raise AssertionError(f"{mode} flip: card {got} vs CPU {want}")
        log(f"reduced engine, guard=degrade, {mode} block-table flip: card "
            f"== CPU statuses and tokens {[v[0] for v in got.values()]}; "
            f"guard_stats {stats['cuda']}; metadata clean afterwards")


# the full-width decode step before the obs tier was wired in (PERF.md
# section 5; H100 80GB HBM3, 700.00 W), printed beside this run's
BASELINE_DECODE_STEP_MS = 4022.427208466663


def series_total(counters, name, **labels):
    """The sum of ``name``'s counter series whose labels include
    ``labels``."""
    want = [f'{k}="{v}"' for k, v in labels.items()]
    return sum(n for s, n in counters.items()
               if s.split("{")[0] == name and all(w in s for w in want))


def check_serve_obs(eng, res, reqs, before, launches, n_tok):
    """The full-width run's own metrics and trace (``eng.obs``) and the
    process-global dispatch telemetry (``obs.REGISTRY``'s delta from
    ``before``): every request OK and counted, the tokens counted, the
    decode-step histogram equal to ``decode_s`` (count and sum), the
    ``mean_sq`` resolutions on ``backend="cuda"`` as many as its kernel's
    launches and the ``pallas`` attention resolutions one a layer of each
    forward (a decode step's, with per-row lengths, takes the plain
    version and launches nothing), one ``request`` span per request with a
    documented status, and a Chrome trace that survives a JSON round
    trip with sorted non-negative timestamps."""
    from repro_torch import obs
    from repro_torch.serve import STATUSES
    snap = eng.obs.snapshot()
    c, h = snap["counters"], snap["histograms"]
    dec = h["serve_decode_step_seconds"]
    glob = obs.REGISTRY.delta(before)["counters"]
    res_name = "ff_dispatch_resolutions_total"
    got = {"requests_ok": c.get('serve_requests_total{status="OK"}'),
           "tokens_emitted": c.get("serve_tokens_emitted_total"),
           "decode_hist_count": dec["count"], "decode_hist_sum": dec["sum"],
           "prefill_hist_count": h["serve_prefill_seconds"]["count"],
           "mean_sq_resolutions": series_total(
               glob, res_name, op="mean_sq", impl="fused", backend="cuda"),
           "attention_resolutions": series_total(
               glob, res_name, op="attention", impl="pallas",
               backend="cuda")}
    want = {"requests_ok": len(reqs), "tokens_emitted": n_tok,
            "decode_hist_count": eng.decode_steps,
            "decode_hist_sum": sum(eng.decode_s),
            "prefill_hist_count": len(eng.prefill_s),
            "mean_sq_resolutions": launches["mean_sq"],
            "attention_resolutions": eng.cfg.num_layers * (
                len(eng.prefill_s) + eng.decode_steps)}
    if got != want:
        raise AssertionError(f"serving metrics {got} != {want}")
    payload = json.loads(json.dumps(eng.obs.to_chrome_trace()))
    evs = payload["traceEvents"]
    spans = [e for e in evs if e["ph"] == "X" and e["name"] == "request"]
    ts = [e["ts"] for e in evs if e["ph"] != "M"]
    if sorted(e["args"]["uid"] for e in spans) != sorted(
            r.uid for r in reqs) or any(
            e["args"]["status"] not in STATUSES
            or e["args"]["status"] != res[e["args"]["uid"]].status
            for e in spans) or ts != sorted(ts) or min(ts) < 0 or any(
            e["dur"] < 0 for e in evs if e["ph"] == "X"):
        raise AssertionError(f"serving trace: {len(spans)} request spans, "
                             f"{len(evs)} events")
    resolved = sorted(s for s, n in glob.items()
                      if n and s.startswith(res_name))
    log(f"serving obs: {json.dumps(got)}; {len(spans)} request spans "
        f"(statuses {sorted({e['args']['status'] for e in spans})}), "
        f"{len(evs)} trace events, JSON round trip, timestamps sorted; "
        f"resolution series {resolved}")


def phase_serve(torch, card: str):
    import numpy as np
    import repro_torch.ff as ff
    from repro_torch import obs
    from repro_torch.configs.granite_3_2b import CONFIG as cfg
    from repro_torch.models import init_params
    from repro_torch.serve import ServeEngine
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda")
                         .manual_seed(SEED))
    n_params = param_count(params)
    with ff.policy("ff_reduce", attention="pallas"):
        eng = ServeEngine(params, cfg, max_batch=4, page_size=16,
                          max_ctx=128, obs=obs.Observer())
    torch.cuda.synchronize()
    log(f"granite-3-2b: {n_params / 1e9:.3f} B params (f32) + bf16 copy, "
        f"set up in {time.perf_counter() - t0:.1f} s")
    reqs = serve_requests(np.random.default_rng(SEED), cfg.vocab_size)

    reset_launch_counts()
    before = obs.REGISTRY.snapshot()
    t0 = time.perf_counter()
    for r in reqs:
        if eng.submit(r) != "QUEUED":
            raise AssertionError(f"request {r.uid} not queued")
    res = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()

    n_pf, n_dec = len(eng.prefill_s), eng.decode_steps
    norms = 2 * cfg.num_layers + 1
    want = {**{k: 0 for k in launches}, "mean_sq": norms * (n_pf + n_dec),
            "attention": cfg.num_layers * n_pf}
    log(f"launches: {launches} over {n_pf} prefills and {n_dec} decode "
        f"steps; expected {want}")
    if n_pf != len(reqs) or launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    n_tok = 0
    for r in reqs:
        out = res[r.uid]
        if out.status != "OK" or out.tokens.shape != (MAX_NEW,):
            raise AssertionError(f"uid {r.uid}: {out.status} "
                                 f"{out.tokens.shape} {out.detail}")
        hi, lo = out.logprobs_ff[:, 0], out.logprobs_ff[:, 1]
        if not (np.isfinite(out.logprobs).all() and np.isfinite(hi).all()
                and np.isfinite(lo).all()):
            raise AssertionError(f"uid {r.uid}: non-finite scores")
        if not np.array_equal(hi + lo, hi):       # f32 sum: normalised pair
            raise AssertionError(f"uid {r.uid}: FF scores not normalised")
        gap = np.abs(hi.astype(np.float64) + lo - out.logprobs).max()
        if not gap <= 1e-4:
            raise AssertionError(f"uid {r.uid}: FF vs f32 score {gap:.2e}")
        n_tok += len(out.tokens)
    check_serve_obs(eng, res, reqs, before, launches, n_tok)
    serving = {"requests": len(reqs), "tokens": n_tok,
               "tokens_per_s": n_tok / wall,
               "decode_step_ms": 1e3 * float(np.mean(eng.decode_s)),
               "prefill_ms": 1e3 * float(np.mean(eng.prefill_s)),
               "decode_steps": n_dec, "wall_s": wall, "card": card}
    log(f"serving: {json.dumps(serving)}")
    return launches, cfg, eng


def phase_serve_ff_math(torch, params, cfg):
    """granite-3-2b at full width served under ``policy("ff_reduce",
    attention="pallas", ff_math=True)`` with ``ff.use(silu="pallas")``:
    FF_MATH_REQUESTS requests stepped one scheduler iteration at a time,
    each iteration launching ``ff_math`` once per layer of each forward
    (prefill or decode), ``mean_sq`` and ``attention`` as in the main
    serving run, nothing else; then the same requests with
    ``ff.use(silu="jnp")`` (no ``ff_math`` launch) give the same greedy
    tokens.  Returns the pallas run's launch counts."""
    import numpy as np
    import repro_torch.ff as ff
    from repro_torch.serve import Request, ServeEngine
    reqs = serve_requests(np.random.default_rng(SEED + 3),
                          cfg.vocab_size)[:FF_MATH_REQUESTS]
    with ff.policy("ff_reduce", attention="pallas", ff_math=True):
        eng = ServeEngine(params, cfg, max_batch=4, page_size=16,
                          max_ctx=128)
    L, norms = cfg.num_layers, 2 * cfg.num_layers + 1
    tokens, walls = {}, {}
    for silu, base in (("pallas", 0), ("jnp", 100)):
        for r in reqs:
            eng.submit(Request(uid=base + r.uid, prompt=r.prompt,
                               max_new=FF_MATH_MAX_NEW))
        reset_launch_counts()
        t0 = time.perf_counter()
        more = True
        with ff.use(silu=silu):
            while more:
                n_pf, n_dec, before = (len(eng.prefill_s), eng.decode_steps,
                                       launch_counts())
                more = eng.step()
                torch.cuda.synchronize()
                after = launch_counts()
                fwd = len(eng.prefill_s) - n_pf + eng.decode_steps - n_dec
                got = {k: after[k] - before[k] for k in after}
                want = {**{k: 0 for k in after},
                        "mean_sq": norms * fwd,
                        "attention": L * (len(eng.prefill_s) - n_pf),
                        "ff_math": L * fwd if silu == "pallas" else 0}
                if got != want:
                    raise AssertionError(f"ff_math serving ({silu}) step: "
                                         f"launches {got} != {want}")
        walls[silu] = time.perf_counter() - t0
        if silu == "pallas":
            launches = launch_counts()
        for r in reqs:
            out = eng.results[base + r.uid]
            if out.status != "OK" or out.tokens.shape != (FF_MATH_MAX_NEW,)\
                    or not np.isfinite(out.logprobs_ff).all():
                raise AssertionError(f"ff_math serving uid {r.uid} "
                                     f"({silu}): {out.status}")
            tokens.setdefault(r.uid, []).append(out.tokens)
    for uid, (a, b) in tokens.items():
        if not np.array_equal(a, b):
            raise AssertionError(f"ff_math serving uid {uid}: pallas silu "
                                 f"{a} != jnp silu {b}")
    n_pf, n_dec = len(eng.prefill_s) // 2, eng.decode_steps // 2
    log(f"ff_math serving: {len(reqs)} requests x {FF_MATH_MAX_NEW} tokens, "
        f"{n_pf} prefills and {n_dec} decode steps per run; every step "
        f"launched ff_math {L} times per forward with silu=pallas "
        f"({launches['ff_math']} in all), 0 with silu=jnp; greedy tokens "
        f"equal; wall {walls['pallas']:.2f} s (pallas) vs "
        f"{walls['jnp']:.2f} s (jnp); launches {launches}")
    del eng
    return launches


# the durable serving phase: phase_serve's first four requests through
# reserve="prompt" on a small pool, sync_every, a deadline, a journal, a
# snapshot of a dropped engine and resume_engine
DURABLE_REQUESTS, DURABLE_SYNC, DURABLE_STEPS_A = 4, 4, 6
DURABLE_ENGINE = dict(max_batch=4, page_size=16, max_ctx=128)


def durable_pages(reqs, max_new):
    """A pool that holds each trajectory alone but, 3 pages short of all
    of them at once, makes the rows' growth preempt."""
    ps = DURABLE_ENGINE["page_size"]
    traj = [-(-(len(r.prompt) + max_new) // ps) for r in reqs]
    return max(max(traj), sum(traj) - 3)


def phase_serve_durable(torch, eng, cfg, card):
    """granite-3-2b at full width, ``policy("ff_reduce",
    attention="pallas")``: ``phase_serve``'s first DURABLE_REQUESTS
    requests (its engine ``eng`` holds their results and the weights)
    through engine A with ``reserve="prompt"`` on ``durable_pages`` pages,
    ``sync_every=DURABLE_SYNC``, a request journal and ``deadline_steps``
    of half its decode steps on the first request; A takes
    DURABLE_STEPS_A scheduler iterations, ``save_snapshot``, and is
    dropped as a crash would; engine B = ``resume_engine`` from the
    snapshot and the journal runs to the end.  Fails unless the requests
    without a deadline end OK with ``eng``'s tokens and f32 and FF scores
    bit for bit, the deadline request TIMEOUT with a bitwise prefix of
    them, at least one row was preempted over A and B, the journal is
    empty, the paging metadata clean, and the launches exactly ``mean_sq``
    81 a forward and ``attention`` 40 a prefill (re-prefills included,
    the rows B restored not).  Returns the launch counts."""
    import tempfile
    import numpy as np
    import repro_torch.ff as ff
    from repro_torch.serve import Request, ServeEngine, resume_engine
    dev = eng.params["final_norm"].device
    base = eng.results
    reqs = serve_requests(np.random.default_rng(SEED),
                          cfg.vocab_size)[:DURABLE_REQUESTS]
    max_new = reqs[0].max_new
    deadline = (max_new - 1) // 2              # half its decode steps
    pages = durable_pages(reqs, max_new)
    tmp = tempfile.TemporaryDirectory()
    snapdir, wal = os.path.join(tmp.name, "snap"), \
        os.path.join(tmp.name, "wal.jsonl")
    t0 = time.perf_counter()
    reset_launch_counts()
    with ff.policy("ff_reduce", attention="pallas"):
        a = ServeEngine(eng.params, cfg, device=dev, reserve="prompt",
                        sync_every=DURABLE_SYNC, num_pages=pages,
                        journal=wal, **DURABLE_ENGINE)
    for i, r in enumerate(reqs):
        if a.submit(Request(uid=r.uid, prompt=r.prompt, max_new=max_new,
                            deadline_steps=deadline if i == 0 else None)) \
                != "QUEUED":
            raise AssertionError(f"durable serving: {r.uid} not queued")
    for _ in range(DURABLE_STEPS_A):
        a.step()
    a.save_snapshot(snapdir)
    snap_steps, pf_a = a.decode_steps, len(a.prefill_s)
    pre_a, dec_s = a.guard_stats["preempted"], list(a.decode_s)
    del a                                       # the crash
    gc.collect()
    torch.cuda.empty_cache()
    with ff.policy("ff_reduce", attention="pallas"):
        b = resume_engine(eng.params, cfg, snapdir, journal=wal, device=dev)
    restored = sum(s is not None for s in b._slots)
    res = b.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    n_pf, n_dec = pf_a + len(b.prefill_s), b.decode_steps
    stats = dict(b.guard_stats)
    problems = b.kv.check_integrity()
    dec_s += b.decode_s
    wal_bytes = os.path.getsize(wal)
    del b
    tmp.cleanup()
    for i, r in enumerate(reqs):
        got, want = res[r.uid], base[r.uid]
        n = len(got.tokens)
        status = "TIMEOUT" if i == 0 else "OK"
        if got.status != status or (i and n != len(want.tokens)) \
                or not 0 < n <= len(want.tokens):
            raise AssertionError(f"durable serving uid {r.uid}: "
                                 f"{got.status} ({got.detail}), {n} tokens")
        for name in ("tokens", "logprobs", "logprobs_ff"):
            x, y = getattr(got, name), getattr(want, name)[:n]
            if x.dtype != y.dtype or x.tobytes() != y.tobytes():
                raise AssertionError(f"durable serving uid {r.uid}: "
                                     f"{name} {x} != phase_serve's {y}")
    if stats["preempted"] < 1 or wal_bytes or problems != ([], set()) \
            or restored < 1:
        raise AssertionError(f"durable serving: guard_stats {stats}, "
                             f"journal {wal_bytes} bytes, integrity "
                             f"{problems}, {restored} rows restored")
    norms = 2 * cfg.num_layers + 1
    want = {**{k: 0 for k in launches}, "mean_sq": norms * (n_pf + n_dec),
            "attention": cfg.num_layers * n_pf}
    run = {"wall_s": wall, "decode_steps": n_dec,
           "decode_steps_before_snapshot": snap_steps, "prefills": n_pf,
           "rows_restored": restored, "preempted": stats["preempted"],
           "preempted_before_snapshot": pre_a, "num_pages": pages,
           "deadline_tokens": len(res[reqs[0].uid].tokens),
           "decode_step_ms": 1e3 * float(np.mean(dec_s)), "card": card}
    log(f"durable serving (reserve=prompt, sync_every={DURABLE_SYNC}, "
        f"snapshot after {DURABLE_STEPS_A} iterations, engine dropped, "
        f"resume_engine): {json.dumps(run)}; {DURABLE_REQUESTS - 1} "
        f"requests OK and the deadline request's TIMEOUT prefix bit for "
        f"bit phase_serve's (tokens, f32 and FF scores); launches "
        f"{launches}, expected {want}")
    if launches != want:
        raise AssertionError(f"durable serving launches {launches} != "
                             f"{want}")
    return launches


def kineto_events(prof):
    """The raw events of a ``torch.profiler`` capture.  They are read
    through ``prof.profiler.kineto_results``, which is not public torch
    API (parsing them into ``prof.events()`` takes minutes for a decode
    step's ~400,000 launches): if a torch release drops it, this raises
    rather than let a busy share read 0."""
    res = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if res is None or not hasattr(res, "events"):
        raise AssertionError(
            f"torch {__import__('torch').__version__}: the profiler has no "
            f"kineto_results.events(); the device-busy shares cannot be read")
    return res.events()


def device_busy_us(prof):
    """(device operations, the union of their intervals in us) that
    ``torch.profiler`` recorded, from its raw events
    (:func:`kineto_events`); the device-side copies of
    ``record_function`` ranges, which span idle gaps, left out."""
    from torch.autograd import DeviceType
    spans = sorted((e.start_ns(), e.end_ns())
                   for e in kineto_events(prof)
                   if e.device_type() == DeviceType.CUDA
                   and not e.is_user_annotation())
    busy, end = 0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return len(spans), busy / 1e3


class ObsCallCounter:
    """Inside the ``with``: every registry accessor call (``counter``,
    ``gauge``, ``histogram``) and trace emitter call (``complete``,
    ``instant``, ``counter``, ``name_request_track``) recorded in
    ``calls``.  :meth:`host_us` replays them on a fresh registry and
    trace in a timed loop (each counter incremented, gauge set, histogram
    observed), host clock, and returns the us one replay takes."""

    def __enter__(self):
        from repro_torch import obs
        self.obs, self.calls, self._saved = obs, [], []
        for cls, names in ((obs.MetricsRegistry, ("counter", "gauge",
                                                  "histogram")),
                           (obs.TraceRecorder, ("complete", "instant",
                                                "counter",
                                                "name_request_track"))):
            for name in names:
                fn = getattr(cls, name)
                self._saved.append((cls, name, fn))

                def spy(this, *a, _fn=fn, _kind=(cls, name), **k):
                    self.calls.append((_kind, a, k))
                    return _fn(this, *a, **k)
                setattr(cls, name, spy)
        return self

    def __exit__(self, *exc):
        for cls, name, fn in self._saved:
            setattr(cls, name, fn)
        return False

    def counts(self):
        n_reg = sum(c[0][0] is self.obs.MetricsRegistry for c in self.calls)
        return n_reg, len(self.calls) - n_reg

    def host_us(self, reps=2000):
        reg, trace = self.obs.MetricsRegistry(), self.obs.TraceRecorder()
        op = {"counter": lambda m: m.inc(), "gauge": lambda m: m.set(1.0),
              "histogram": lambda m: m.observe(4.0)}

        def replay():
            for (cls, name), a, k in self.calls:
                if cls is self.obs.MetricsRegistry:
                    op[name](getattr(reg, name)(*a, **k))
                else:
                    getattr(trace, name)(*a, **k)
        replay()
        t0 = time.perf_counter()
        for _ in range(reps):
            replay()
        return (time.perf_counter() - t0) / reps * 1e6


def phase_decode_profile(torch, eng, cfg):
    """Device-busy share of one decode step with every row full, inside
    ``obs.enable()``: the union of the device intervals that
    torch.profiler records in the step, over the step's wall time on the
    host clock; the capture must hold the step's ``serve.decode_step``
    range.  The step's registry and trace calls are counted
    (:class:`ObsCallCounter`; no row retires in it) and their host time
    measured by replaying them."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import obs
    from repro_torch.serve import Request
    unprofiled_ms = 1e3 * float(np.mean(eng.decode_s))   # the served run
    rng = np.random.default_rng(SEED + 2)
    for i in range(eng.max_batch):
        eng.submit(Request(uid=1000 + i, prompt=rng.integers(
            1, cfg.vocab_size, size=PROMPT_LENS[1]).astype(np.int32),
            max_new=4))
    eng.step()                  # admits (prefills) every row, one decode
    torch.cuda.synchronize()
    steps, prefills, done = (eng.decode_steps, len(eng.prefill_s),
                             len(eng.results))
    with obs.enable(), ObsCallCounter() as counter, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()              # one decode step of every row, no admission
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if eng.decode_steps != steps + 1 or len(eng.prefill_s) != prefills \
            or len(eng.results) != done:
        raise AssertionError("profiled step was not one decode step (or "
                             "a row retired in it)")
    ranges = sum(e.name() == "serve.decode_step"
                 and e.device_type() == DeviceType.CPU
                 for e in kineto_events(prof))
    if ranges != 1:
        raise AssertionError(f"the profiled step holds {ranges} "
                             f"serve.decode_step ranges")
    n_reg, n_trace = counter.counts()
    us = counter.host_us()
    log(f"obs in one full-width decode step: {n_reg} registry calls and "
        f"{n_trace} trace calls, {us:.1f} host us when replayed; the "
        f"served run's step {unprofiled_ms:.1f} ms (before the obs tier: "
        f"{BASELINE_DECODE_STEP_MS:.1f} ms)")
    while eng.step():
        pass
    n_ops, busy = device_busy_us(prof)
    if not n_ops:
        log("decode step device-busy share: not measured (the profiler "
            "recorded no device activity)")
        return None
    prof_step = {"device_ops": n_ops, "device_busy_ms": busy / 1e3,
                 "step_wall_ms": wall * 1e3,
                 "busy_share": busy / 1e3 / (wall * 1e3),
                 "unprofiled_step_ms": unprofiled_ms,
                 "busy_share_of_unprofiled": busy / 1e3 / unprofiled_ms,
                 "serve.decode_step_ranges": ranges,
                 "obs_calls": [n_reg, n_trace], "obs_host_us": us}
    log(f"decode step under torch.profiler (CPU and CUDA activity, inside "
        f"obs.enable()): {json.dumps(prof_step)}")
    return prof_step


# ---------------------------------------------------------------------------
# the decoder-only families beyond dense GQA: MoE, MLA, the VLM backbone,
# the head-dim-128 dense configs
# ---------------------------------------------------------------------------

FAM_PROMPT, FAM_MAX_NEW, FAM_FF_MATH_NEW = 32, 8, 4
MLA_BATCH, MLA_LAYERS, MLA_MAX_NEW = 2, 2, 4
MINITRON_REQUESTS, MINITRON_NEW = 2, 4
# card against CPU, reduced families in f32: the prefill logits (the
# summation orders of cuBLAS's and the CPU's f32 products, the kernels'
# <= 1 ulp and <= 2^-40 against their plain versions)
SMALL_FAMILY_ATOL = 1e-3


SMALL_FAMILY_CASES = (("olmoe-1b-7b", dict(head_dim=128), False),
                      ("olmoe-1b-7b", dict(head_dim=128), True),
                      ("deepseek-v2-236b", {}, False),
                      ("internvl2-1b", {}, False),
                      ("mamba2-370m", {}, False), ("mamba2-370m", {}, True),
                      ("jamba-1.5-large-398b", dict(num_layers=8), False),
                      ("whisper-medium", {}, False))


def small_family_generate(torch, case, dev):
    """SMALL_FAMILY_CASES[``case``] on ``dev``: ``greedy_generate``'s 5
    tokens and the prefill logits of 2 seeded 12-token prompts (and the
    VLM's patches, the enc-dec's frames) under ``policy("ff_reduce",
    attention="pallas")``.  Returns (tokens, logits) on the CPU and the
    launches of the run."""
    import repro_torch.ff as ff
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, init_cache, prefill
    from repro_torch.train.serve_step import greedy_generate
    arch, extra, ff_math = SMALL_FAMILY_CASES[case]
    cfg = get_config(arch).reduced(compute_dtype="float32", **extra)
    params = init_params(cfg, torch.Generator().manual_seed(SEED))
    g = torch.Generator().manual_seed(SEED + 5)
    prompt = torch.randint(1, cfg.vocab_size, (2, 12), generator=g)
    inputs = {}
    if cfg.family == "vlm":
        inputs["patches"] = torch.randn((2, cfg.num_patches, cfg.d_model),
                                        generator=g)
    if cfg.family == "encdec":
        inputs["frames"] = torch.randn((2, cfg.encoder_seq, cfg.d_model),
                                       generator=g)
    cache_len = 12 + 5 + cfg.num_patches
    w = to_device(params, dev) if dev == "cuda" else params
    x = {k: v.to(dev) for k, v in inputs.items()}
    reset_launch_counts()
    with ff.policy("ff_reduce", attention="pallas", ff_math=ff_math), \
            ff.use(silu="pallas", exp="pallas", log1p="pallas"), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore")     # decode: kv_len -> ff
        toks = greedy_generate(w, cfg, prompt.to(dev), 5, cache_len,
                               extra_inputs=x or None)
        cache = init_cache(cfg, 2, cache_len, device=dev)
        logits, _ = prefill(w, {"tokens": prompt.to(dev), **x}, cfg, cache)
    return (toks.cpu(), logits.cpu()), launch_counts()


def small_families(torch, cpu):
    """Reduced olmoe-1b-7b (head dim 128), deepseek-v2-236b,
    internvl2-1b, mamba2-370m, jamba-1.5-large-398b (one 8-layer period)
    and whisper-medium (64 frames from a seeded normal), f32 compute,
    through ``greedy_generate`` on the card under ``policy("ff_reduce",
    attention="pallas")`` (olmoe and mamba2 also under ``ff_math`` with
    ``ff.use(silu=, exp=, log1p="pallas")``) against the same on the
    CPU (``cpu``: ``small_family_generate``'s results there, where every
    kernel is its plain version): equal tokens, prefill logits within
    SMALL_FAMILY_ATOL, the kernels launched on the card (mamba2 launches
    no attention)."""
    from repro_torch.configs import get_config
    for case, (arch, extra, ff_math) in enumerate(SMALL_FAMILY_CASES):
        (tc, lc), n = small_family_generate(torch, case, "cuda")
        tp, lp = cpu[case]
        gap = float((lc - lp).abs().max())
        log(f"small {arch}{' ff_math' if ff_math else ''} card vs CPU: "
            f"tokens {tc.tolist()} == {tp.tolist()}: "
            f"{torch.equal(tc, tp)}; prefill logits within {gap:.3e}; "
            f"launches { {k: v for k, v in n.items() if v} }")
        want = {"mean_sq"} | ({"attention"} if get_config(arch).family
                              != "ssm" else set()) | ({"ff_math"} if ff_math
                                                      else set())
        if not (torch.equal(tc, tp) and gap <= SMALL_FAMILY_ATOL
                and all(n[k] > 0 for k in want)
                and all(v == 0 for k, v in n.items() if k not in want)):
            raise AssertionError(f"small {arch}: card vs CPU tokens "
                                 f"{tc.tolist()} / {tp.tolist()}, logits "
                                 f"{gap:.3e}, launches {n}")


def bf16_params(torch, cfg, seed):
    """Random weights of ``cfg`` on the card from ``seed``, cast to bf16
    (the f32 draw freed); returns (params, parameter count)."""
    from repro_torch.models import init_params
    from repro_torch.models.model import cast_params
    f32 = init_params(cfg, torch.Generator(device="cuda").manual_seed(seed))
    n = param_count(f32)
    w = cast_params(f32, torch.bfloat16)
    del f32
    gc.collect()
    torch.cuda.empty_cache()
    return w, n


def greedy_margins(torch, params, cfg, prompt, max_new, cache_len,
                   extra=None):
    """``greedy_generate``'s loop (prefill, then decode steps) under the
    ambient policy, keeping each step's top-2 logit margin; returns
    (tokens (B, max_new), prefill logits, margins (B, max_new)).
    ``extra`` joins the prefill batch (``{"frames": ...}``)."""
    from repro_torch.models import decode_step, init_cache, prefill
    B, S = prompt.shape
    cache = init_cache(cfg, B, cache_len, device=prompt.device)
    logits, cache = prefill(params, {"tokens": prompt, **(extra or {})},
                            cfg, cache)
    first = logits.float()
    toks, margins = [], []
    for t in range(max_new):
        if t:
            logits, cache = decode_step(params, toks[-1][:, None], S + t - 1,
                                        cache, cfg)
        top = torch.topk(logits.float(), 2, dim=-1).values
        margins.append(top[:, 0] - top[:, 1])
        toks.append(torch.argmax(logits, -1).to(torch.int32))
    return torch.stack(toks, 1), first, torch.stack(margins, 1)


def family_greedy(torch, params, cfg, prompt, max_new, cache_len,
                  extra=None):
    """``greedy_generate`` under the ambient policy, the launch counts read
    around it; then one more prefill of the same prompt, timed.  Returns
    (tokens, prefill logits, launches, wall s, prefill ms).  ``extra``
    joins the prefill batch (``{"frames": ...}``)."""
    from repro_torch.models import init_cache, prefill
    from repro_torch.train.serve_step import greedy_generate
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = greedy_generate(params, cfg, prompt, max_new, cache_len,
                           extra_inputs=extra)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    cache = init_cache(cfg, prompt.shape[0], cache_len, device="cuda")
    t0 = time.perf_counter()
    logits, _ = prefill(params, {"tokens": prompt, **(extra or {})}, cfg,
                        cache)
    torch.cuda.synchronize()
    return toks, logits.float(), launches, wall, \
        1e3 * (time.perf_counter() - t0)


def tokens_agree(name, toks, toks_p, margins_p, gap) -> None:
    """The kernel route's greedy tokens against the plain route's: equal,
    or each row equal up to a step where the plain run's top-2 margin is
    at most twice the prefill logits' gap between the routes (a near-tie,
    logged; the rows differ after it).  With a gap of 0 the tokens must
    be equal."""
    toks, toks_p = toks.cpu(), toks_p.cpu()
    for row in range(toks.shape[0]):
        diff = (toks[row] != toks_p[row]).nonzero().flatten()
        if not len(diff):
            continue
        t = int(diff[0])
        margin = float(margins_p[row, t])
        log(f"  {name} row {row} step {t}: kernel {int(toks[row, t])}, "
            f"plain {int(toks_p[row, t])}; plain top-2 margin "
            f"{margin:.4e}, prefill logits gap {gap:.4e}")
        if not margin <= 2 * gap:
            raise AssertionError(f"{name}: tokens differ at row {row} step "
                                 f"{t} beyond a near-tie (margin {margin} "
                                 f"> 2 x gap {gap})")


def family_launches_ok(name, cfg, launches, n_fwd, ff_math_per_layer):
    """The launches of ``n_fwd`` forwards (one prefill first): mean_sq at
    every norm, the attention kernel once a layer in the prefill (decode's
    per-row kv_len takes the ff tier), ff_math ``ff_math_per_layer`` times
    a layer a forward, nothing else."""
    L = cfg.num_layers
    want = {**{k: 0 for k in launches}, "mean_sq": (2 * L + 1) * n_fwd,
            "attention": L, "ff_math": ff_math_per_layer * L * n_fwd}
    if launches != want:
        raise AssertionError(f"{name}: launches {launches} != {want}")


def phase_serve_moe(torch, card: str):
    """olmoe-1b-7b at full size (16 layers, d_model 2048, 16 MHA heads at
    head dim 128, 64 experts top-8, random bf16 weights from a seed)
    through ``greedy_generate``: FAM_PROMPT-token prompts of 4 rows,
    FAM_MAX_NEW new tokens under ``policy("ff_reduce", attention=
    "pallas")`` (the attention kernel's HD = 128 instance in the prefill,
    mean_sq at every norm), then FAM_FF_MATH_NEW under ``ff_math`` with
    ``ff.use(silu="pallas")`` (the experts' silu gate through
    ``math_elementwise``), then the first run's loop under
    ``attention="ff"`` (no attention kernel): the prefill logits' largest
    difference, whether the tokens are equal, and the plain path's top-2
    margin where one is not.  Returns (launches, ff_math launches)."""
    import numpy as np
    import repro_torch.ff as ff
    from repro_torch.configs import get_config
    cfg = get_config("olmoe-1b-7b")
    t0 = time.perf_counter()
    params, n_params = bf16_params(torch, cfg, SEED + 7)
    torch.cuda.synchronize()
    log(f"olmoe-1b-7b: {n_params:,} params, bf16 "
        f"({torch.cuda.memory_allocated() / 1e9:.2f} GB allocated), set up "
        f"in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED + 8)
    prompt = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, (4, FAM_PROMPT)).astype(np.int64)).cuda()
    cache_len = FAM_PROMPT + FAM_MAX_NEW + 8
    runs = {}
    for what, pol, n_new in (
            ("pallas", dict(attention="pallas"), FAM_MAX_NEW),
            ("ff_math", dict(attention="pallas", ff_math=True),
             FAM_FF_MATH_NEW)):
        with ff.policy("ff_reduce", **pol), ff.use(silu="pallas"):
            toks, logits, launches, wall, pf_ms = family_greedy(
                torch, params, cfg, prompt, n_new, cache_len)
        family_launches_ok(f"olmoe {what}", cfg, launches, n_new,
                           1 if what == "ff_math" else 0)
        if not (toks.shape == (4, n_new) and bool(torch.isfinite(
                logits).all()) and int(toks.min()) >= 0
                and int(toks.max()) < cfg.vocab_size):
            raise AssertionError(f"olmoe {what}: tokens {toks.shape}, "
                                 f"logits finite {torch.isfinite(logits).all()}")
        n_tok = toks.numel()
        stats = {"tokens_per_s": n_tok / wall, "prefill_ms": pf_ms,
                 "decode_step_ms": 1e3 * (wall - pf_ms / 1e3)
                 / max(n_new - 1, 1), "wall_s": wall, "tokens": n_tok,
                 "card": card}
        log(f"olmoe-1b-7b {what}: {json.dumps(stats)}; launches "
            f"{ {k: v for k, v in launches.items() if v} }")
        runs[what] = (toks, logits, launches)
    # the same prompts without the attention kernel
    with ff.policy("ff_reduce", attention="ff"), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore")
        reset_launch_counts()
        toks_ff, logits_ff, margins = greedy_margins(
            torch, params, cfg, prompt, FAM_MAX_NEW, cache_len)
        if launch_counts()["attention"]:
            raise AssertionError("attention='ff' launched the kernel")
    toks_k, logits_k, _ = runs["pallas"]
    diff = float((logits_k - logits_ff).abs().max())
    same = torch.equal(toks_k.cpu(), toks_ff.cpu())
    log(f"olmoe-1b-7b kernel vs attention='ff': prefill logits differ by "
        f"at most {diff:.4e} (|logits| <= "
        f"{float(logits_ff.abs().max()):.3f}); tokens equal: {same}")
    if not same:
        rows, steps = torch.nonzero(toks_k.cpu() != toks_ff.cpu(),
                                    as_tuple=True)
        for r, s in zip(rows.tolist(), steps.tolist()):
            log(f"  row {r} step {s}: kernel {int(toks_k[r, s])}, ff "
                f"{int(toks_ff[r, s])}; ff path's top-2 margin "
                f"{float(margins[r, s]):.4e}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return runs["pallas"][2], runs["ff_math"][2]


def phase_serve_mla(torch, card: str):
    """deepseek-v2-236b at its full width cut to MLA_LAYERS layers (random
    bf16 weights from a seed) through ``greedy_generate``: MLA_BATCH
    FAM_PROMPT-token prompts, MLA_MAX_NEW new tokens under
    ``policy("ff_reduce", attention="pallas")``: the MLA prefill's q / k
    at 128 + 64 through the attention kernel's HD = 192 instance, the
    absorbed decode (one KV head at 576, kv_len) on the ff tier.  Returns
    the launches."""
    import dataclasses
    import numpy as np
    import repro_torch.ff as ff
    from repro_torch.configs import get_config
    from repro_torch.kernels import ff_attention as fa
    cfg = dataclasses.replace(get_config("deepseek-v2-236b"),
                              num_layers=MLA_LAYERS)
    t0 = time.perf_counter()
    params, n_params = bf16_params(torch, cfg, SEED + 9)
    torch.cuda.synchronize()
    log(f"deepseek-v2-236b, {MLA_LAYERS} layers: {n_params:,} "
        f"params, bf16 ({torch.cuda.memory_allocated() / 1e9:.2f} GB "
        f"allocated), set up in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED + 10)
    prompt = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, (MLA_BATCH, FAM_PROMPT)).astype(np.int64)).cuda()
    with ff.policy("ff_reduce", attention="pallas"), \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        toks, logits, launches, wall, pf_ms = family_greedy(
            torch, params, cfg, prompt, MLA_MAX_NEW,
            FAM_PROMPT + MLA_MAX_NEW + 8)
    family_launches_ok("deepseek-v2", cfg, launches, MLA_MAX_NEW, 0)
    plan = tuple(fa.flash_attention_pallas.last_plan)
    fell = sum("kv_len" in str(w.message) for w in caught)
    if not (toks.shape == (MLA_BATCH, MLA_MAX_NEW) and fell
            and bool(torch.isfinite(logits).all())):
        raise AssertionError(f"deepseek-v2: tokens {toks.shape}, kv_len "
                             f"warnings {fell}, finite logits "
                             f"{bool(torch.isfinite(logits).all())}")
    stats = {"tokens_per_s": toks.numel() / wall, "prefill_ms": pf_ms,
             "decode_step_ms": 1e3 * (wall - pf_ms / 1e3)
             / max(MLA_MAX_NEW - 1, 1), "wall_s": wall,
             "tokens": toks.numel(), "card": card}
    log(f"deepseek-v2-236b ({MLA_LAYERS} layers): {json.dumps(stats)}; "
        f"launches { {k: v for k, v in launches.items() if v} }; the "
        f"prefill's kernel plan {plan} at head dim 192; {fell} kv_len "
        f"warnings (the absorbed decode on the ff tier); tokens "
        f"{toks.tolist()}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_serve_minitron(torch, card: str):
    """minitron-4b at full size (32 layers, d_model 3072, 24 / 8 heads at
    head dim 128; random weights from a seed) through ``ServeEngine``:
    MINITRON_REQUESTS requests of FAM_PROMPT tokens, MINITRON_NEW new
    tokens under ``policy("ff_reduce", attention="pallas")``: every
    prefill through the attention kernel's HD = 128 instance (G = 3).
    Returns the launches."""
    import numpy as np
    import repro_torch.ff as ff
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serve import Request, ServeEngine
    cfg = get_config("minitron-4b")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda")
                         .manual_seed(SEED + 11))
    n_params = param_count(params)
    with ff.policy("ff_reduce", attention="pallas"):
        eng = ServeEngine(params, cfg, max_batch=MINITRON_REQUESTS,
                          page_size=16, max_ctx=64)
    torch.cuda.synchronize()
    log(f"minitron-4b: {n_params:,} params (f32) + bf16 copy, set up in "
        f"{time.perf_counter() - t0:.1f} s "
        f"({torch.cuda.memory_allocated() / 1e9:.2f} GB allocated)")
    rng = np.random.default_rng(SEED + 12)
    for uid in range(MINITRON_REQUESTS):
        eng.submit(Request(uid=uid, prompt=rng.integers(
            1, cfg.vocab_size, FAM_PROMPT).astype(np.int32),
            max_new=MINITRON_NEW))
    reset_launch_counts()
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    n_pf, n_dec = len(eng.prefill_s), eng.decode_steps
    L = cfg.num_layers
    want = {**{k: 0 for k in launches}, "mean_sq": (2 * L + 1) * (n_pf
                                                                  + n_dec),
            "attention": L * n_pf}
    if launches != want or n_pf != MINITRON_REQUESTS:
        raise AssertionError(f"minitron-4b: launches {launches} != {want} "
                             f"({n_pf} prefills)")
    for uid, r in res.items():
        if r.status != "OK" or r.tokens.shape != (MINITRON_NEW,) \
                or not np.isfinite(r.logprobs_ff).all():
            raise AssertionError(f"minitron-4b uid {uid}: {r.status} "
                                 f"{r.tokens.shape}")
    stats = {"tokens_per_s": MINITRON_REQUESTS * MINITRON_NEW / wall,
             "prefill_ms": 1e3 * float(np.mean(eng.prefill_s)),
             "decode_step_ms": 1e3 * float(np.mean(eng.decode_s)),
             "wall_s": wall, "card": card}
    log(f"minitron-4b engine: {json.dumps(stats)}; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# the SSD's FF exponentials through the ff_math kernel
MATH_USE = dict(exp="pallas", log1p="pallas", silu="pallas")
# math_elementwise launches a layer: a prefill (softplus's exp and log1p,
# A, _segsum, decay_end, chunk_decay, decay_in) and a decode step
# (softplus 2, A, the decay)
SSD_MATH_PREFILL, SSD_MATH_DECODE = 7, 4
MAMBA_LONG, MAMBA_LONG_NEW = 600, 4      # 3 chunks of 256, the last padded
WHISPER_REQUESTS, WHISPER_PROMPT, WHISPER_NEW = 2, 32, 2


def serve_stats(toks, wall, pf_ms, n_new, card):
    return {"tokens_per_s": toks.numel() / wall, "prefill_ms": pf_ms,
            "decode_step_ms": 1e3 * (wall - pf_ms / 1e3) / max(n_new - 1, 1),
            "wall_s": wall, "tokens": toks.numel(), "card": card}


def phase_serve_mamba2(torch, card: str):
    """mamba2-370m at full size (48 SSD layers, d_model 1024, 32 heads x
    64, state 128, random bf16 weights from a seed) through
    ``greedy_generate``: 4 prompts of FAM_PROMPT tokens, FAM_MAX_NEW new
    under ``policy("ff_reduce", attention="pallas")`` (``mean_sq`` at
    every norm; no attention), the same under ``ff_math`` with the SSD's
    exp / log1p through ``math_elementwise`` (SSD_MATH_PREFILL launches a
    layer a prefill, SSD_MATH_DECODE a decode step), and one prompt of
    MAMBA_LONG tokens under ``ff_math`` (3 SSD chunks, the last padded:
    the inter-chunk recurrence at full width).  Each run's launches are
    held to the count its code gives; each is run again through the plain
    routes (``mean_sq="jnp"``; ``exp=, log1p="jnp"`` for ``ff_math``, where
    the kernel is its plain version's bits: prefill logits equal and
    tokens equal).  Returns {path: launches}."""
    import numpy as np
    import repro_torch.ff as ff
    from repro_torch.configs import get_config
    cfg = get_config("mamba2-370m")
    t0 = time.perf_counter()
    params, n_params = bf16_params(torch, cfg, SEED + 13)
    torch.cuda.synchronize()
    log(f"mamba2-370m: {n_params:,} params, bf16 "
        f"({torch.cuda.memory_allocated() / 1e9:.2f} GB allocated), set up "
        f"in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED + 14)
    short = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, (4, FAM_PROMPT)).astype(np.int64)).cuda()
    long = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, (1, MAMBA_LONG)).astype(np.int64)).cuda()
    L = cfg.num_layers
    out = {}
    for path, prompt, n_new, ff_math in (
            ("serve_mamba2", short, FAM_MAX_NEW, False),
            ("serve_mamba2_ff_math", short, FAM_MAX_NEW, True),
            ("serve_mamba2_long", long, MAMBA_LONG_NEW, True)):
        cache_len = prompt.shape[1] + n_new + 8
        pol = dict(attention="pallas", ff_math=ff_math)
        with ff.policy("ff_reduce", **pol), ff.use(**MATH_USE):
            toks, logits, launches, wall, pf_ms = family_greedy(
                torch, params, cfg, prompt, n_new, cache_len)
        per = (SSD_MATH_PREFILL + SSD_MATH_DECODE * (n_new - 1)) \
            if ff_math else 0
        want = {**{k: 0 for k in launches}, "mean_sq": (L + 1) * n_new,
                "ff_math": L * per}
        if launches != want:
            raise AssertionError(f"mamba2 {path}: launches {launches} != "
                                 f"{want}")
        if not (toks.shape == (prompt.shape[0], n_new)
                and bool(torch.isfinite(logits).all())):
            raise AssertionError(f"mamba2 {path}: tokens {toks.shape}, "
                                 f"finite logits "
                                 f"{bool(torch.isfinite(logits).all())}")
        plain = dict(exp="jnp", log1p="jnp") if ff_math \
            else dict(mean_sq="jnp")
        with ff.policy("ff_reduce", **pol), ff.use(**{**MATH_USE, **plain}):
            reset_launch_counts()
            toks_p, logits_p, margins = greedy_margins(
                torch, params, cfg, prompt, n_new, cache_len)
            fired = {k: v for k, v in launch_counts().items() if v}
        routed = {"ff_math"} if ff_math else {"mean_sq"}
        if routed & set(fired):
            raise AssertionError(f"mamba2 {path}: the plain routes launched "
                                 f"{fired}")
        gap = float((logits - logits_p).abs().max())
        tokens_agree(f"mamba2 {path}", toks, toks_p, margins, gap)
        if ff_math and (gap != 0 or not torch.equal(toks.cpu(),
                                                    toks_p.cpu())):
            raise AssertionError(f"mamba2 {path}: the ff_math kernel's "
                                 f"run differs from its plain version's "
                                 f"(logits gap {gap})")
        log(f"mamba2-370m {path} ({tuple(prompt.shape)}, {n_new} new): "
            f"{json.dumps(serve_stats(toks, wall, pf_ms, n_new, card))}; "
            f"launches { {k: v for k, v in launches.items() if v} }; vs "
            f"the plain routes {plain}: prefill logits gap {gap:.4e} "
            f"(|logits| <= {float(logits_p.abs().max()):.3f}), tokens "
            f"equal: {torch.equal(toks.cpu(), toks_p.cpu())}")
        out[path] = launches
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_serve_whisper(torch, card: str):
    """whisper-medium at full size (24 encoder + 24 decoder layers,
    d_model 1024, 16 MHA heads at 64, d_ff 4096, random bf16 weights from
    a seed) through ``greedy_generate``: WHISPER_REQUESTS requests of
    1500 frames (a seeded normal draw) and WHISPER_PROMPT prompt tokens,
    WHISPER_NEW new, under ``policy("ff_reduce", attention="pallas")``:
    the attention kernel non-causal over the 1500 frames in each encoder
    layer, causal in each decoder layer's self attention and non-causal
    from the prompt to the frames in its cross attention (72 launches a
    prefill), the decode steps' 48 attention calls a step on the ff tier
    (the dispatch's kv_len route, a warning each).  Then the same through
    ``attention="fast"`` (no attention kernel): prefill logits' gap,
    tokens equal but at a near-tie.  Returns the launches."""
    import numpy as np
    import repro_torch.ff as ff
    from repro_torch.configs import get_config
    cfg = get_config("whisper-medium")
    t0 = time.perf_counter()
    params, n_params = bf16_params(torch, cfg, SEED + 15)
    g = torch.Generator(device="cuda").manual_seed(SEED + 16)
    frames = torch.randn((WHISPER_REQUESTS, cfg.encoder_seq, cfg.d_model),
                         generator=g, device="cuda")
    torch.cuda.synchronize()
    log(f"whisper-medium: {n_params:,} params, bf16 "
        f"({torch.cuda.memory_allocated() / 1e9:.2f} GB allocated), set up "
        f"in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED + 17)
    prompt = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, (WHISPER_REQUESTS, WHISPER_PROMPT)).astype(
        np.int64)).cuda()
    cache_len = WHISPER_PROMPT + WHISPER_NEW + 8
    extra = {"frames": frames}
    with ff.policy("ff_reduce", attention="pallas"), \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        toks, logits, launches, wall, pf_ms = family_greedy(
            torch, params, cfg, prompt, WHISPER_NEW, cache_len, extra)
    Le, L = cfg.encoder_layers, cfg.num_layers
    n_dec = WHISPER_NEW - 1
    want = {**{k: 0 for k in launches},
            "mean_sq": 2 * Le + 3 * L + 1 + (3 * L + 1) * n_dec,
            "attention": Le + 2 * L}
    fell = sum("kv_len" in str(w.message) for w in caught)
    if launches != want or fell != 2 * L * n_dec:
        raise AssertionError(f"whisper: launches {launches} != {want}, or "
                             f"{fell} kv_len warnings != {2 * L * n_dec}")
    if not (toks.shape == (WHISPER_REQUESTS, WHISPER_NEW)
            and bool(torch.isfinite(logits).all())):
        raise AssertionError(f"whisper: tokens {toks.shape}, finite logits "
                             f"{bool(torch.isfinite(logits).all())}")
    with ff.policy("ff_reduce", attention="fast"):
        reset_launch_counts()
        toks_p, logits_p, margins = greedy_margins(
            torch, params, cfg, prompt, WHISPER_NEW, cache_len, extra)
        if launch_counts()["attention"]:
            raise AssertionError("attention='fast' launched the kernel")
    gap = float((logits - logits_p).abs().max())
    tokens_agree("whisper", toks, toks_p, margins, gap)
    log(f"whisper-medium ({WHISPER_REQUESTS} x {cfg.encoder_seq} frames, "
        f"{WHISPER_PROMPT} tokens, {WHISPER_NEW} new): "
        f"{json.dumps(serve_stats(toks, wall, pf_ms, WHISPER_NEW, card))}; "
        f"launches { {k: v for k, v in launches.items() if v} }; {fell} "
        f"kv_len warnings; vs attention='fast': prefill logits gap "
        f"{gap:.4e} (|logits| <= {float(logits_p.abs().max()):.3f}), "
        f"tokens equal: {torch.equal(toks.cpu(), toks_p.cpu())}")
    del params, frames
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_families(torch, card: str, cpu):
    """The families beyond dense GQA: the reduced ones card against CPU
    (``cpu``: the CPU references), then olmoe-1b-7b, deepseek-v2 (2
    layers), minitron-4b, mamba2-370m and whisper-medium at full width.
    Returns {path: launches}."""
    small_families(torch, cpu.get("families"))
    moe, moe_ff_math = phase_serve_moe(torch, card)
    mla = phase_serve_mla(torch, card)
    minitron = phase_serve_minitron(torch, card)
    mamba2 = phase_serve_mamba2(torch, card)
    whisper = phase_serve_whisper(torch, card)
    return {"serve_moe": moe, "serve_moe_ff_math": moe_ff_math,
            "serve_mla": mla, "serve_minitron": minitron, **mamba2,
            "serve_whisper": whisper}


def chaos_run(dev):
    """``python -m repro_torch.chaos --device dev`` in this process, its
    output captured.  Returns (exit code, output, report, seconds)."""
    import contextlib
    import io
    from repro_torch.chaos.__main__ import main as chaos_main
    report, out = {}, io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        code = chaos_main(["--device", dev], report=report)
    return code, out.getvalue(), report, time.perf_counter() - t0


def phase_chaos(torch, cpu):
    """``python -m repro_torch.chaos`` (the guarded-serving smoke over
    every fault class, on its own small model) on the card and with
    ``--device cpu`` (``cpu``: ``chaos_run``'s result there): both exit 0,
    and every scenario's statuses and tokens are equal on the two
    devices.  The card run's launches are read around it (the smoke's
    ``probe_kv`` under ``guard_probe="pallas"`` launches
    ``guard_flags``).  Returns them."""
    reports, secs, checks = {}, {}, {}
    reset_launch_counts()
    runs = {"cuda": chaos_run("cuda")}
    launches = launch_counts()
    runs["cpu"] = cpu
    for dev, (code, text, reports[dev], secs[dev]) in runs.items():
        checks[dev] = text.count("  [ok] ")
        if code != 0 or "[FAIL]" in text:
            raise AssertionError(f"chaos smoke on {dev} exited {code}:\n"
                                 + text[-4000:])
    if reports["cuda"] != reports["cpu"]:
        diff = {k: (reports["cuda"].get(k), reports["cpu"].get(k))
                for k in sorted(set(reports["cuda"]) | set(reports["cpu"]))
                if reports["cuda"].get(k) != reports["cpu"].get(k)}
        raise AssertionError(f"chaos smoke card != CPU: {diff}")
    if launches["ff_guard"] < 2:
        raise AssertionError(f"chaos smoke on the card launched ff_guard "
                             f"{launches['ff_guard']} times")
    statuses = {k: sorted({s for s, _ in v.values()})
                for k, v in reports["cuda"].items()}
    log(f"chaos smoke: exit 0 on the card ({checks['cuda']} checks, "
        f"{secs['cuda']:.1f} s) and the CPU ({checks['cpu']} checks, "
        f"{secs['cpu']:.1f} s); statuses and tokens equal in all "
        f"{len(reports['cuda'])} scenarios {json.dumps(statuses)}; card "
        f"launches {launches}")
    return launches


def phase_restart_chaos(torch):
    """``repro_torch.chaos.restart.run_scenario`` for each ``kv_mode``
    with the child process on the card: SIGKILLed mid-decode (its
    ``done`` marker absent), resumed from its newest snapshot that
    verifies and its journal, every request OK with the tokens, and the
    FF score limbs bit for bit, of an uninterrupted run (the checks are
    run_scenario's own)."""
    import tempfile
    from repro_torch.chaos.restart import KV_MODES, run_scenario
    t0 = time.perf_counter()
    rows = []
    for mode in KV_MODES:
        with tempfile.TemporaryDirectory(prefix=f"restart-{mode}-") as d:
            rep = run_scenario(d, mode, device="cuda", timeout_s=300.0)
        rows.append({k: rep[k] for k in (
            "kv_mode", "killed_at_snaps", "killed_at_step",
            "resumed_from_step", "statuses", "seconds")})
    log(f"restart chaos on the card (child SIGKILLed mid-decode, resumed, "
        f"tokens and FF scores bit for bit the uninterrupted run): "
        f"{json.dumps(rows)}; phase {time.perf_counter() - t0:.1f} s")


def train_batches(vocab: int, seq: int, batch: int, n: int, device):
    import torch
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    data = SyntheticLM(DataConfig(vocab_size=vocab, seq_len=seq,
                                  global_batch=batch))
    return [{k: torch.from_numpy(x).to(device)
             for k, x in data.batch(i).items()} for i in range(n)]


def phase_small_train(torch):
    """A reduced granite model (f32 compute) trained 2 steps on the card
    against the same steps on the CPU, where every kernel is its plain
    version: with the whole loss (S = 32), and with remat and the chunked
    loss over a padded last chunk (S = 40, ``loss_chunk`` 24); each under
    ``policy("ff_reduce", attention="pallas")`` and under it with
    ``ff_math=True`` and ``ff.use(silu="pallas")``, where the card's step
    launches ``ff_math`` once a layer in the forward, once more in remat's
    recompute and once in the backward (``sigmoid22``)."""
    import repro_torch.ff as ff
    from repro_torch.configs.granite_3_2b import CONFIG
    from repro_torch.models import init_params
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train.train_step import make_train_step
    for seq, extra in ((32, {}), (40, dict(loss_chunk=24, remat=True))):
        cfg = CONFIG.reduced(compute_dtype="float32", **extra)
        params = init_params(cfg, torch.Generator().manual_seed(SEED))
        for ff_math in (False, True):
            runs, n_math = {}, []
            for dev in ("cuda", "cpu"):
                p = to_device(params, dev)
                opt = AdamW(learning_rate=cosine_schedule(3e-4, 10, 2))
                state = opt.init(p)
                with ff.policy("ff_reduce", attention="pallas",
                               ff_math=ff_math):
                    step = make_train_step(cfg, None, opt)
                runs[dev] = []
                with ff.use(**({"silu": "pallas"} if ff_math else {})):
                    for batch in train_batches(cfg.vocab_size, seq, 4, 2,
                                               dev):
                        n0 = launch_counts()["ff_math"]
                        p, state, m = step(p, state, batch)
                        runs[dev].append((float(m["loss"]),
                                          float(m["grad_norm"])))
                        if dev == "cuda":
                            n_math.append(launch_counts()["ff_math"] - n0)
            want = cfg.num_layers * (3 if cfg.remat else 2) * ff_math
            if n_math != [want] * len(n_math):
                raise AssertionError(f"reduced training {extra} ff_math="
                                     f"{ff_math}: ff_math launches "
                                     f"{n_math} a step, want {want}")
            for i, (a, b) in enumerate(zip(runs["cuda"], runs["cpu"])):
                for name, x, y in zip(("loss", "grad norm"), a, b):
                    if not abs(x - y) <= SMALL_TRAIN_RTOL * abs(y):
                        raise AssertionError(
                            f"reduced training {extra} ff_math={ff_math} "
                            f"step {i}: {name} card {x!r} vs CPU {y!r}")
            log(f"reduced training (2 layers, f32, S={seq}, {extra}, "
                f"ff_math={ff_math}): card vs CPU (loss, grad norm) per "
                f"step {runs['cuda']} vs {runs['cpu']}; ff_math launches a "
                f"step {n_math}")
    small_train_resume(torch)


def small_train_resume(torch, cfg=None):
    """A reduced model on the card (``cfg``, granite-3-2b's by default): 2
    steps with a ``ckpt_dir``, a crash, a new ``Trainer`` that restores
    and takes step 3, bit for bit 3 uninterrupted steps (parameters,
    optimizer state, the last loss)."""
    import tempfile
    import repro_torch.ff as ff
    from repro_torch.checkpoint.checkpoint import flatten_with_names
    from repro_torch.configs.granite_3_2b import CONFIG
    from repro_torch.models import init_params
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train.train_step import make_train_step
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = cfg or CONFIG.reduced(compute_dtype="float32")
    batches = family_batches(torch, cfg, 4, 32, 3, "cuda", SEED + 22)

    class Crash(RuntimeError):
        pass

    def crash(step):
        if step == 2:
            raise Crash()

    def trainer(ckpt_dir, seed=SEED, fault=None):
        params = init_params(cfg, torch.Generator(device="cuda")
                             .manual_seed(seed))
        opt = AdamW(learning_rate=cosine_schedule(3e-4, 10, 3))
        with ff.policy("ff_reduce", attention="pallas"):
            step = make_train_step(cfg, None, opt)
        return Trainer(TrainerConfig(total_steps=3, ckpt_every=2,
                                     ckpt_dir=ckpt_dir, log_every=100),
                       step, params, opt.init(params), batches.__getitem__,
                       fault_hook=fault, log_fn=lambda m: None)

    # one summation order for the embedding's backward (index_put_ with
    # accumulation), which may otherwise vary run to run
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        whole = trainer(None)
        want = whole.run()
        with tempfile.TemporaryDirectory() as tmp:
            first = trainer(tmp, fault=crash)
            try:
                first.run()
            except Crash:
                first.ckpt.wait()
            else:
                raise AssertionError("the crash hook did not fire")
            second = trainer(tmp, seed=SEED + 1)
            if not second.restore() or second.step != 2:
                raise AssertionError(f"trainer restore: step {second.step}")
            got = second.run()
    finally:
        torch.use_deterministic_algorithms(prev)
    same = got["last_loss"] == want["last_loss"] and all(
        torch.equal(x, y) for tree in ("params", "opt_state")
        for (_, x), (_, y) in zip(
            flatten_with_names(getattr(second, tree)),
            flatten_with_names(getattr(whole, tree))))
    if not same:
        raise AssertionError(f"resumed training: {got} vs {want}, or the "
                             f"weights differ")
    log(f"reduced {cfg.name} training resumed from a step-2 checkpoint "
        f"on the card: step 3 bit for bit 3 uninterrupted steps (last "
        f"loss {got['last_loss']!r})")


def phase_train(torch, card: str):
    """granite-3-2b at full width: 4 training steps, the launches of each
    kernel per step, then one more step under torch.profiler."""
    import repro_torch.ff as ff
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.granite_3_2b import CONFIG as cfg
    from repro_torch.models import init_params
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train.train_step import make_train_step
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda")
                         .manual_seed(SEED))
    opt = AdamW(learning_rate=cosine_schedule(3e-4, 10, TRAIN_STEPS),
                ff=True)
    state = opt.init(params)
    with ff.policy("ff_reduce", attention="pallas"):
        step = make_train_step(cfg, None, opt)
    batches = train_batches(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                            TRAIN_STEPS + 1, "cuda")
    long_batch = train_batches(cfg.vocab_size, LONG_SEQ, LONG_BATCH, 1,
                               "cuda")[0]
    torch.cuda.synchronize()
    n_params = param_count(params)
    log(f"granite-3-2b training: {n_params} params, {n_leaves(params)}"
        f" leaves, set up in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    torch.cuda.reset_peak_memory_stats()

    reset_launch_counts()
    per_step, prev = [], launch_counts()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        params, state, m = step(params, state, batches[i])
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        now = launch_counts()
        launched = {k: now[k] - prev[k] for k in now}
        prev = now
        rec = {"step": i + 1, "loss": loss, "grad_norm": gnorm,
               "lr": float(m["lr"]), "step_ms": dt * 1e3,
               "tokens_per_s": tokens / dt, "launches": launched}
        log(f"train step: {json.dumps(rec)}")
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            raise AssertionError(f"training step {i + 1}: loss {loss}, "
                                 f"grad norm {gnorm}")
        per_step.append(rec)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # one step longer than loss_chunk: the chunked loss, recomputed per
    # chunk in the backward pass
    if not LONG_SEQ > cfg.loss_chunk:
        raise AssertionError(f"S={LONG_SEQ} does not exceed loss_chunk")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, state, m = step(params, state, long_batch)
    loss, gnorm = float(m["loss"]), float(m["grad_norm"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    now = launch_counts()
    long_rec = {"step": TRAIN_STEPS + 1, "batch": [LONG_BATCH, LONG_SEQ],
                "loss_chunk": cfg.loss_chunk, "loss": loss,
                "grad_norm": gnorm, "lr": float(m["lr"]),
                "step_ms": dt * 1e3,
                "tokens_per_s": LONG_BATCH * LONG_SEQ / dt,
                "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
                "launches": {k: now[k] - prev[k] for k in now}}
    log(f"train step (chunked loss): {json.dumps(long_rec)}")
    if not (math.isfinite(loss) and math.isfinite(gnorm)):
        raise AssertionError(f"chunked-loss step: loss {loss}, grad norm "
                             f"{gnorm}")
    per_step.append(long_rec)

    launches = launch_counts()
    norms = 2 * cfg.num_layers + 1
    want = {**{k: 0 for k in launches},
            "mean_sq": norms + 2 * cfg.num_layers,    # + remat recompute
            "attention": 2 * cfg.num_layers,          # forward + recompute
            "adamw_update": n_leaves(params)}
    log(f"training launches over {len(per_step)} steps: {launches}; per "
        f"step expected {want}")
    for rec in per_step:
        if rec["launches"] != want:
            raise AssertionError(f"step {rec['step']} launches "
                                 f"{rec['launches']} != {want}")
    telemetry = train_telemetry(torch, step, params, state, batches)
    params, state = telemetry.pop("params"), telemetry.pop("state")

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, m = step(params, state, batches[TRAIN_STEPS])
        float(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n_ops, busy = device_busy_us(prof)
    steady = [r["step_ms"] for r in per_step[1:TRAIN_STEPS]]
    training = {
        "steps": TRAIN_STEPS, "tokens_per_step": tokens,
        "step_ms": [r["step_ms"] for r in per_step[:TRAIN_STEPS]],
        "steady_step_ms": sum(steady) / len(steady),
        "steady_tokens_per_s": tokens / (sum(steady) / len(steady) / 1e3),
        "peak_allocated_gb": peak_gb,
        "chunked_loss_step": {k: long_rec[k] for k in (
            "batch", "step_ms", "tokens_per_s", "peak_allocated_gb")},
        "profiled_step": {"device_ops": n_ops,
                          "device_busy_ms": busy / 1e3,
                          "step_wall_ms": wall * 1e3,
                          "busy_share": busy / 1e3 / (wall * 1e3),
                          "busy_share_of_unprofiled":
                              busy / 1e3 / (sum(steady) / len(steady))},
        "telemetry": telemetry, "card": card}
    log(f"training: {json.dumps(training)}")
    if not n_ops:
        log("training step device-busy share: not measured (the profiler "
            "recorded no device activity)")
    top = sorted(prof.key_averages(), key=lambda e: -e.device_time_total)
    log("profiled training step, device time by kernel (name, launches, "
        "ms): " + json.dumps([(e.key[:70], e.count, e.device_time_total / 1e3)
                             for e in top[:10]]))

    # the loss at the step's shape: the FF log-sum-exp over the vocabulary
    # and the FF token sum (plain torch, eager) against the f32 baseline's
    from repro_torch.core.policy import BASELINE, FF_REDUCE
    from repro_torch.models.model import cross_entropy
    logits = torch.randn((TRAIN_BATCH, TRAIN_SEQ, cfg.vocab_size),
                         device="cuda").bfloat16()
    targets = batches[0]["targets"]
    loss_ms = {name: host_ms(lambda pol=pol: float(
        cross_entropy(logits, targets, pol)), 3)
        for name, pol in (("ff_reduce", FF_REDUCE), ("baseline", BASELINE))}
    log(f"cross-entropy forward at ({TRAIN_BATCH}, {TRAIN_SEQ}, "
        f"{cfg.vocab_size}), host ms with sync: {json.dumps(loss_ms)}")
    del logits
    ff_math_launches = train_ff_math(
        torch, cfg, opt, params, state, batches[:FF_MATH_TRAIN_STEPS + 1],
        training["steady_step_ms"], peak_gb, card)
    return launches, ff_math_launches


# training of the families beyond dense GQA: the reduced configs card
# against CPU (2 steps of 2 x 16 tokens, f32, remat on; mamba2 also under
# ff_math), then FULL_TRAIN at full width (olmoe-1b-7b cut to 4 layers:
# its 16 need ~146 GB with FF-master AdamW)
SMALL_FAMILY_TRAIN = (("olmoe-1b-7b", {}, False),
                      ("deepseek-v2-236b", {}, False),
                      ("internvl2-1b", {}, False), ("mamba2-370m", {}, False),
                      ("mamba2-370m", {}, True),
                      ("jamba-1.5-large-398b", dict(num_layers=8), False),
                      ("whisper-medium", {}, False))
FULL_TRAIN_STEPS = 3
# (arch, config cut, batch, sequence): mamba2 over two SSD chunks
FULL_TRAIN = (("mamba2-370m", {}, 4, 512), ("whisper-medium", {}, 2, 128),
              ("internvl2-1b", {}, 4, 128),
              ("olmoe-1b-7b", dict(num_layers=4), 4, 128))


def family_batches(torch, cfg, batch, seq, n, device, seed):
    """``n`` batches of ``cfg``: SyntheticLM's tokens and targets, and the
    VLM's patches or the enc-dec's frames from a seeded normal draw on
    the CPU (the same on every device)."""
    out = train_batches(cfg.vocab_size, seq, batch, n, device)
    g = torch.Generator().manual_seed(seed)
    extra = {"vlm": ("patches", cfg.num_patches),
             "encdec": ("frames", cfg.encoder_seq)}.get(cfg.family)
    for b in out:
        if extra:
            b[extra[0]] = torch.randn((batch, extra[1], cfg.d_model),
                                      generator=g).to(device)
    return out


def train_launches_want(cfg, leaves, ff_math=False):
    """One training step's launches by the port's path: ``mean_sq`` at
    every norm with FF statistics (two a decoder-only or hybrid layer,
    one an ssm layer, two an encoder and three an enc-dec decoder layer,
    the final norm; the SSD's gated norm and the encoder's final norm are
    plain), the attention kernel at every attention call (a decoder-only
    layer's, the hybrid's one a period, the enc-dec's encoder, decoder and
    cross attention), each again in remat's recompute and neither in the
    backward (the attention's is the fast recurrence in plain torch);
    ``adamw_update`` once a leaf; ``ff_softmax`` once, the loss's
    log-sum-exp, where the vocabulary fits one fused row (the reduced
    configs' 512; the full ones' take the jnp formulation; the loss in
    one chunk here); under ``ff_math`` (the ssm family here)
    ``math_elementwise`` 7 times an SSD mixer a forward (softplus's exp
    and log1p, A's exp, the four decays; the backward of exp and log1p
    runs no FF function)."""
    from repro_torch.kernels.ff_fused import MAX_FUSED_COLS
    L, fam = cfg.num_layers, cfg.family
    if fam == "ssm":
        norms, attn, ssd = L, 0, L
    elif fam == "hybrid":
        periods = L // cfg.attn_every
        norms, attn, ssd = 2 * L, periods, L - periods
    elif fam == "encdec":
        norms, attn, ssd = 2 * cfg.encoder_layers + 3 * L, \
            cfg.encoder_layers + 2 * L, 0
    else:
        norms, attn, ssd = 2 * L, L, 0
    fwd = 2 if cfg.remat else 1
    return {"mean_sq": norms * fwd + 1, "attention": attn * fwd,
            "adamw_update": leaves,
            "ff_softmax": int(cfg.vocab_size <= MAX_FUSED_COLS),
            "ff_math": SSD_MATH_PREFILL * ssd * fwd if ff_math else 0}


def family_steps(torch, cfg, params, batches, ff_math=False):
    """``make_train_step`` (FF-master AdamW, ``policy("ff_reduce",
    attention="pallas")``, under ``ff_math`` with ``ff.use(**MATH_USE)``)
    over ``batches`` from ``params`` (updated in place).  Returns a record
    a step: loss, grad norm, wall ms and the kernels' launches."""
    import repro_torch.ff as ff
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train.train_step import make_train_step
    opt = AdamW(learning_rate=cosine_schedule(3e-4, 10, len(batches)))
    state = opt.init(params)
    with ff.policy("ff_reduce", attention="pallas", ff_math=ff_math):
        step = make_train_step(cfg, None, opt)
    recs, prev = [], launch_counts()
    with ff.use(**MATH_USE):
        for b in batches:
            t0 = time.perf_counter()
            params, state, m = step(params, state, b)
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            dt = time.perf_counter() - t0
            now = launch_counts()
            recs.append({"loss": loss, "grad_norm": gnorm,
                         "step_ms": dt * 1e3,
                         "launches": {k: now[k] - prev[k] for k in now}})
            prev = now
    return recs


def small_family_run(torch, case, dev):
    """SMALL_FAMILY_TRAIN[``case``] (f32 compute, remat on) trained 2
    steps of 2 x 16 tokens on ``dev`` from seeded weights
    (``family_steps``).  Returns the config, its leaf count and the
    steps' records."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    arch, extra, ff_math = SMALL_FAMILY_TRAIN[case]
    cfg = get_config(arch).reduced(compute_dtype="float32", remat=True,
                                   **extra)
    params = init_params(cfg, torch.Generator().manual_seed(SEED))
    batches = family_batches(torch, cfg, 2, 16, 2, dev, SEED + 21)
    return cfg, n_leaves(params), family_steps(
        torch, cfg, to_device(params, dev), batches, ff_math)


def small_family_training(torch, cpu):
    """SMALL_FAMILY_TRAIN: each reduced config trained on the card
    (``small_family_run``) against the same on the CPU (``cpu``: the
    runs' records there, where every kernel is its plain version): loss
    and grad norm within SMALL_TRAIN_RTOL a step, each card step's
    launches exactly ``train_launches_want``.  Returns the card runs'
    launches."""
    total = {}
    for case, (arch, _, ff_math) in enumerate(SMALL_FAMILY_TRAIN):
        cfg, leaves, card_recs = small_family_run(torch, case, "cuda")
        runs = {"cuda": card_recs, "cpu": cpu[case]}
        if len(runs["cpu"]) != len(card_recs):
            raise AssertionError(f"reduced {arch}: {len(runs['cpu'])} CPU "
                                 f"steps")
        want = {**{k: 0 for k in launch_counts()},
                **train_launches_want(cfg, leaves, ff_math)}
        name = f"{arch}{' ff_math' if ff_math else ''}"
        for i, (a, b) in enumerate(zip(runs["cuda"], runs["cpu"])):
            if a["launches"] != want:
                raise AssertionError(f"reduced {name} training step {i}: "
                                     f"launches {a['launches']} != {want}")
            for key in ("loss", "grad_norm"):
                x, y = a[key], b[key]
                if not abs(x - y) <= SMALL_TRAIN_RTOL * abs(y):
                    raise AssertionError(
                        f"reduced {name} training step {i}: {key} card "
                        f"{x!r} vs CPU {y!r}")
            for k, v in a["launches"].items():
                total[k] = total.get(k, 0) + v
        log(f"reduced {name} training (f32, remat, 2 x 16 tokens): card vs "
            f"CPU (loss, grad norm) per step "
            f"{[(a['loss'], a['grad_norm']) for a in runs['cuda']]} vs "
            f"{[(b['loss'], b['grad_norm']) for b in runs['cpu']]}; "
            f"launches a step { {k: v for k, v in want.items() if v} }")
    return total


def full_family_training(torch, card, arch, cut, batch, seq, seed):
    """``arch`` at full width (``cut``: the depth it is cut to), f32
    master weights from a seed, FULL_TRAIN_STEPS steps of ``batch`` x
    ``seq`` tokens (and the VLM's patches, the enc-dec's frames): finite
    losses and grad norms, each step's launches exactly
    ``train_launches_want``; logs step ms, tokens/s and the peak device
    memory.  Returns the launches of the run."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = dataclasses.replace(get_config(arch), **cut)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(seed))
    n_params = param_count(params)
    batches = family_batches(torch, cfg, batch, seq, FULL_TRAIN_STEPS,
                             "cuda", seed)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    recs = family_steps(torch, cfg, params, batches)
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {**{k: 0 for k in launches},
            **train_launches_want(cfg, n_leaves(params))}
    for i, r in enumerate(recs):
        if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                and r["launches"] == want):
            raise AssertionError(f"{arch} training step {i + 1}: loss "
                                 f"{r['loss']}, grad norm {r['grad_norm']}, "
                                 f"launches {r['launches']} != {want}")
    steady = [r["step_ms"] for r in recs[1:]]
    tokens = batch * seq
    rec = {"arch": arch, "cut": cut or "full size", "params": n_params,
           "batch": [batch, seq], "steps": FULL_TRAIN_STEPS,
           "loss": [r["loss"] for r in recs],
           "grad_norm": [r["grad_norm"] for r in recs],
           "step_ms": [r["step_ms"] for r in recs],
           "steady_step_ms": sum(steady) / len(steady),
           "steady_tokens_per_s": tokens / (sum(steady) / len(steady) / 1e3),
           "peak_allocated_gb": peak_gb, "setup_s": setup_s,
           "launches_per_step": {k: v for k, v in want.items() if v},
           "card": card}
    if cfg.family in ("vlm", "encdec"):
        rec["inputs_per_row"] = cfg.num_patches or cfg.encoder_seq
    if cfg.moe_num_experts:
        # the aux loss's compensated expert means at the step's shape (the
        # blocked FF sum, eager torch: a cascade of its 4096 lanes), once
        # a MoE layer a forward (olmoe: every layer) and again in remat's
        # recompute
        import repro_torch.ff as ff
        probs = torch.rand((batch * seq, cfg.moe_num_experts),
                           device="cuda")
        rec["moe_aux_sum_ms"] = host_ms(lambda: float(ff.sum(
            probs, axis=0, block=4096).hi[0]), 1)
        rec["moe_aux_sum_calls_per_step"] = \
            cfg.num_layers * (2 if cfg.remat else 1)
    log(f"family training: {json.dumps(rec)}")
    del params, batches
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_train_families(torch, card: str, cpu):
    """Training of the MoE, MLA, VLM, SSM, hybrid and enc-dec families:
    ``small_family_training`` (``cpu``: the CPU references); the hybrid's
    tuple tree through a checkpoint and a resumed step
    (``small_train_resume`` on reduced jamba); then FULL_TRAIN at full
    width (``full_family_training``).  Returns {path: launches}."""
    from repro_torch.configs import get_config
    reset_launch_counts()
    out = {"train_families_reduced": small_family_training(
        torch, cpu.get("family_training"))}
    small_train_resume(torch, get_config("jamba-1.5-large-398b").reduced(
        num_layers=8, compute_dtype="float32"))
    for i, (arch, cut, batch, seq) in enumerate(FULL_TRAIN):
        out[f"train_{arch.split('-')[0]}"] = full_family_training(
            torch, card, arch, cut, batch, seq, SEED + 31 + i)
    return out


def train_telemetry(torch, step, params, state, batches, pairs=3):
    """What the process-wide telemetry (dispatch resolutions, tune
    lookups into ``obs.REGISTRY``) costs a full-width training step: one
    step's registry calls counted (:class:`ObsCallCounter`) and replayed
    for host us, then ``pairs`` steps with the hooks off (``obs.record`` a
    no-op) alternated with as many with them on, host clock with sync.
    Returns the numbers and the state after the steps."""
    import statistics
    from repro_torch import obs

    def timed(i):
        nonlocal params, state
        t0 = time.perf_counter()
        params, state, m = step(params, state, batches[i % TRAIN_STEPS])
        loss = float(m["loss"])
        torch.cuda.synchronize()
        if not math.isfinite(loss):
            raise AssertionError(f"telemetry step: loss {loss}")
        return (time.perf_counter() - t0) * 1e3
    with ObsCallCounter() as counter:
        timed(0)
    n_reg, n_trace = counter.counts()
    replay_us = counter.host_us(reps=20)
    arms = {"off": [], "on": []}
    saved = obs.record
    for i in range(2 * pairs):
        arm = ("off", "on")[i % 2]
        if arm == "off":
            obs.record = lambda *a: None
        try:
            arms[arm].append(timed(i + 1))
        finally:
            obs.record = saved
    res = {"registry_calls": n_reg, "trace_calls": n_trace,
           "replay_host_ms": replay_us / 1e3,
           "step_ms_hooks_off": arms["off"], "step_ms_hooks_on": arms["on"],
           "median_on_minus_off_ms": statistics.median(arms["on"])
           - statistics.median(arms["off"])}
    log(f"telemetry in one full-width training step: {json.dumps(res)}")
    res.update(params=params, state=state)
    return res


def train_ff_math(torch, cfg, opt, params, state, batches, plain_ms,
                  plain_peak_gb, card):
    """FF_MATH_TRAIN_STEPS more steps of 4 x 128 tokens on the plain
    steps' ``params`` and ``state`` (a second copy of the model and its FF
    AdamW state would not fit beside them), from a step function built
    under ``policy("ff_reduce", attention="pallas", ff_math=True)`` and
    run under ``ff.use(silu="pallas")``: the FF silu gate in every layer.
    Each step launches ``ff_math`` 3 times a layer (the forward, remat's
    recompute, and ``sigmoid22`` in the gate's backward) and every other
    kernel as the plain step does; finite loss and grad norm.  Then one
    more step (the last batch) under ``torch.profiler``."""
    import repro_torch.ff as ff
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.train.train_step import make_train_step
    *batches, profiled_batch = batches
    with ff.policy("ff_reduce", attention="pallas", ff_math=True), \
            ff.use(silu="pallas"):
        step = make_train_step(cfg, None, opt)
    L, tokens = cfg.num_layers, TRAIN_BATCH * TRAIN_SEQ
    if not cfg.remat:
        raise AssertionError("granite-3-2b trains with remat")
    want = {**{k: 0 for k in launch_fns()},
            "mean_sq": 2 * L + 1 + 2 * L, "attention": 2 * L,
            "adamw_update": n_leaves(params), "ff_math": 3 * L}
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    prev, recs = launch_counts(), []
    with ff.use(silu="pallas"):
        for i, batch in enumerate(batches):
            t0 = time.perf_counter()
            params, state, m = step(params, state, batch)
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            now = launch_counts()
            rec = {"step": i + 1, "loss": loss, "grad_norm": gnorm,
                   "step_ms": dt * 1e3, "tokens_per_s": tokens / dt,
                   "launches": {k: now[k] - prev[k] for k in now}}
            prev = now
            log(f"train step (ff_math, silu=pallas): {json.dumps(rec)}")
            if not (math.isfinite(loss) and math.isfinite(gnorm)):
                raise AssertionError(f"ff_math training step {i + 1}: loss "
                                     f"{loss}, grad norm {gnorm}")
            if rec["launches"] != want:
                raise AssertionError(f"ff_math training step {i + 1}: "
                                     f"launches {rec['launches']} != {want}")
            recs.append(rec)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof, \
            ff.use(silu="pallas"):
        t0 = time.perf_counter()
        params, state, m = step(params, state, profiled_batch)
        float(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n_ops, busy = device_busy_us(prof)
    steady = [r["step_ms"] for r in recs[1:]]
    summary = {"steps": len(recs), "tokens_per_step": tokens,
               "step_ms": [r["step_ms"] for r in recs],
               "steady_step_ms": sum(steady) / len(steady),
               "plain_steady_step_ms": plain_ms,
               "peak_allocated_gb": peak_gb,
               "plain_peak_allocated_gb": plain_peak_gb,
               "ff_math_launches_per_step": want["ff_math"],
               "profiled_step": {"device_ops": n_ops,
                                 "device_busy_ms": busy / 1e3,
                                 "step_wall_ms": wall * 1e3},
               "card": card}
    log(f"training under ff_math: {json.dumps(summary)}")
    top = sorted(prof.key_averages(), key=lambda e: -e.device_time_total)
    log("profiled ff_math training step, device time by kernel (name, "
        "launches, ms): " + json.dumps([(e.key[:70], e.count,
                                         e.device_time_total / 1e3)
                                        for e in top[:12]]))
    return launches


def host_ms(fn, iters: int) -> float:
    """Mean host time of ``fn()`` (which ends in a sync) over ``iters``
    calls, after one warm-up call."""
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def n_leaves(tree) -> int:
    from repro_torch.tree import tree_leaves
    return len(tree_leaves(tree))


def param_count(tree) -> int:
    from repro_torch.tree import tree_leaves
    return sum(t.numel() for t in tree_leaves(tree))


def phase_timing(torch, cfg, launches, errs, clock_hz):
    """``launches``: {path: {kernel: launches}} from the main paths' runs;
    each kernel's ``launches`` is their sum."""
    from repro_torch.kernels import ff_attention, ff_fused
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    peak_ops = F32_LANES * clock_hz
    kernels = []

    def counts(name):
        return path_counts(launches, name)

    # mean_sq at the decode shape (max_batch rows of d_model)
    rows, cols = 4, cfg.d_model
    x = torch.randn((rows, cols), generator=g, device="cuda")
    ops = rows * (cols * (1 + CASCADE) + 128 * LANE_FOLD + 1)
    byts = rows * cols * 4 + rows * 4
    kernels.append(dict(
        name="mean_sq", route="cuda", source="src/repro_torch/csrc/"
        "ff_mean_sq.cu", replaces="src/repro/kernels/ff_fused.py:188",
        **counts("mean_sq"), max_abs_err=errs["mean_sq"],
        ms=graph_ms(lambda: ff_fused.mean_sq(x), 500),
        call_ms=cuda_ms(lambda: ff_fused.mean_sq(x), 500),
        plain_ms=cuda_ms(lambda: ff_fused.mean_sq_plain(x), 5),
        bound_ms=1e3 * max(byts / HBM_BYTES_PER_S, ops / peak_ops),
        bound_by="bytes" if byts / HBM_BYTES_PER_S >= ops / peak_ops
        else "operations",
        library_ms=graph_ms(lambda: torch.linalg.vecdot(x, x) / cols, 500),
        shape=[rows, cols]))

    # attention at the prefill, training and long-step shapes
    S, H, KV, hd = PROMPT_LENS[1], cfg.num_heads, cfg.num_kv_heads, \
        cfg.resolved_head_dim
    kernels.append(attention_timing(torch, g, cfg, counts("attention"),
                                    errs["attention"], peak_ops))
    # per-call times of the decode step's pieces at its shapes (plain
    # torch) and of mean_sq at the longest prefill's shape
    from repro_torch.core.policy import FF_REDUCE
    from repro_torch.train.serve_step import token_logprob, token_logprob_ff
    qd = torch.randn((4, 1, H, hd), generator=g, device="cuda").bfloat16()
    kvd = torch.randn((4, 128, KV, hd), generator=g,
                      device="cuda").bfloat16()
    kvl = torch.tensor([17, 64, 100, 128], dtype=torch.int32, device="cuda")
    logits = torch.randn((4, cfg.vocab_size), generator=g,
                         device="cuda").bfloat16()
    tok = logits.argmax(-1)
    xp = torch.randn((S, cfg.d_model), generator=g, device="cuda")
    # the training step's shapes: (B*S, d) rows of the norms; B x S causal
    xt = torch.randn((TRAIN_BATCH * TRAIN_SEQ, cfg.d_model), generator=g,
                     device="cuda")
    qt4 = torch.randn((TRAIN_BATCH, TRAIN_SEQ, H, hd), generator=g,
                      device="cuda").bfloat16()
    kt4 = torch.randn((TRAIN_BATCH, TRAIN_SEQ, KV, hd), generator=g,
                      device="cuda").bfloat16()
    xl = torch.randn((LONG_BATCH * LONG_SEQ, cfg.d_model), generator=g,
                     device="cuda")
    ql = torch.randn((LONG_BATCH, LONG_SEQ, H, hd), generator=g,
                     device="cuda").bfloat16()
    kl = torch.randn((LONG_BATCH, LONG_SEQ, KV, hd), generator=g,
                     device="cuda").bfloat16()
    pieces = {
        "ff_attention_decode_ms": cuda_ms(
            lambda: ff_attention.flash_attention_ff(
                qd, kvd, kvd, causal=False, kv_len=kvl), 2),
        "token_logprob_ms": cuda_ms(
            lambda: token_logprob(logits, tok, FF_REDUCE), 3),
        "token_logprob_ff_ms": cuda_ms(
            lambda: token_logprob_ff(logits, tok), 3),
        "mean_sq_prefill_shape_ms": graph_ms(lambda: ff_fused.mean_sq(xp),
                                             500),
        "mean_sq_train_shape_ms": graph_ms(lambda: ff_fused.mean_sq(xt),
                                           200),
        "attention_train_shape_ms": graph_ms(
            lambda: ff_attention.flash_attention_pallas(
                qt4, kt4, kt4, causal=True), 20),
        "mean_sq_long_step_shape_ms": graph_ms(lambda: ff_fused.mean_sq(xl),
                                               100),
        "attention_long_step_shape_ms": graph_ms(
            lambda: ff_attention.flash_attention_pallas(
                ql, kl, kl, causal=True), 5),
    }
    log(f"decode-step and training-step pieces: {json.dumps(pieces)}")
    del xt, qt4, kt4, xl, ql, kl, qd, kvd, logits
    kernels.append(adamw_timing(torch, cfg, g, counts("adamw_update"),
                                errs["adamw_update"], peak_ops))
    for kd in kernels:
        log(f"{kd['name']}: kernel {kd['ms']:.4f} ms (one call from "
            f"Python {kd['call_ms']:.4f} ms), plain "
            f"{kd['plain_ms']:.3f} ms, bound {kd['bound_ms']:.5f} ms "
            f"({kd['bound_by']}), library {kd['library_ms']}")
    return kernels


def attention_timing(torch, g, cfg, counts, err, peak_ops):
    """The attention kernel at the shapes of its launches on the main
    paths: the prefill of the longest prompt (1, 64), a training step (4,
    128) and the long step (2, 1024) at granite-3-2b's heads; the
    head-dim 128 and 192 instances at olmoe-1b-7b's prefill (4, 32; 16
    MHA heads), minitron-4b's (1, 32; 24 / 8), phi3-medium's heads (1,
    32; 40 / 10) and deepseek-v2's MLA prefill (2, 32; 128 heads at 192),
    causal; whisper-medium's encoder (2, 1500 over 1500 frames, 16 MHA
    heads at 64) and cross attention (2, 32 over 1500), non-causal; bf16.
    Kernel ms by CUDA-graph replay, one call's ms, the bound
    (``attention_ops``), SDPA's ms (bf16 attention: another function, a
    yardstick of speed only); the plain version at the prefill shape only
    (it takes seconds beyond).  The entry's numbers are the prefill
    shape's, every shape under ``by_shape``."""
    import torch.nn.functional as F
    from repro_torch.kernels import ff_attention
    g_heads = (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim)
    rows = []
    wh = (16, 16, 64)
    for what, B, S, Skv, (H, KV, hd), causal, iters in (
            ("prefill", 1, PROMPT_LENS[1], PROMPT_LENS[1], g_heads, True,
             50),
            ("train", TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, g_heads, True, 20),
            ("long step", LONG_BATCH, LONG_SEQ, LONG_SEQ, g_heads, True, 3),
            ("olmoe prefill", 4, FAM_PROMPT, FAM_PROMPT, (16, 16, 128), True,
             20),
            ("minitron prefill", 1, FAM_PROMPT, FAM_PROMPT, (24, 8, 128),
             True, 20),
            ("phi3 heads", 1, FAM_PROMPT, FAM_PROMPT, (40, 10, 128), True,
             20),
            ("MLA prefill", MLA_BATCH, FAM_PROMPT, FAM_PROMPT,
             (128, 128, 192), True, 10),
            ("whisper encoder", WHISPER_REQUESTS, 1500, 1500, wh, False, 3),
            ("whisper cross", WHISPER_REQUESTS, WHISPER_PROMPT, 1500, wh,
             False, 20)):
        sc = float(torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32))
        q = torch.randn((B, S, H, hd), generator=g,
                        device="cuda").bfloat16()
        k = torch.randn((B, Skv, KV, hd), generator=g,
                        device="cuda").bfloat16()
        v = torch.randn((B, Skv, KV, hd), generator=g,
                        device="cuda").bfloat16()
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def call():
            return ff_attention.flash_attention_pallas(
                q, k, v, causal=causal, return_ff=True)

        plain = cuda_ms(lambda: ff_attention.flash_attention_ff(
            q, k, v, causal=True, return_ff=True), 3) \
            if what == "prefill" else None
        row = dict(shape=[B, S, H, hd, KV] + ([] if Skv == S else [Skv]),
                   what=what, causal=causal, **time_kernel(
                       call, call, plain,
                       lambda: F.scaled_dot_product_attention(
                           qt, kt, vt, is_causal=causal, enable_gqa=True),
                       2 * (q.numel() + k.numel() + v.numel())
                       + 2 * 4 * q.numel(),
                       attention_ops(B, S, Skv, H, hd, causal, True, sc),
                       peak_ops, iters))
        row["plan"] = list(ff_attention.flash_attention_pallas.last_plan)
        rows.append(row)
        log(f"ff_flash_attention {what} {row['shape']} (plan "
            f"{row['plan']}): kernel {row['ms']:.4f} ms (call "
            f"{row['call_ms']:.4f}), plain {row['plain_ms']}, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}, "
            f"{row['bound_ms'] / row['ms']:.1%}), SDPA "
            f"{row['library_ms']:.4f} ms")
        del q, k, v, qt, kt, vt
    return dict(name="ff_flash_attention", route="cuda",
                source="src/repro_torch/csrc/ff_attention.cu",
                replaces="src/repro/kernels/ff_attention.py:425", **counts,
                max_abs_err=err, **{k: rows[0][k] for k in (
                    "ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "shape")}, by_shape=rows)


def adamw_timing(torch, cfg, g, counts, err, peak_ops):
    """The AdamW kernel at the largest leaf, w_gate (L x d x d_ff), in
    place as the optimizer runs it; its plain version at one layer's
    slice (2048 x 8192: the full leaf's ~10 temporaries would not fit
    beside the kernel's leaves); PyTorch's fused f32 AdamW on the same
    leaf as the yardstick."""
    from repro_torch.kernels import ff_fused
    shape = (cfg.num_layers, cfg.d_model, cfg.d_ff)
    n = math.prod(shape)
    scal = [torch.tensor(x, device="cuda") for x in ADAMW_SCALARS]
    gr, m, v, w, wlo = adamw_leaves(torch, g, shape)

    def step():
        ff_fused.adamw_update(gr, m, v, w, wlo, *scal, eps=ADAMW_EPS,
                              wd=ADAMW_WD)

    ms, call_ms = graph_ms(step, 10), cuda_ms(step, 10)
    path = ff_fused.adamw_update.last_path
    log(f"adamw_update timed call {list(shape)}: the {path} path")
    if path != "vector":
        raise AssertionError(f"adamw_update at {shape}: the {path} path, "
                             f"not the 16-byte one")
    byts, ops = n * ADAMW_BYTES, n * ADAMW_OPS
    sl = [t[0].clone() for t in (gr, m, v, w, wlo)]
    plain_ms = cuda_ms(lambda: ff_fused.adamw_update_plain(
        *sl, *scal, eps=ADAMW_EPS, wd=ADAMW_WD), 5)
    del gr, m, v, wlo, sl
    p = torch.nn.Parameter(w)
    p.grad = torch.randn(shape, generator=g, device="cuda")
    lib = torch.optim.AdamW([p], lr=ADAMW_SCALARS[0], betas=ADAMW_SCALARS[1:3],
                            eps=ADAMW_EPS, weight_decay=ADAMW_WD, fused=True)
    library_ms = cuda_ms(lib.step, 10)
    del lib, p, w
    return dict(
        name="ff_adamw", route="cuda",
        source="src/repro_torch/csrc/ff_adamw.cu",
        replaces="src/repro/kernels/ff_fused.py:188", **counts,
        max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
        plain_shape=[cfg.d_model, cfg.d_ff],
        bound_ms=1e3 * max(byts / HBM_BYTES_PER_S, ops / peak_ops),
        bound_by="bytes" if byts / HBM_BYTES_PER_S >= ops / peak_ops
        else "operations", library_ms=library_ms, shape=list(shape),
        path=path)


# ---------------------------------------------------------------------------
# the CPU halves of the card-against-CPU checks, in a child process
# ---------------------------------------------------------------------------

CPU_REF_ARG = "--cpu-references"
CPU_REF_THREADS = 4                     # of the host's cores
CPU_REF_TIMEOUT = 900                   # seconds the script waits for them


def cpu_references(out: str) -> int:
    """``python3 chip_smoke.py --cpu-references OUT``: the CPU halves of
    ``small_families``, ``phase_chaos`` and ``small_family_training``
    (every kernel its plain version), saved to ``OUT`` with
    ``torch.save``, with the seconds they took."""
    t0 = time.perf_counter()
    sys.path.insert(0, str(SRC))
    os.nice(5)                          # the card's phases come first
    import torch
    torch.set_num_threads(CPU_REF_THREADS)
    res = {"families": [small_family_generate(torch, i, "cpu")[0]
                        for i in range(len(SMALL_FAMILY_CASES))],
           "chaos": chaos_run("cpu"),
           "family_training": [
               [{k: r[k] for k in ("loss", "grad_norm")}
                for r in small_family_run(torch, i, "cpu")[2]]
               for i in range(len(SMALL_FAMILY_TRAIN))]}
    res["seconds"] = time.perf_counter() - t0
    torch.save(res, out)
    return 0


class CpuReferences:
    """``cpu_references`` in a child process that sees no card, started
    after the build so that it runs beside the card's phases; ``get``
    waits for it (at most CPU_REF_TIMEOUT s) and returns one part of its
    results, ``stop`` kills it if it still runs."""

    def __init__(self, directory: str):
        self.path = os.path.join(directory, "cpu_references.pt")
        self.log_path = os.path.join(directory, "cpu_references.log")
        self.proc, self.results = None, None

    def start(self):
        with open(self.log_path, "w") as out:
            self.proc = subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), CPU_REF_ARG,
                 self.path], cwd=str(ROOT), stdout=out,
                stderr=subprocess.STDOUT,
                env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})

    def get(self, part: str):
        if self.results is None:
            import torch
            t0 = time.perf_counter()
            code = self.proc.wait(timeout=CPU_REF_TIMEOUT)
            if code != 0:
                raise AssertionError(
                    f"the CPU references exited {code}:\n"
                    + Path(self.log_path).read_text()[-4000:])
            self.results = torch.load(self.path, weights_only=False)
            log(f"CPU references: {self.results['seconds']:.1f} s in a "
                f"child process beside the card's phases; waited "
                f"{time.perf_counter() - t0:.1f} s for them")
        return self.results[part]

    def stop(self):
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found: run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on "
              "the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    with tempfile.TemporaryDirectory() as tmp:
        cpu = CpuReferences(tmp)
        try:
            return run_phases(torch, cpu)
        finally:
            cpu.stop()


def run_phases(torch, cpu: CpuReferences) -> int:
    global T0
    T0 = time.perf_counter()
    marks = [("start", T0)]

    def mark(name):                      # a phase ends: its wall seconds
        marks.append((name, time.perf_counter()))

    card = nvidia_smi("name,power.limit")
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    log(f"card: {card}; max SM clock {clock_mhz:.0f} MHz")
    phase_build(torch)
    mark("build")
    cpu.start()
    errs = phase_kernel_checks(torch)
    mark("kernel checks")
    matmul_launches, matmul_worst, matmul_rows = phase_matmul(
        torch, clock_mhz * 1e6)
    mark("matmul")
    table_launches, fused_worst, fused_rows = phase_fused(torch,
                                                          clock_mhz * 1e6)
    mark("fused")
    tune_launches, default_launches, ops_worst, ops_rows = phase_ops(
        torch, clock_mhz * 1e6)
    mark("operators and math")
    from repro_torch.configs.granite_3_2b import CONFIG
    guard_err = phase_guard_checks(torch, CONFIG)
    phase_grad_checks(torch, CONFIG)
    gc.collect()
    torch.cuda.empty_cache()
    phase_small_engine(torch)
    mark("guard checks, small engine")
    serve_launches, cfg, eng = phase_serve(torch, card)
    durable_launches = phase_serve_durable(torch, eng, cfg, card)
    gc.collect()
    torch.cuda.empty_cache()
    ff_math_launches = phase_serve_ff_math(torch, eng.params, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    guard_launches = phase_serve_guard(torch, eng.params, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    phase_decode_profile(torch, eng, cfg)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    log(f"serving engine freed: {torch.cuda.memory_allocated() / 1e9:.2f} "
        f"GB still allocated")
    mark("serving")
    family_launches = phase_families(torch, card, cpu)
    mark("families")
    chaos_launches = phase_chaos(torch, cpu.get("chaos"))
    phase_restart_chaos(torch)
    mark("chaos")
    phase_small_train(torch)
    train_launches, train_ff_math_launches = phase_train(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    mark("training")
    train_family_launches = phase_train_families(torch, card, cpu)
    mark("family training")
    launches = {"serve": serve_launches, "train": train_launches,
                "matmul": matmul_launches, "table": table_launches,
                "tune": tune_launches, "default_calls": default_launches,
                "serve_ff_math": ff_math_launches,
                "serve_guard": guard_launches,
                "train_ff_math": train_ff_math_launches,
                "serve_durable": durable_launches, "chaos": chaos_launches,
                **family_launches, **train_family_launches}
    kernels = (phase_timing(torch, cfg, launches, errs, clock_mhz * 1e6)
               + matmul_kernel_entries(launches, matmul_worst, matmul_rows)
               + fused_kernel_entries(launches, fused_worst, fused_rows)
               + ops_kernel_entries(launches, ops_worst, ops_rows)
               + [guard_timing(torch, cfg, path_counts(launches, "ff_guard"),
                               guard_err, clock_mhz * 1e6)])
    mark("timing")
    log("phase seconds: " + ", ".join(
        f"{name} {t - t0:.1f}" for (_, t0), (name, t) in zip(marks,
                                                            marks[1:])))
    if len(kernels) != len(launch_fns()):
        raise AssertionError(f"{len(kernels)} kernel entries")
    log(f"chip_smoke: {time.perf_counter() - T0:.1f} s in all")
    torch.cuda.synchronize()
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(cpu_references(sys.argv[2]) if sys.argv[1:2] == [CPU_REF_ARG]
             else main())
