#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failed check raises, so the script exits non-zero):

  1. card and build: the card's name and power limit, the torch/CUDA
     versions, and the kernels built from ``src/repro_torch/csrc`` (into
     ``build/``, one ``nvcc`` per source, all at once);
  2. kernel checks: each kernel against its plain PyTorch version on the
     card, at the shapes the serving and training paths give it among
     others — ``mean_sq`` to <= 1 ulp, FF attention (and its plain
     version) to <= 2^-40 of a float64 oracle on the card, the AdamW
     update, in place as the optimizer runs it on whole leaves (``tok``,
     ``w_gate``), to 0 ulp on all four outputs;
  3. serving: a reduced granite-3-2b engine on the card against the same
     engine on the CPU (plain versions), then granite-3-2b at full width
     (random weights from a seed) serving 8 requests under
     ``policy("ff_reduce", attention="pallas")``, with the kernels' launch
     counts read around that run; then one more decode step with every
     row full under ``torch.profiler``, for the device-busy share;
  4. training: a reduced granite-3-2b trained 2 steps on the card against
     the same on the CPU (plain versions), with the whole loss and with
     the sequence-chunked loss; then, with the serving engine freed,
     granite-3-2b at full width (random weights from a seed) trained 4
     steps on ``SyntheticLM`` batches of 4 x 128 tokens and one step on
     2 x 1024 tokens (longer than ``loss_chunk``: the chunked loss) with
     FF-master-weight AdamW under ``policy("ff_reduce",
     attention="pallas")``, with the kernels' launch counts read around
     those steps; then one more step under ``torch.profiler``;
  5. timing: each kernel, its plain version and a PyTorch yardstick with
     CUDA events at the main paths' shapes, beside its bound.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA card, or
outside a checkout, the script exits non-zero and prints no result.
"""

import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
SEED = 0
FULL_REQUESTS, MAX_NEW = 8, 16
PROMPT_LENS = (16, 64)

# f32 instruction counts of the kernels' device functions (csrc/ff_eft.cuh;
# each add, subtract, multiply, divide, min/max, convert or select is one)
TWO_SUM, FAST_TWO_SUM, SPLIT, TWO_PROD = 6, 3, 3, 17
ADD212 = TWO_SUM + 1 + FAST_TWO_SUM                      # 10
MUL212 = TWO_PROD + 2 + FAST_TWO_SUM                     # 22
ADD22 = TWO_SUM + 2 + FAST_TWO_SUM                       # 11
MUL22 = TWO_PROD + 4 + FAST_TWO_SUM                      # 24
DIV22 = 1 + TWO_PROD + 5 + 1 + FAST_TWO_SUM              # 27
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
LONG_BATCH, LONG_SEQ = 2, 1024           # S > loss_chunk: the chunked loss
ADAMW_SLICE = 2048 * 8192                # one layer of w_gate
# card against CPU, f32 compute: the summation orders of the matrix
# products and the kernels' (<= 1 ulp, <= 2^-40) differ from the plain
# versions'; tests/test_torch_train.py holds the port to the reference
# at the same tolerance
SMALL_TRAIN_RTOL = 1e-5

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 peak memory rate
F32_LANES = 132 * 128            # SMs x f32 lanes; one instruction / cycle


def attention_ops(B, Sq, Skv, H, hd, causal, bf16, scale) -> int:
    """f32 instructions that FF attention needs on these inputs: the
    reference's op sequence over the unmasked pairs only, with every op
    whose result the operands' type fixes left out.  A bf16 x bf16 product
    is exact in f32 (16 significant bits), so a score term is 1 multiply
    with no low part; a bf16 v splits into (v, 0), so TwoProd(p, v) keeps
    5 of its 17 instructions; a power-of-two scale is exact, so Mul212 by
    it is 2 multiplies.  Splits of loop-invariant operands are counted
    once, and the running max is taken first, so no tile is rescaled."""
    if causal:
        pairs = sum(min(Skv, i + 1) for i in range(Sq))
    else:
        pairs = Sq * Skv
    pairs *= B * H
    if bf16:
        score_d = 1 + CASCADE                            # exact product
        pv_d = 5 + 2 + CASCADE + 1                       # split(v) = (v, 0)
        hoisted = 0
    else:
        score_d = TWO_PROD - 2 * SPLIT + CASCADE + 1     # q, k splits hoisted
        pv_d = TWO_PROD - 2 * SPLIT + 2 + CASCADE + 1    # v split hoisted
        hoisted = SPLIT * hd * (B * Sq * H + B * Skv * H)
    exact_scale = math.frexp(scale)[0] == 0.5
    per_pair = (hd * score_d + FF_FOLD + (2 if exact_scale else MUL212 - SPLIT)
                + 1 + ADD212 + EXP22          # max, shift, weight
                + 2 * CASCADE                 # denominator over both limbs
                + SPLIT + hd * pv_d)          # split(p.hi) once for all d
    per_cell = FF_FOLD + DIV22                # numerator fold, Div22
    per_row = LANE_FOLD                       # denominator fold
    return (pairs * per_pair + B * Sq * H * (hd * per_cell + per_row)
            + hoisted)


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


def ff64(pair):
    return pair.hi.double() + pair.lo.double()


def attention_oracle(q, k, v, causal: bool):
    """float64 softmax attention on the card, scaled by the f32-rounded
    1/sqrt(hd) as the reference's attention_f64 (an exact f64 scale is
    itself ~2^-26 off what the FF tiers compute)."""
    import torch
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    sc = float(torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32))
    q64 = q.double().reshape(B, Sq, KV, G, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", q64, k.double()) * sc
    if causal:
        mask = torch.ones(Sq, Skv, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bkgqd", p, v.double())
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)


def rel_err(got, want) -> float:
    den = want.abs().amax(dim=(1, 3), keepdim=True)
    return float(((got - want).abs() / den).max())


def adamw_leaves(torch, g, shape):
    """g, m, v, w, wlo on the card: the moments and the master weight's
    low limb at their typical scales (tests/test_fusion.py)."""
    mk = lambda sc=1.0: torch.randn(shape, generator=g,  # noqa: E731
                                    device="cuda") * sc
    return mk(), mk(0.1), mk(0.01).abs(), mk(), mk(1e-8)


def adamw_check(torch, g, shape, scal) -> float:
    """The AdamW kernel in place on one leaf, against the plain version on
    copies of the inputs taken before it ran, slice by slice (one layer of
    w_gate at most, where the plain version's temporaries fit): 0 ulp on
    w, wlo, m and v; g unchanged.  Returns the largest absolute error."""
    from repro_torch.kernels import ff_fused
    leaves = adamw_leaves(torch, g, shape)            # g, m, v, w, wlo
    before = [t.clone() for t in leaves]
    ff_fused.adamw_update(*leaves, *scal, eps=ADAMW_EPS, wd=ADAMW_WD)
    torch.cuda.synchronize()
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
    log(f"adamw_update {shape} in place: kernel vs plain {worst_u} ulp "
        f"(w, wlo, m, v; {math.ceil(n / ADAMW_SLICE)} slices)")
    if worst_u != 0:
        raise AssertionError(f"adamw_update kernel {worst_u} ulp from "
                             f"plain at {shape} (limit 0)")
    return worst_abs


def ulp_diff(a, b) -> int:
    import torch
    ia = a.contiguous().view(torch.int32).long()
    ib = b.contiguous().view(torch.int32).long()
    return int((ia - ib).abs().max())


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


def phase_kernel_checks(torch):
    from repro_torch.kernels import ff_attention, ff_fused
    g = torch.Generator(device="cuda").manual_seed(SEED)
    checks = {}
    worst_ulp, worst_abs = 0, 0.0
    # decode rows, prefill rows, training rows (4 x 128, 2 x 1024), odd
    for shape in ((4, 2048), (64, 2048), (512, 2048), (2048, 2048),
                  (3, 1000)):
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

    worst_abs = 0.0
    for (B, Sq, Skv, H, KV, hd, causal, dt) in (
            # the prefill shape, the training shapes (4 x 128, 2 x 1024)
            (1, 64, 64, 32, 8, 64, True, torch.bfloat16),
            (4, 128, 128, 32, 8, 64, True, torch.bfloat16),
            (LONG_BATCH, LONG_SEQ, LONG_SEQ, 32, 8, 64, True, torch.bfloat16),
            (2, 4, 768, 2, 1, 32, False, torch.float32),
            # ragged tiles: partial q tiles and a partial last K/V tile
            (1, 37, 37, 4, 2, 64, True, torch.float32),
            (2, 50, 130, 4, 1, 32, False, torch.bfloat16)):
        q = torch.randn((B, Sq, H, hd), generator=g, device="cuda").to(dt)
        k = torch.randn((B, Skv, KV, hd), generator=g, device="cuda").to(dt)
        v = torch.randn((B, Skv, KV, hd), generator=g, device="cuda").to(dt)
        got = ff64(ff_attention.flash_attention_pallas(
            q, k, v, causal=causal, return_ff=True))
        plain = ff64(ff_attention.flash_attention_ff(
            q, k, v, causal=causal, return_ff=True))
        want = attention_oracle(q, k, v, causal)
        e_k, e_p = rel_err(got, want), rel_err(plain, want)
        worst_abs = max(worst_abs, float((got - plain).abs().max()))
        log(f"attention q{(B, Sq, H, hd)} Skv={Skv} KV={KV} causal={causal} "
            f"{str(dt)[6:]}: kernel 2^{math.log2(max(e_k, 1e-300)):.1f}, "
            f"plain 2^{math.log2(max(e_p, 1e-300)):.1f} vs float64")
        if not (e_k <= 2.0 ** -40 and e_p <= 2.0 ** -40):
            raise AssertionError(f"attention error kernel {e_k:.3e}, plain "
                                 f"{e_p:.3e} > 2^-40")
    checks["attention"] = worst_abs

    worst_abs = 0.0
    scal = [torch.tensor(x, device="cuda") for x in ADAMW_SCALARS]
    # odd sizes, and the leaves tok (vocab x d) and w_gate (L x d x d_ff)
    # whole, as the optimizer updates them
    for shape in ((33, 257), (1_000_003,), (49155, 2048), (40, 2048, 8192)):
        worst_abs = max(worst_abs, adamw_check(torch, g, shape, scal))
    checks["adamw_update"] = worst_abs
    return checks


def serve_requests(rng, vocab: int):
    import numpy as np
    from repro_torch.serve import Request
    lens = rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1,
                        size=FULL_REQUESTS)
    return [Request(uid=i, prompt=rng.integers(1, vocab, size=int(n))
                    .astype(np.int32), max_new=MAX_NEW)
            for i, n in enumerate(lens)]


def to_device(tree, device):
    """A copy of a nested dict of tensors on ``device``."""
    return {k: to_device(v, device) if isinstance(v, dict)
            else v.to(device, copy=True) for k, v in tree.items()}


def phase_small_engine(torch):
    """A reduced granite engine (f32 compute) on the card against the same
    engine on the CPU, where every kernel is its plain version."""
    import numpy as np
    import repro_torch.ff as ff
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


def phase_serve(torch, card: str):
    import numpy as np
    import repro_torch.ff as ff
    from repro_torch.configs.granite_3_2b import CONFIG as cfg
    from repro_torch.kernels import ff_attention, ff_fused
    from repro_torch.models import init_params
    from repro_torch.serve import ServeEngine
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda")
                         .manual_seed(SEED))
    n_params = sum(t.numel() for t in _leaves(params))
    with ff.policy("ff_reduce", attention="pallas"):
        eng = ServeEngine(params, cfg, max_batch=4, page_size=16,
                          max_ctx=128)
    torch.cuda.synchronize()
    log(f"granite-3-2b: {n_params / 1e9:.3f} B params (f32) + bf16 copy, "
        f"set up in {time.perf_counter() - t0:.1f} s")
    reqs = serve_requests(np.random.default_rng(SEED), cfg.vocab_size)

    ff_fused.mean_sq.launches = 0
    ff_attention.flash_attention_pallas.launches = 0
    t0 = time.perf_counter()
    for r in reqs:
        if eng.submit(r) != "QUEUED":
            raise AssertionError(f"request {r.uid} not queued")
    res = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"mean_sq": ff_fused.mean_sq.launches,
                "attention": ff_attention.flash_attention_pallas.launches}

    n_pf, n_dec = len(eng.prefill_s), eng.decode_steps
    norms = 2 * cfg.num_layers + 1
    want = {"mean_sq": norms * (n_pf + n_dec),
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
    serving = {"requests": len(reqs), "tokens": n_tok,
               "tokens_per_s": n_tok / wall,
               "decode_step_ms": 1e3 * float(np.mean(eng.decode_s)),
               "prefill_ms": 1e3 * float(np.mean(eng.prefill_s)),
               "decode_steps": n_dec, "wall_s": wall, "card": card}
    log(f"serving: {json.dumps(serving)}")
    return launches, cfg, eng


def device_busy_us(prof):
    """(device operations, the union of their intervals in us) that
    ``torch.profiler`` recorded."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return len(spans), busy


def phase_decode_profile(torch, eng, cfg):
    """Device-busy share of one decode step with every row full: the union
    of the device intervals that torch.profiler records in the step, over
    the step's wall time on the host clock."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import Request
    unprofiled_ms = 1e3 * float(np.mean(eng.decode_s))   # the served run
    rng = np.random.default_rng(SEED + 2)
    for i in range(eng.max_batch):
        eng.submit(Request(uid=1000 + i, prompt=rng.integers(
            1, cfg.vocab_size, size=PROMPT_LENS[1]).astype(np.int32),
            max_new=3))
    eng.step()                  # admits (prefills) every row, one decode
    torch.cuda.synchronize()
    steps, prefills = eng.decode_steps, len(eng.prefill_s)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()              # one decode step of every row, no admission
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if eng.decode_steps != steps + 1 or len(eng.prefill_s) != prefills:
        raise AssertionError("profiled step was not one decode step")
    n_ops, busy = device_busy_us(prof)
    if not n_ops:
        log("decode step device-busy share: not measured (the profiler "
            "recorded no device activity)")
        return None
    prof_step = {"device_ops": n_ops, "device_busy_ms": busy / 1e3,
                 "step_wall_ms": wall * 1e3,
                 "busy_share": busy / 1e3 / (wall * 1e3),
                 "unprofiled_step_ms": unprofiled_ms,
                 "busy_share_of_unprofiled": busy / 1e3 / unprofiled_ms}
    log(f"decode step under torch.profiler: {json.dumps(prof_step)}")
    return prof_step


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
    loss over a padded last chunk (S = 40, ``loss_chunk`` 24)."""
    import repro_torch.ff as ff
    from repro_torch.configs.granite_3_2b import CONFIG
    from repro_torch.models import init_params
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train.train_step import make_train_step
    for seq, extra in ((32, {}), (40, dict(loss_chunk=24, remat=True))):
        cfg = CONFIG.reduced(compute_dtype="float32", **extra)
        params = init_params(cfg, torch.Generator().manual_seed(SEED))
        runs = {}
        for dev in ("cuda", "cpu"):
            p = to_device(params, dev)
            opt = AdamW(learning_rate=cosine_schedule(3e-4, 10, 2))
            state = opt.init(p)
            with ff.policy("ff_reduce", attention="pallas"):
                step = make_train_step(cfg, None, opt)
            runs[dev] = []
            for batch in train_batches(cfg.vocab_size, seq, 4, 2, dev):
                p, state, m = step(p, state, batch)
                runs[dev].append((float(m["loss"]), float(m["grad_norm"])))
        for i, (a, b) in enumerate(zip(runs["cuda"], runs["cpu"])):
            for name, x, y in zip(("loss", "grad norm"), a, b):
                if not abs(x - y) <= SMALL_TRAIN_RTOL * abs(y):
                    raise AssertionError(
                        f"reduced training {extra} step {i}: {name} card "
                        f"{x!r} vs CPU {y!r}")
        log(f"reduced training (2 layers, f32, S={seq}, {extra}): card vs "
            f"CPU (loss, grad norm) per step {runs['cuda']} vs "
            f"{runs['cpu']}")


def train_launch_counts():
    from repro_torch.kernels import ff_attention, ff_fused
    return {"mean_sq": ff_fused.mean_sq.launches,
            "attention": ff_attention.flash_attention_pallas.launches,
            "adamw_update": ff_fused.adamw_update.launches}


def phase_train(torch, card: str):
    """granite-3-2b at full width: 4 training steps, the launches of each
    kernel per step, then one more step under torch.profiler."""
    import repro_torch.ff as ff
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.granite_3_2b import CONFIG as cfg
    from repro_torch.kernels import ff_attention, ff_fused
    from repro_torch.models import init_params
    from repro_torch.optim.adamw import AdamW, cosine_schedule, tree_leaves
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
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"granite-3-2b training: {n_params} params, {len(tree_leaves(params))}"
        f" leaves, set up in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    torch.cuda.reset_peak_memory_stats()

    ff_fused.mean_sq.launches = 0
    ff_attention.flash_attention_pallas.launches = 0
    ff_fused.adamw_update.launches = 0
    per_step, prev = [], train_launch_counts()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        params, state, m = step(params, state, batches[i])
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        now = train_launch_counts()
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
    now = train_launch_counts()
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

    launches = train_launch_counts()
    norms = 2 * cfg.num_layers + 1
    want = {"mean_sq": norms + 2 * cfg.num_layers,    # + remat recompute
            "attention": 2 * cfg.num_layers,          # forward + recompute
            "adamw_update": n_leaves(params)}
    log(f"training launches over {len(per_step)} steps: {launches}; per "
        f"step expected {want}")
    for rec in per_step:
        if rec["launches"] != want:
            raise AssertionError(f"step {rec['step']} launches "
                                 f"{rec['launches']} != {want}")

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
        "card": card}
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
    return sum(1 for _ in _leaves(tree))


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def phase_timing(torch, cfg, launches, errs, clock_hz):
    """``launches``: {path: {kernel: launches}} from the main paths' runs;
    each kernel's ``launches`` is their sum."""
    import torch.nn.functional as F
    from repro_torch.kernels import ff_attention, ff_fused
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    peak_ops = F32_LANES * clock_hz
    kernels = []

    def counts(name):
        by_path = {path: c.get(name, 0) for path, c in launches.items()}
        return dict(launches=sum(by_path.values()),
                    launches_by_path=by_path)

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

    # attention at the prefill shape of the longest prompt
    B, S, H, KV, hd = 1, PROMPT_LENS[1], cfg.num_heads, cfg.num_kv_heads, \
        cfg.resolved_head_dim
    q = torch.randn((B, S, H, hd), generator=g, device="cuda").bfloat16()
    k = torch.randn((B, S, KV, hd), generator=g, device="cuda").bfloat16()
    v = torch.randn((B, S, KV, hd), generator=g, device="cuda").bfloat16()
    sc = float(torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32))
    ops = attention_ops(B, S, S, H, hd, True, q.dtype == torch.bfloat16,
                        sc)
    byts = 2 * (q.numel() + k.numel() + v.numel()) + 2 * 4 * q.numel()
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    kernels.append(dict(
        name="ff_flash_attention", route="cuda",
        source="src/repro_torch/csrc/ff_attention.cu",
        replaces="src/repro/kernels/ff_attention.py:425",
        **counts("attention"), max_abs_err=errs["attention"],
        ms=graph_ms(lambda: ff_attention.flash_attention_pallas(
            q, k, v, causal=True, return_ff=True), 50),
        call_ms=cuda_ms(lambda: ff_attention.flash_attention_pallas(
            q, k, v, causal=True, return_ff=True), 50),
        plain_ms=cuda_ms(lambda: ff_attention.flash_attention_ff(
            q, k, v, causal=True, return_ff=True), 3),
        bound_ms=1e3 * max(byts / HBM_BYTES_PER_S, ops / peak_ops),
        bound_by="bytes" if byts / HBM_BYTES_PER_S >= ops / peak_ops
        else "operations",
        library_ms=graph_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 200),
        shape=[B, S, H, hd, KV]))
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
        else "operations", library_ms=library_ms, shape=list(shape))


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

    card = nvidia_smi("name,power.limit")
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    log(f"card: {card}; max SM clock {clock_mhz:.0f} MHz")
    phase_build(torch)
    errs = phase_kernel_checks(torch)
    phase_small_engine(torch)
    serve_launches, cfg, eng = phase_serve(torch, card)
    phase_decode_profile(torch, eng, cfg)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    log(f"serving engine freed: {torch.cuda.memory_allocated() / 1e9:.2f} "
        f"GB still allocated")
    phase_small_train(torch)
    train_launches = phase_train(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    kernels = phase_timing(torch, cfg, {"serve": serve_launches,
                                        "train": train_launches},
                           errs, clock_mhz * 1e6)
    torch.cuda.synchronize()
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
