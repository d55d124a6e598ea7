#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failed check raises, so the script exits non-zero):

  1. card and build: the card's name and power limit, the torch/CUDA
     versions, and the kernels built from ``src/repro_torch/csrc`` (into
     ``build/``, one ``nvcc`` per source, all at once);
  2. kernel checks: each kernel against its plain PyTorch version on the
     card — ``mean_sq`` to <= 1 ulp, FF attention (and its plain version)
     to <= 2^-40 of a float64 oracle on the card;
  3. serving: a reduced granite-3-2b engine on the card against the same
     engine on the CPU (plain versions), then granite-3-2b at full width
     (random weights from a seed) serving 8 requests under
     ``policy("ff_reduce", attention="pallas")``, with the kernels' launch
     counts read around that run; then one more decode step with every
     row full under ``torch.profiler``, for the device-busy share;
  4. timing: each kernel, its plain version and a PyTorch yardstick with
     CUDA events at the main path's shapes, beside its bound.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA card, or
outside a checkout, the script exits non-zero and prints no result.
"""

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
    for shape in ((4, 2048), (64, 2048), (3, 1000)):
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
            (1, 64, 64, 32, 8, 64, True, torch.bfloat16),
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
    return {k: to_device(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


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


def phase_decode_profile(torch, eng, cfg):
    """Device-busy share of one decode step with every row full: the union
    of the device intervals that torch.profiler records in the step, over
    the step's wall time on the host clock."""
    import numpy as np
    from torch.autograd import DeviceType
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
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:                     # union of intervals, in us
        if b > end:
            busy += b - max(a, end)
            end = b
    if not spans:
        log("decode step device-busy share: not measured (the profiler "
            "recorded no device activity)")
        return None
    prof_step = {"device_ops": len(spans), "device_busy_ms": busy / 1e3,
                 "step_wall_ms": wall * 1e3,
                 "busy_share": busy / 1e3 / (wall * 1e3),
                 "unprofiled_step_ms": unprofiled_ms,
                 "busy_share_of_unprofiled": busy / 1e3 / unprofiled_ms}
    log(f"decode step under torch.profiler: {json.dumps(prof_step)}")
    return prof_step


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def phase_timing(torch, cfg, launches, errs, clock_hz):
    import torch.nn.functional as F
    from repro_torch.kernels import ff_attention, ff_fused
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    peak_ops = F32_LANES * clock_hz
    kernels = []

    # mean_sq at the decode shape (max_batch rows of d_model)
    rows, cols = 4, cfg.d_model
    x = torch.randn((rows, cols), generator=g, device="cuda")
    ops = rows * (cols * (1 + CASCADE) + 128 * LANE_FOLD + 1)
    byts = rows * cols * 4 + rows * 4
    kernels.append(dict(
        name="mean_sq", route="cuda", source="src/repro_torch/csrc/"
        "ff_mean_sq.cu", replaces="src/repro/kernels/ff_fused.py:188",
        launches=launches["mean_sq"], max_abs_err=errs["mean_sq"],
        ms=graph_ms(lambda: ff_fused.mean_sq(x), 500),
        call_ms=cuda_ms(lambda: ff_fused.mean_sq(x), 500),
        plain_ms=cuda_ms(lambda: ff_fused.mean_sq_plain(x), 5),
        bound_ms=1e3 * max(byts / HBM_BYTES_PER_S, ops / peak_ops),
        bound_by="bytes" if byts / HBM_BYTES_PER_S >= ops / peak_ops
        else "operations", library_ms=None, shape=[rows, cols]))

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
        launches=launches["attention"], max_abs_err=errs["attention"],
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
    }
    log(f"decode-step pieces: {json.dumps(pieces)}")
    for kd in kernels:
        log(f"{kd['name']}: kernel {kd['ms']:.4f} ms (one call from "
            f"Python {kd['call_ms']:.4f} ms), plain "
            f"{kd['plain_ms']:.3f} ms, bound {kd['bound_ms']:.5f} ms "
            f"({kd['bound_by']}), library {kd['library_ms']}")
    return kernels


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
    launches, cfg, eng = phase_serve(torch, card)
    phase_decode_profile(torch, eng, cfg)
    del eng
    kernels = phase_timing(torch, cfg, launches, errs, clock_mhz * 1e6)
    torch.cuda.synchronize()
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
