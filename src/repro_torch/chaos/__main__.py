"""Guarded-serving chaos smoke (counterpart of ``python -m repro.chaos``).

``python -m repro_torch.chaos [--device cpu]`` serves a tiny dense model
(random weights from seed 0, made on the CPU and moved to the device, so
the card and the CPU serve the same model) under every fault class the
injectors produce, and checks the robustness contract end to end:

  * every submitted request ends with a documented status, with no
    unhandled exception;
  * ``OK`` results are token for token the healthy ``greedy_generate``
    baseline, ``DEGRADED`` ones the fast-tier baseline, ``FAILED`` ones
    withheld (never silently wrong);
  * the fault classes: KV poison (``nan``, ``inf``: quarantine and the
    fast-tier retry; ``denormal_lo``: a hazard the probe sees, never a
    quarantine), the three block-table flips (``oob``, ``free``, ``dup``:
    the paging audit rebuilds the free list), pool exhaustion under
    ``reserve="prompt"`` (preemption, same tokens) and a forced allocation
    failure (``FAILED``, "unschedulable"), deadlines (``deadline_steps``
    0 and 1: ``TIMEOUT``), the bounded queue and oversize requests
    (``REJECTED``), mangled tuning sidecars (a warning, not a crash), and
    the restart tier: snapshot/restore token for token (FF scores bit for
    bit), a torn ``.tmp``, a flipped checkpoint bit and a stale manifest
    falling back warned (never a silent load), and the write-ahead
    journal replaying crash-lost requests in order.  The SIGKILL variant
    is ``python -m repro_torch.chaos.restart``.

Runs on the CUDA card unless ``--device cpu`` is given; exits non-zero
listing every violated check.  Deterministic: fixed weights, prompts and
:class:`~repro_torch.chaos.ChaosMonkey` seed.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
import warnings
from typing import Optional

import numpy as np
import torch

from repro_torch.models.config import ModelConfig

CFG = ModelConfig(name="chaos-smoke", family="dense", num_layers=2,
                  d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                  vocab_size=256, max_seq_len=64, compute_dtype="float32",
                  remat=False)
SMALL = dict(max_batch=2, page_size=4, max_ctx=32)


def smoke_params(device):
    """The smoke's weights on ``device``: ``init_params`` from seed 0 on
    the CPU, so every device holds the same values."""
    from repro_torch.models import init_params
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.to(device),
                    init_params(CFG, torch.Generator().manual_seed(0)))


def _prompts(rng, n, lo=6, hi=14):
    return [rng.integers(1, CFG.vocab_size, size=int(s)).astype(np.int32)
            for s in rng.integers(lo, hi, size=n)]


def main(argv=None, report: Optional[dict] = None) -> int:
    """Run the smoke; returns the exit code.  ``report`` (a dict), when
    given, receives each scenario's ``{uid: (status, tokens)}``."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.chaos")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import repro_torch.ff as ff
    from repro_torch import resolve_device
    from repro_torch.chaos import ChaosMonkey
    from repro_torch.checkpoint import checkpoint as ckpt_lib
    from repro_torch.ff import tuning
    from repro_torch.ff.scope import resolve_policy
    from repro_torch.kernels.ff_guard import flag_planes
    from repro_torch.serve import (DEGRADED, FAILED, OK, REJECTED, STATUSES,
                                   TIMEOUT, Request, ServeEngine,
                                   resume_engine)
    from repro_torch.train.serve_step import greedy_generate

    device = resolve_device(args.device)
    failures = []
    report = {} if report is None else report

    def check(cond: bool, what: str) -> None:
        print(f"  [{'ok' if cond else 'FAIL'}] {what}")
        if not cond:
            failures.append(what)

    rng = np.random.default_rng(7)
    monkey = ChaosMonkey(seed=11)
    params = smoke_params(device)
    fast = dataclasses.replace(resolve_policy(None), attention="fast",
                               ff_math=False)

    def baseline(prompt, max_new, policy=None):
        p = torch.as_tensor(prompt[None], dtype=torch.long, device=device)
        return greedy_generate(params, CFG, p, max_new, cache_len=48,
                               policy=policy)[0].cpu().numpy()

    def engine(**kw):
        return ServeEngine(params, CFG, device=device, **{**SMALL, **kw})

    def serve(eng, prompts, max_new, inject=None):
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=p, max_new=max_new))
        if inject is not None:
            eng.step()
            inject(eng)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", ff.FFGuardWarning)
            return eng.run()

    def contract(name, prompts, res, max_new):
        """Every uid ended with a documented status; OK rows the healthy
        baseline, DEGRADED rows the fast tier's, FAILED rows withheld."""
        report[name] = {u: (r.status, r.tokens.tolist())
                        for u, r in sorted(res.items())}
        check(sorted(res) == list(range(len(prompts)))
              and all(r.status in STATUSES for r in res.values()),
              f"{name}: every request ended with a documented status")
        for i, p in enumerate(prompts):
            r = res[i]
            if r.status == FAILED:
                ok = r.tokens.size == 0
            elif r.status in (OK, DEGRADED):
                ok = np.array_equal(r.tokens, baseline(
                    p, max_new, fast if r.status == DEGRADED else None))
            else:
                continue
            check(ok, f"{name}: uid {i} ({r.status}) token parity")

    print(f"chaos: healthy guarded serving (guard=check, {device})")
    prompts = _prompts(rng, 3)
    res = serve(engine(guard="check"), prompts, 6)
    contract("healthy", prompts, res, 6)
    check(all(r.status == OK for r in res.values()),
          "healthy run: every status OK")

    for kind in ("nan", "inf"):
        print(f"chaos: {kind} poison in live KV limbs (guard=degrade)")
        prompts = _prompts(rng, 2)
        seen = {}

        def poison(eng):
            seen["coords"] = set(monkey.corrupt_kv_limbs(
                eng.kv, slot=0, kind=kind, n=2))
            seen["jnp"] = int(eng.probe_kv().nonfinite)
            with ff.use(guard_probe="pallas"):
                seen["kernel"] = int(eng.probe_kv().nonfinite)

        eng = engine(guard="degrade")
        res = serve(eng, prompts, 6, poison)
        contract(f"poison {kind}", prompts, res, 6)
        check(seen["kernel"] == seen["jnp"] == len(seen["coords"]),
              f"{kind} poison: probe_kv counts every poisoned position "
              f"(guard_probe pallas {seen['kernel']}, jnp {seen['jnp']})")
        check(any(r.status == DEGRADED for r in res.values()),
              f"{kind} poison: the poisoned row was quarantined (DEGRADED)")
        evs = eng.obs.to_chrome_trace()["traceEvents"]
        check(any(e["ph"] == "i" and e["name"] == "quarantine" for e in evs),
              f"{kind} poison: quarantine instant recorded in the trace")
        check(any(e["ph"] == "X" and e["name"] == "request"
                  and e["args"].get("status") == DEGRADED for e in evs),
              f"{kind} poison: DEGRADED request span recorded in the trace")
        snap = eng.obs.snapshot()
        check(snap["counters"].get(
                  'serve_guard_events_total{kind="quarantined"}', 0)
              == eng.guard_stats["quarantined"] >= 1,
              f"{kind} poison: obs counter agrees with "
              f"guard_stats[quarantined]")

    print("chaos: denormal_lo in ff_bf16 lo limbs (a hazard, not a "
          "violation)")
    prompts = _prompts(rng, 1)
    seen = {}

    def denormal(eng):
        monkey.corrupt_kv_limbs(eng.kv, slot=0, kind="denormal_lo", n=3,
                                base="k", limb="lo")
        seen["dn"] = int(flag_planes(eng.kv.planes["k_hi"].float(),
                                     eng.kv.planes["k_lo"].float())[2]
                         .sum())

    eng = engine(kv_mode="ff_bf16", guard="degrade")
    res = serve(eng, prompts, 4, denormal)
    contract("denormal_lo", prompts, res, 4)
    check(seen["dn"] >= 1 and res[0].status in (OK, DEGRADED)
          and eng.guard_stats["quarantined"] == 0,
          f"denormal_lo: seen by the limb bits ({seen['dn']}), never "
          f"quarantined ({res[0].status})")

    for mode in ("oob", "free", "dup"):
        print(f"chaos: block-table corruption [{mode}] (guard=degrade)")
        prompts = _prompts(rng, 2)
        eng = engine(guard="degrade")
        res = serve(eng, prompts, 6, lambda e: monkey.flip_block_table(
            e.kv, slot=1, mode=mode))
        contract(f"flip {mode}", prompts, res, 6)
        check(eng.guard_stats["integrity_rebuilds"] >= 1,
              f"{mode} flip: the paging audit rebuilt the free list")
        check(any(e["ph"] == "i" and e["name"] == "integrity_rebuild"
                  for e in eng.obs.to_chrome_trace()["traceEvents"]),
              f"{mode} flip: integrity_rebuild instant recorded")
        check(eng.kv.check_integrity() == ([], set()),
              f"{mode} flip: metadata clean after recovery")

    print("chaos: pool exhaustion -> preempt-and-requeue (reserve=prompt)")
    prompts = _prompts(rng, 3, lo=7, hi=9)
    eng = engine(max_batch=3, num_pages=8, reserve="prompt")
    res = serve(eng, prompts, 8)
    contract("preemption", prompts, res, 8)
    check(all(r.status == OK for r in res.values())
          and eng.guard_stats["preempted"] >= 1,
          f"preemption: every request OK, "
          f"{eng.guard_stats['preempted']} preempted")

    print("chaos: forced allocation failure (the pool stolen)")
    p = _prompts(rng, 1)[0]
    eng = engine(max_batch=1, reserve="prompt")
    with monkey.exhaust_pool(eng.kv):
        eng.submit(Request(uid=0, prompt=p, max_new=4))
        res = eng.run()
    check(res[0].status == FAILED and "unschedulable" in res[0].detail
          and res[0].tokens.size == 0,
          "stolen pool: the head request FAILED (unschedulable), withheld")
    eng.submit(Request(uid=1, prompt=p, max_new=4))
    res = eng.run()
    check(res[1].status == OK and np.array_equal(res[1].tokens,
                                                 baseline(p, 4)),
          "pool restored: the same request OK with the baseline's tokens")
    report["allocation failure"] = {u: (r.status, r.tokens.tolist())
                                    for u, r in sorted(res.items())}

    print("chaos: backpressure: deadlines, bounded queue, oversize")
    prompts = _prompts(rng, 2)
    eng = engine(max_batch=1, max_queue=2)
    eng.submit(Request(uid=0, prompt=prompts[0], max_new=6))
    eng.submit(Request(uid=1, prompt=prompts[1], max_new=6,
                       deadline_steps=1))
    st = eng.submit(Request(uid=2, prompt=prompts[0], max_new=64))
    check(st == REJECTED and eng.results[2].status == REJECTED,
          "oversize request REJECTED at submit")
    st = eng.submit(Request(uid=3, prompt=prompts[1], max_new=6))
    check(st == REJECTED, "queue overflow REJECTED at submit (max_queue)")
    res = eng.run()
    check(res[0].status == OK and res[1].status == TIMEOUT,
          "deadline_steps=1 while queued -> TIMEOUT; head -> OK")
    check(sorted(res) == [0, 1, 2, 3], "backpressure: all uids terminated")
    eng = engine(max_batch=1)
    eng.submit(Request(uid=0, prompt=prompts[0], max_new=6,
                       deadline_steps=0))
    res0 = eng.run()
    check(res0[0].status == TIMEOUT and res0[0].tokens.size == 0
          and "queued" in res0[0].detail,
          "deadline_steps=0 -> TIMEOUT before admission, no tokens")
    report["backpressure"] = {u: (r.status, r.tokens.tolist())
                              for u, r in sorted({**res, 4: res0[0]}
                                                 .items())}

    tmp = tempfile.TemporaryDirectory(prefix="chaos-")
    print("chaos: mangled tuning sidecars")
    for mode in ("truncate", "garbage", "wrong_types"):
        path = os.path.join(tmp.name, f"FF_TUNE_{mode}.json")
        monkey.mangle_tune_json(path, mode=mode)
        tuning.clear()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            table = tuning.load(path)
        check(len(caught) >= 1, f"tune sidecar [{mode}]: warned, not raised")
        if mode == "wrong_types":
            check("cpu/add" in table and "cpu/matmul" not in table,
                  "tune sidecar [wrong_types]: valid entries salvaged")
    tuning.clear()

    print("chaos: snapshot/restore exact replay (kv_mode=ff_bf16)")
    prompts = _prompts(rng, 3)
    submitted = [Request(uid=i, prompt=p, max_new=8)
                 for i, p in enumerate(prompts)]
    base = engine(kv_mode="ff_bf16")
    for r in submitted:
        base.submit(r)
    res_base = base.run()
    snapdir = os.path.join(tmp.name, "snap")
    eng = engine(kv_mode="ff_bf16")
    for r in submitted:
        eng.submit(r)
    for _ in range(3):
        eng.step()
    eng.save_snapshot(snapdir)       # generation 1 (mid-run)
    for _ in range(2):
        eng.step()
    eng.save_snapshot(snapdir)       # generation 2 (later)
    res = resume_engine(params, CFG, snapdir, device=device).run()
    report["restore"] = {u: (r.status, r.tokens.tolist())
                         for u, r in sorted(res.items())}
    check(sorted(res) == [0, 1, 2], "restart: all requests terminated")
    check(all(np.array_equal(res[i].tokens, res_base[i].tokens)
              for i in res),
          "restart: token-for-token parity with the uninterrupted run")
    check(all(np.array_equal(res[i].logprobs_ff, res_base[i].logprobs_ff)
              for i in res),
          "restart: FF logprob limb pairs bit-for-bit identical")

    print("chaos: corrupted checkpoints fall back WARNED, never silent")
    monkey.tear_checkpoint_tmp(snapdir)
    steps_before = ckpt_lib.available_steps(snapdir)
    check(len(steps_before) == 2 and not any(
        d.endswith(".tmp") for d in os.listdir(snapdir)),
        "torn .tmp write: skipped and garbage-collected")
    monkey.flip_checkpoint_bit(snapdir, step=steps_before[-1])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        eng3 = resume_engine(params, CFG, snapdir, device=device)
    check(any(issubclass(w.category, ckpt_lib.CheckpointCorruptionWarning)
              for w in caught),
          "bit flip: CRC mismatch warned (loud fallback)")
    check(eng3.decode_steps == steps_before[0],
          "bit flip: fell back to the previous retained generation")
    res = eng3.run()
    check(all(np.array_equal(res[i].tokens, res_base[i].tokens)
              for i in res),
          "bit flip: replay from the older generation still exact")
    monkey.stale_manifest(snapdir, step=steps_before[0])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            ckpt_lib.load_dict(snapdir)
            loud = False
        except ckpt_lib.CheckpointError:
            loud = True      # every generation bad: raise, never silence
    check(loud and len(caught) >= 2,
          "stale manifest: no generation verifies -> loud CheckpointError")

    print("chaos: write-ahead journal replays crash-lost requests")
    wal = os.path.join(tmp.name, "wal", "wal.jsonl")
    eng = engine(journal=wal)
    for r in submitted:
        eng.submit(r)
    eng.journal.close()
    del eng                          # the crash: before any decode
    eng2 = resume_engine(params, CFG, os.path.join(tmp.name, "wal", "snap"),
                         journal=wal, device=device, **SMALL)
    check([q["req"].uid for q in eng2.queue] == [0, 1, 2],
          "WAL: requests re-admitted in original order")
    res = eng2.run()
    eng2.journal.close()
    base_bf16 = engine()
    for r in submitted:
        base_bf16.submit(r)
    res_base2 = base_bf16.run()
    report["journal"] = {u: (r.status, r.tokens.tolist())
                         for u, r in sorted(res.items())}
    check(all(np.array_equal(res[i].tokens, res_base2[i].tokens)
              for i in res),
          "WAL: replayed requests produce the same tokens")
    check(os.path.getsize(wal) == 0,
          "WAL: journal truncated on clean retirement")
    tmp.cleanup()

    print()
    if failures:
        print(f"chaos smoke: {len(failures)} check(s) FAILED")
        for f in failures:
            print(f"  - {f}")
        return 1
    print("chaos smoke: all checks passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
