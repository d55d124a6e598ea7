"""Kill-and-resume restart chaos (counterpart of ``repro.chaos.restart``):
SIGKILL a serving child process mid-decode, then warm-restart and hold
the result to the uninterrupted run.

``python -m repro_torch.chaos.restart [--device cpu] [--modes bf16,f32]``
runs the scenario once per ``kv_mode``:

  1. a CHILD process (``--child``) serves a fixed request set with a
     write-ahead journal and a synchronous snapshot every 2 decode steps,
     throttled (``--step-delay``) so the kill lands mid-decode, and
     rewrites ``progress.json`` after each snapshot;
  2. the PARENT polls ``progress.json`` and SIGKILLs the child once it
     reports ``kill_after_snaps`` snapshots; the child may die mid-write
     (a torn ``.tmp`` or a torn journal line), both designed-for states;
  3. the parent resumes with :func:`repro_torch.serve.resume_engine`
     (the newest snapshot that verifies, then the journal) and runs to
     the end;
  4. every request's tokens must equal, and its FF score limb pairs be
     bit for bit, an uninterrupted engine's on the same requests; the
     child's ``done`` marker must be absent (the kill landed mid-decode).

The child runs on the parent's device, with the parent's
``torch.get_num_threads()`` (on the CPU, torch's f32 GEMM may block its
sums by thread count).  Every wait has a limit: ``run_scenario``'s
``timeout_s`` and each ``proc.wait(timeout=...)``.  Exit 0 iff every
scenario ends in that parity with every request in a documented status.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

KV_MODES = ("bf16", "f32", "ff_bf16")
MAX_NEW = 10
SNAPSHOT_EVERY = 2


def _cfg():
    from repro_torch.models.config import ModelConfig
    return ModelConfig(name="restart-chaos", family="dense", num_layers=2,
                       d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                       vocab_size=256, max_seq_len=64,
                       compute_dtype="float32", remat=False)


def _params(cfg, device):
    """Weights from seed 0, made on the CPU (the same on every device)."""
    import torch
    from repro_torch.models import init_params
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.to(device),
                    init_params(cfg, torch.Generator().manual_seed(0)))


def _requests():
    from repro_torch.serve import Request
    rng = np.random.default_rng(17)
    prompts = [rng.integers(1, 256, size=int(n)).astype(np.int32)
               for n in (6, 9, 12)]
    return [Request(uid=i, prompt=p, max_new=MAX_NEW)
            for i, p in enumerate(prompts)]


def _engine(params, cfg, kv_mode, device, journal=None):
    from repro_torch.serve import ServeEngine
    return ServeEngine(params, cfg, max_batch=2, page_size=4, max_ctx=32,
                       kv_mode=kv_mode, journal=journal, device=device)


def child_main(workdir: str, kv_mode: str, step_delay: float,
               device, threads: int = 0) -> int:
    """Serve the request set with the journal and periodic snapshots,
    throttled so the parent's SIGKILL lands mid-decode.  Writes
    ``progress.json`` after each snapshot and a ``done`` marker only on
    a clean finish (the parent requires it absent)."""
    import torch
    from repro_torch import resolve_device
    if threads:
        torch.set_num_threads(threads)
    device = resolve_device(device)
    cfg = _cfg()
    params = _params(cfg, device)
    snapdir = os.path.join(workdir, "snap")
    eng = _engine(params, cfg, kv_mode, device,
                  journal=os.path.join(workdir, "wal.jsonl"))
    for r in _requests():
        eng.submit(r)
    snaps = 0
    while eng.step():
        if eng.decode_steps % SNAPSHOT_EVERY == 0:
            eng.save_snapshot(snapdir)
            snaps += 1
            tmp = os.path.join(workdir, "progress.tmp")
            with open(tmp, "w") as f:
                f.write(json.dumps({"snaps": snaps,
                                    "steps": eng.decode_steps}))
            os.replace(tmp, os.path.join(workdir, "progress.json"))
        time.sleep(step_delay)
    eng.save_snapshot(snapdir)
    with open(os.path.join(workdir, "done"), "w") as f:
        f.write("clean")
    return 0


def _log_tail(path: str, n: int = 2000) -> str:
    try:
        with open(path, "rb") as f:
            return f.read()[-n:].decode(errors="replace")
    except OSError:
        return ""


def run_scenario(workdir: str, kv_mode: str = "bf16", *, device=None,
                 step_delay: float = 0.25, kill_after_snaps: int = 2,
                 timeout_s: float = 300.0) -> dict:
    """Parent side: spawn the child on ``device`` (None: the CUDA card),
    SIGKILL it mid-decode, resume, and hold the result to the
    uninterrupted run.  Returns a report (the kill's snapshot and decode
    step, the resumed uids and statuses, seconds); raises AssertionError
    on any contract violation."""
    import torch
    from repro_torch import resolve_device
    device = resolve_device(device)
    t0 = time.perf_counter()
    os.makedirs(workdir, exist_ok=True)
    progress = os.path.join(workdir, "progress.json")
    log = os.path.join(workdir, "child.log")
    env = dict(os.environ)
    src_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = src_root + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    with open(log, "wb") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.chaos.restart", "--child",
             "--dir", workdir, "--kv-mode", kv_mode,
             "--step-delay", str(step_delay), "--device", str(device),
             "--threads", str(torch.get_num_threads())],
            env=env, stdout=out, stderr=subprocess.STDOUT)
    deadline = time.monotonic() + timeout_s
    try:
        while True:
            if time.monotonic() > deadline:
                raise AssertionError(
                    f"[{kv_mode}] child produced no snapshot progress "
                    f"within {timeout_s}s: {_log_tail(log)}")
            if proc.poll() is not None:
                raise AssertionError(
                    f"[{kv_mode}] child exited (rc={proc.returncode}) "
                    f"before the kill (increase step_delay): "
                    f"{_log_tail(log)}")
            if os.path.exists(progress):
                with open(progress) as f:
                    prog = json.load(f)
                if prog["snaps"] >= kill_after_snaps:
                    break
            time.sleep(0.05)
        proc.kill()                      # SIGKILL: no atexit, no cleanup
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    assert not os.path.exists(os.path.join(workdir, "done")), \
        f"[{kv_mode}] child finished cleanly; the kill tested nothing"
    with open(progress) as f:
        killed = json.load(f)

    from repro_torch.serve import OK, resume_engine
    cfg = _cfg()
    params = _params(cfg, device)
    eng = resume_engine(params, cfg, os.path.join(workdir, "snap"),
                        journal=os.path.join(workdir, "wal.jsonl"),
                        device=device)
    resumed_from = eng.decode_steps
    resumed = eng.run()
    eng.journal.close()

    base = _engine(params, cfg, kv_mode, device)
    for r in _requests():
        base.submit(r)
    baseline = base.run()

    assert set(resumed) == set(baseline), (
        f"[{kv_mode}] uid sets differ: resumed {sorted(resumed)} vs "
        f"baseline {sorted(baseline)}")
    for uid in sorted(baseline):
        a, b = baseline[uid], resumed[uid]
        assert b.status == OK, (
            f"[{kv_mode}] uid {uid}: resumed status {b.status} "
            f"({b.detail})")
        assert np.array_equal(a.tokens, b.tokens), (
            f"[{kv_mode}] uid {uid}: token mismatch after resume")
        assert np.array_equal(a.logprobs_ff, b.logprobs_ff), (
            f"[{kv_mode}] uid {uid}: FF logprob limbs not bit-identical")
    return {"kv_mode": kv_mode, "device": str(device),
            "killed_at_snaps": killed["snaps"],
            "killed_at_step": killed["steps"],
            "resumed_from_step": resumed_from,
            "resumed_uids": sorted(resumed),
            "statuses": {u: resumed[u].status for u in sorted(resumed)},
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.chaos.restart")
    ap.add_argument("--child", action="store_true")
    ap.add_argument("--dir", type=str, default=None)
    ap.add_argument("--kv-mode", type=str, default="bf16",
                    choices=KV_MODES)
    ap.add_argument("--step-delay", type=float, default=0.25)
    ap.add_argument("--modes", type=str, default=",".join(KV_MODES),
                    help="comma-separated kv_modes for the parent sweep")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--threads", type=int, default=0,
                    help="--child: torch threads (the parent's count)")
    args = ap.parse_args(argv)
    if args.child:
        if not args.dir:
            ap.error("--child requires --dir")
        return child_main(args.dir, args.kv_mode, args.step_delay,
                          args.device, args.threads)
    import tempfile
    failures = []
    for mode in args.modes.split(","):
        print(f"chaos-restart: SIGKILL mid-decode + resume [{mode}]")
        with tempfile.TemporaryDirectory(
                prefix=f"restart-chaos-{mode}-") as workdir:
            try:
                report = run_scenario(workdir, mode, device=args.device,
                                      step_delay=args.step_delay)
            except AssertionError as e:
                print(f"  [FAIL] {e}")
                failures.append(str(e))
                continue
        print(f"  [ok] exact-replay parity: killed after snapshot "
              f"{report['killed_at_snaps']} (decode step "
              f"{report['killed_at_step']}), resumed from step "
              f"{report['resumed_from_step']}, uids "
              f"{report['resumed_uids']} all "
              f"{sorted(set(report['statuses'].values()))} "
              f"({report['seconds']:.1f} s)")
    if failures:
        print(f"chaos-restart: {len(failures)} scenario(s) FAILED")
        return 1
    print("chaos-restart: all kill-and-resume scenarios passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
