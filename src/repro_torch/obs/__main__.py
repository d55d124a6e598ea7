"""Observability smoke (counterpart of ``python -m repro.obs``).

``python -m repro_torch.obs [--device cpu]`` serves a tiny dense model
(random weights from seed 0) through the continuous-batching engine with
every observability layer on: the engine's metrics, the process-global
dispatch/tune/guard telemetry, the Chrome request trace and the
``obs.enable()`` profiler annotations, under ``guard="check"`` and
``ff.policy("ff_reduce")``, after one explicit Ozaki matmul.  It checks:

  * the metrics' dispatch-resolution counters name the winning impl per
    resolved op (``ff_dispatch_resolutions_total{op=..., impl=...,
    source=...}``), the explicit Ozaki matmul among them;
  * the trace is Chrome JSON that survives a ``json`` round trip, with
    one complete ``request`` span per submitted request, each with a
    documented status, and sorted non-negative timestamps;
  * the engine's request, guard and latency series are populated, and
    the Prometheus text holds both registries.

Runs on the CUDA card unless ``--device cpu`` is given.  Exits non-zero
listing every violated check.  ``--metrics-json`` / ``--trace-out``
write the two artifacts.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs")
    ap.add_argument("--metrics-json", type=str, default=None)
    ap.add_argument("--trace-out", type=str, default=None)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=6)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import repro_torch.ff as ff
    from repro_torch import obs, resolve_device
    from repro_torch.models import init_params
    from repro_torch.models.config import ModelConfig
    from repro_torch.serve import STATUSES, Request, ServeEngine

    device = resolve_device(args.device)
    failures = []

    def check(cond: bool, what: str) -> None:
        print(f"  [{'ok' if cond else 'FAIL'}] {what}")
        if not cond:
            failures.append(what)

    cfg = ModelConfig(name="obs-smoke", family="dense", num_layers=2,
                      d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                      vocab_size=256, max_seq_len=64,
                      compute_dtype="float32", remat=False)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0))
    rng = np.random.default_rng(3)

    print(f"obs: instrumented serving smoke (guard=check, profiling on, "
          f"{device})")
    observer = obs.Observer()
    before = obs.REGISTRY.snapshot()
    with obs.enable(), ff.policy("ff_reduce"):
        # an Ozaki-class matmul, so the accurate tier shows in the
        # dispatch telemetry beside the engine's resolutions
        a = torch.ones((64, 64), dtype=torch.float32, device=device)
        ff.matmul(a, a, impl="ozaki").hi.cpu()
        eng = ServeEngine(params, cfg, max_batch=2, page_size=4,
                          max_ctx=32, guard="check", obs=observer,
                          device=device)
        for i in range(args.requests):
            eng.submit(Request(
                uid=i,
                prompt=rng.integers(
                    1, cfg.vocab_size,
                    size=int(rng.integers(6, 14))).astype(np.int32),
                max_new=args.max_new))
        results = eng.run()

    check(sorted(results) == list(range(args.requests)),
          "every submitted request terminated")
    check(all(r.status in STATUSES for r in results.values()),
          "every status documented")

    # -- the metrics contract ----------------------------------------------
    delta = obs.REGISTRY.delta(before)
    resolved = {}
    for series, n in delta["counters"].items():
        if n and series.startswith("ff_dispatch_resolutions_total"):
            labels = dict(kv.split("=", 1) for kv in
                          series.split("{", 1)[1].rstrip("}").split(","))
            op = labels["op"].strip('"')
            resolved.setdefault(op, set()).add(
                (labels["impl"].strip('"'), labels["source"].strip('"')))
    check(bool(resolved),
          "dispatch-resolution counters recorded during the run")
    check(all(impl for impls in resolved.values() for impl, _ in impls),
          "each resolution names the winning impl")
    check(any(impl == "ozaki" for impl, _ in resolved.get("matmul", set())),
          "explicit ozaki matmul resolution visible in telemetry")
    for op, impls in sorted(resolved.items()):
        wins = ", ".join(f"{i} ({s})" for i, s in sorted(impls))
        print(f"    ff.{op}: {wins}")
    snap = observer.snapshot()
    check(snap["counters"].get('serve_requests_total{status="OK"}', 0)
          + snap["counters"].get('serve_requests_total{status="DEGRADED"}',
                                 0) >= 1,
          "engine request counters populated")
    check(snap["histograms"].get("serve_decode_step_seconds",
                                 {}).get("count", 0) > 0,
          "decode-step latency histogram populated")
    prom = observer.registry.to_prometheus() + obs.REGISTRY.to_prometheus()
    check("serve_guard_events_total" in prom
          and "ff_dispatch_resolutions_total" in prom,
          "Prometheus text exposition includes both registries")

    # -- the trace contract ------------------------------------------------
    payload = json.loads(json.dumps(observer.to_chrome_trace()))
    evs = payload["traceEvents"]
    spans = [e for e in evs if e["ph"] == "X" and e["name"] == "request"]
    check(len(spans) == args.requests,
          f"one complete request span per request "
          f"({len(spans)}/{args.requests})")
    check(all(e["args"]["status"] in STATUSES for e in spans),
          "every request span carries a documented terminal status")
    ts = [e["ts"] for e in evs if e["ph"] != "M"]
    check(all(t >= 0 for t in ts) and ts == sorted(ts),
          "trace timestamps monotone non-negative after export sort")
    check(all(e.get("dur", 0) >= 0 for e in evs if e["ph"] == "X"),
          "span durations non-negative")

    if args.metrics_json:
        observer.dump_metrics(args.metrics_json)
        print(f"  metrics -> {args.metrics_json}")
    if args.trace_out:
        observer.dump_trace(args.trace_out)
        print(f"  trace   -> {args.trace_out}")

    print()
    if failures:
        print(f"obs smoke: {len(failures)} check(s) FAILED")
        for f in failures:
            print(f"  - {f}")
        return 1
    print("obs smoke: all checks passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
