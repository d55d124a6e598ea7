"""Serving launcher (counterpart of ``repro.launch.serve``): a batched
prefill and greedy decode loop, or the continuous-batching engine::

    python -m repro_torch.launch.serve --arch granite-3-2b [--reduced] \\
        [--batch 4] [--prompt-len 32] [--max-new 16] [--device cpu]
    python -m repro_torch.launch.serve --arch olmoe-1b-7b   # MoE, MHA
    python -m repro_torch.launch.serve --arch mamba2-370m   # SSM (SSD)
    python -m repro_torch.launch.serve --arch whisper-medium  # enc-dec
    python -m repro_torch.launch.serve --arch granite-3-2b --engine \\
        [--kv-mode bf16|f32|ff_bf16] [--guard off|check|degrade] \\
        [--snapshot-dir DIR [--snapshot-every N] [--resume]] \\
        [--metrics-json FILE] [--trace-out FILE] [--metrics-port PORT]

Runs on the CUDA card unless ``--device cpu`` is given.  Weights come from
seed 0, the engine's prompts (lengths between half ``--prompt-len`` and
``--prompt-len``) from numpy seed 1, as in the reference.  ``--engine``
serves through :class:`repro_torch.serve.ServeEngine` (paged KV cache,
FF token scores); with ``--snapshot-dir`` it journals every request to
``<snapshot-dir>/wal.jsonl`` and snapshots there every
``--snapshot-every`` decode steps and at the end, and ``--resume``
restarts from the newest snapshot that verifies and replays the journal
instead of submitting new requests.

``--arch`` takes every architecture of ``repro_torch.configs.PORTED``
(dense GQA, MoE, MLA, the VLM backbone and the SSM, hybrid and
encoder-decoder families; the batched loop gives the VLM zero patch
embeddings and the encoder-decoder zero frames, as the reference's).  The
engine serves the dense GQA family only: with ``--engine`` any other
architecture stops with ``UnsupportedModelError``, as in the reference.

``--metrics-json`` writes the engine's metrics and the process-global
telemetry (:meth:`repro_torch.obs.Observer.dump_metrics`) after the run,
``--trace-out`` the Chrome trace (open it in Perfetto), and
``--metrics-port`` serves both registries as Prometheus text on
``http://127.0.0.1:PORT/metrics`` while the engine runs; each needs
``--engine``.  ``--mesh`` waits for the port's mesh tier (ROADMAP, queue
1, item 8) and stops with an error.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device

#: the reference's flags the port does not serve yet -> the ROADMAP item
_NOT_PORTED = {"--mesh": "queue 1, item 8 (mesh tier)"}


def _start_metrics_server(observer, port: int):
    """Serve ``observer``'s registry and ``repro_torch.obs.REGISTRY`` as
    Prometheus text on ``/metrics`` at 127.0.0.1, from a daemon thread.
    ``port=0`` takes a free port (``srv.server_address[1]``)."""
    import threading
    from http.server import BaseHTTPRequestHandler, HTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path.rstrip("/") not in ("", "/metrics"):
                self.send_response(404)
                self.end_headers()
                return
            from repro_torch import obs
            body = (observer.registry.to_prometheus()
                    + obs.REGISTRY.to_prometheus()).encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):            # quiet: stats, not access logs
            pass

    srv = HTTPServer(("127.0.0.1", port), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-size variant (CPU-runnable)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--engine", action="store_true",
                    help="serve through the continuous-batching ServeEngine "
                         "(paged KV cache)")
    ap.add_argument("--kv-mode", default="bf16",
                    choices=("bf16", "f32", "ff_bf16"),
                    help="--engine page storage: bf16, f32, or ff_bf16 "
                         "(double-bf16 limb planes)")
    ap.add_argument("--guard", default="off",
                    choices=("off", "check", "degrade"),
                    help="--engine numeric guard: per-step health probe, "
                         "quarantine and fast-tier retry of poisoned rows")
    ap.add_argument("--snapshot-dir", default=None,
                    help="--engine: directory of engine snapshots (CRC32'd, "
                         "keep-last-3) and the request journal wal.jsonl")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="--engine: snapshot every N decode steps (0 = only "
                         "at the end; needs --snapshot-dir)")
    ap.add_argument("--resume", action="store_true",
                    help="--engine: restart from the newest snapshot that "
                         "verifies under --snapshot-dir and replay the "
                         "journal, instead of submitting new requests")
    ap.add_argument("--metrics-json", default=None,
                    help="--engine: write the metrics snapshot (the "
                         "engine's counters, gauges and histograms and the "
                         "global dispatch/tune/guard/journal telemetry) to "
                         "this JSON file after the run")
    ap.add_argument("--trace-out", default=None,
                    help="--engine: write the Chrome trace-event JSON "
                         "(per-request spans, per-step events; open in "
                         "Perfetto) to this file")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="--engine: serve Prometheus text on "
                         "http://127.0.0.1:PORT/metrics while the engine "
                         "runs (0 takes a free port)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    for flag, item in _NOT_PORTED.items():
        ap.add_argument(flag, default=None, nargs="?", const=True,
                        help=f"not ported yet: {item}")
    return ap


def main(argv: Optional[Sequence[str]] = None):
    """Run the launcher; returns the engine's ``{uid: GenResult}`` with
    ``--engine``, else ``{"tokens", "logprobs"}`` of the batched loop."""
    ap = _parser()
    args = ap.parse_args(argv)
    for flag, item in _NOT_PORTED.items():
        if getattr(args, flag[2:].replace("-", "_")) is not None:
            ap.error(f"{flag} is not ported yet: it waits for ROADMAP "
                     f"{item}")
    if (args.snapshot_every or args.resume) and not args.snapshot_dir:
        ap.error("--snapshot-every/--resume require --snapshot-dir")
    if args.snapshot_dir and not args.engine:
        ap.error("--snapshot-dir requires --engine")
    if (args.metrics_json or args.trace_out
            or args.metrics_port is not None) and not args.engine:
        ap.error("--metrics-json/--trace-out/--metrics-port require "
                 "--engine")

    import repro_torch.ff as ff
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.train.serve_step import greedy_generate

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0))
    max_ctx = args.prompt_len + args.max_new + 8
    if args.engine:
        from repro_torch import obs
        from repro_torch.serve import Request, ServeEngine, resume_engine
        journal = (os.path.join(args.snapshot_dir, "wal.jsonl")
                   if args.snapshot_dir else None)
        observer = obs.Observer()
        metrics_server = None
        if args.metrics_port is not None:
            metrics_server = _start_metrics_server(observer,
                                                   args.metrics_port)
            print(f"[serve] metrics: http://127.0.0.1:"
                  f"{metrics_server.server_address[1]}/metrics")
        rng = np.random.default_rng(1)
        lo = max(4, args.prompt_len // 2)
        lens = rng.integers(lo, args.prompt_len + 1, size=args.batch)
        knobs = dict(max_batch=args.batch, max_ctx=max_ctx,
                     kv_mode=args.kv_mode, guard=args.guard, device=device,
                     obs=observer)
        if args.resume:
            t0 = time.perf_counter()
            eng = resume_engine(params, cfg, args.snapshot_dir,
                                journal=journal, **knobs)
            n_run = sum(s is not None for s in eng._slots)
            print(f"[serve] resumed from {args.snapshot_dir}: "
                  f"{len(eng.results)} completed, {n_run} running, "
                  f"{len(eng.queue)} queued/replayed "
                  f"({time.perf_counter() - t0:.2f}s to warm state)")
        else:
            eng = ServeEngine(params, cfg, journal=journal, **knobs)
            for i, n in enumerate(lens):
                eng.submit(Request(
                    uid=i, prompt=rng.integers(1, cfg.vocab_size,
                                               size=int(n)).astype(np.int32),
                    max_new=args.max_new))
        t0 = time.perf_counter()
        results = eng.run(snapshot_dir=args.snapshot_dir,
                          snapshot_every=args.snapshot_every or None)
        dt = time.perf_counter() - t0
        n_tok = sum(len(r.tokens) for r in results.values())
        lps = np.concatenate([r.logprobs for r in results.values()]
                             or [np.zeros((0,), np.float32)])
        by_status: dict = {}
        for r in results.values():
            by_status[r.status] = by_status.get(r.status, 0) + 1
        status = " ".join(f"{k}={v}" for k, v in sorted(by_status.items()))
        mean_lp = float(lps.mean()) if lps.size else float("nan")
        print(f"[serve] {cfg.name} engine({args.kv_mode}, guard={args.guard}"
              f", device={device}): {len(results)} requests (prompts "
              f"{lens.min()}..{lens.max()}), {n_tok} tokens in {dt:.1f}s "
              f"({n_tok / max(dt, 1e-9):.1f} tok/s), mean token logprob "
              f"{mean_lp:.4f}, status {status}")
        if results:
            print(results[sorted(results)[0]].tokens)
        if args.metrics_json:
            observer.dump_metrics(args.metrics_json)
            print(f"[serve] metrics snapshot -> {args.metrics_json}")
        if args.trace_out:
            observer.dump_trace(args.trace_out)
            print(f"[serve] Perfetto trace ({len(observer.trace.events())} "
                  f"events) -> {args.trace_out}")
        if metrics_server is not None:
            metrics_server.shutdown()
            metrics_server.server_close()
        return results
    gen = torch.Generator(device=device).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=device)
    extra = None
    if cfg.family == "vlm":
        extra = {"patches": torch.zeros(
            (args.batch, cfg.num_patches, cfg.d_model), device=device)}
        max_ctx += cfg.num_patches
    if cfg.family == "encdec":
        extra = {"frames": torch.zeros(
            (args.batch, cfg.encoder_seq, cfg.d_model), device=device)}
    t0 = time.perf_counter()
    toks, lps = greedy_generate(params, cfg, prompt, args.max_new,
                                cache_len=max_ctx, extra_inputs=extra,
                                return_logprobs=True)
    # sequence score: the compensated FF sum of the token logprobs
    total = ff.sum(lps.reshape(-1).to(torch.float32))
    mean_lp = (float(total.hi) + float(total.lo)) / lps.numel()
    dt = time.perf_counter() - t0
    print(f"[serve] {cfg.name}: generated {tuple(toks.shape)} in {dt:.1f}s "
          f"({args.batch * args.max_new / dt:.1f} tok/s), mean token "
          f"logprob {mean_lp:.4f}, device={device}")
    print(toks[0].cpu().numpy())
    return {"tokens": toks.cpu().numpy(), "logprobs": lps.cpu().numpy()}


if __name__ == "__main__":
    main()
