"""FF matmul impls: accuracy against cost, through ``repro_torch.ff.matmul``
(counterpart of the reference's ``benchmarks/table_ffmatmul.py`` default
table)::

    python -m repro_torch.benchmarks.table_ffmatmul [--mn 128] \\
        [--ks 512,4096] [--device cpu] [--out rows.json]

One row per path at each K (M = N = ``--mn``): ``naive`` (one f32 GEMM, the
control), each registered impl of the default table (``hybrid``,
``compensated``, ``split``, ``dot2``, ``ozaki``, ``f64``) and
``dispatch_default`` (what ``ff.matmul`` runs with no choice), each with the
impl it resolved to, the worst ``log2 |err| / (|A| @ |B|)`` against a
float64 GEMM on the same device, and its time per call relative to naive.
On the card, times come from CUDA events around ``--reps`` calls after a
warm-up; on the CPU from the host clock.  JSON is written only with
``--out`` (the reference's ``BENCH_ffmatmul.json`` is its own).
"""

from __future__ import annotations

import argparse
import json
import math
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

import repro_torch.ff as ff
from repro_torch import resolve_device
from repro_torch.core.ff import FF

IMPLS = ("hybrid", "compensated", "split", "dot2", "ozaki", "f64")


def time_ms(fn: Callable[[], object], device: torch.device,
            reps: int) -> float:
    """Mean ms per call of ``fn`` over ``reps`` calls, after one warm-up."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def log2_err(got: torch.Tensor, exact: torch.Tensor,
             scale: torch.Tensor) -> float:
    """Worst ``log2 |got - exact| / scale``, floored at -60."""
    err = float(((got - exact).abs() / scale).max())
    return math.log2(max(err, 2.0 ** -60))


def run(ks: Sequence[int] = (512, 4096), M: int = 128, N: int = 128,
        device=None, reps: int = 10) -> List[Dict]:
    device = resolve_device(device)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    rng = np.random.default_rng(0)
    rows: List[Dict] = []
    for K in ks:
        A = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)
                             ).to(device)
        B = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32)
                             ).to(device)
        exact = A.double() @ B.double()
        scale = A.double().abs() @ B.double().abs()
        paths: Dict[str, tuple] = {"naive": (lambda: A @ B, "naive")}
        for impl in IMPLS:
            paths[impl] = (lambda impl=impl: ff.matmul(A, B, impl=impl),
                           ff.resolve_name("matmul", impl, device))
        paths["dispatch_default"] = (lambda: ff.matmul(A, B),
                                     ff.resolve_name("matmul", None, device))
        naive_ms = None
        for name, (fn, resolved) in paths.items():
            ms = time_ms(fn, device, reps)
            out = fn()
            got = (out.hi.double() + out.lo.double() if isinstance(out, FF)
                   else out.double())
            naive_ms = ms if name == "naive" else naive_ms
            rows.append({"path": name, "M": M, "K": K, "N": N, "ms": ms,
                         "x_naive": ms / naive_ms,
                         "log2_err": log2_err(got, exact, scale),
                         "resolved_impl": resolved, "device": device.type,
                         "kind": kind, "torch": torch.__version__})
    return rows


def render(rows: List[Dict]) -> str:
    lines = [f"{'path':<18}{'resolved':<14}{'K':>6}{'ms':>12}"
             f"{'x naive':>10}{'log2 err':>10}"]
    for r in rows:
        lines.append(f"{r['path']:<18}{r['resolved_impl']:<14}{r['K']:>6}"
                     f"{r['ms']:>12.4f}{r['x_naive']:>10.2f}"
                     f"{r['log2_err']:>10.1f}")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mn", type=int, default=128, help="M = N")
    ap.add_argument("--ks", default="512,4096",
                    help="comma-separated contraction lengths")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default="", help="write the rows as JSON here")
    args = ap.parse_args(argv)
    ks = [int(k) for k in args.ks.split(",") if k]
    rows = run(ks, M=args.mn, N=args.mn, device=args.device, reps=args.reps)
    print(render(rows))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows}, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
