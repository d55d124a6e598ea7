"""Fused FF chains against op-by-op streaming, through the port's dispatch
(counterpart of the reference's ``benchmarks/table_elementwise.py``)::

    python -m repro_torch.benchmarks.table_elementwise \\
        [--shapes 256x1024,4096x4096,512x2048] [--chains softmax,axpy] \\
        [--device cpu] [--reps 5] [--rounds 9] [--out rows.json]

Six chains, each at every (R, C) shape, in three arms:

  * ``fused``: ONE dispatched call (``ff.adamw_update``, ``ff.softmax``,
    ``ff.logsumexp``, ``ff.mean_sq``, ``ff.norm_stats``, or an
    ``ff.fused`` chain for ``axpy``) — one kernel launch on the card;
  * ``unfused``: the same chain written op by op through the port's
    dispatch and run eagerly, each op its own pass over memory;
  * ``library``: one PyTorch call for the same function in f32, where
    there is one (``torch.optim.AdamW(fused=True)``, ``torch.softmax``,
    ``torch.logsumexp``, ``torch.linalg.vecdot(x, x) / C``,
    ``torch.var_mean``); a yardstick of speed, without FF accuracy.

Every row records the resolved fused impl, the arms' times (min over
rounds of ``repro_torch.ff.tuning.time_interleaved``), ``speedup`` =
unfused / fused, and ``max_ulp_diff``, the worst difference between the
fused and unfused primary outputs in units of the unfused output's f32
ulp; a chain beyond its ``ULP_TOL`` raises.  The shapes are the
reference's two defaults and granite-3-2b's d_model rows of one 4 x 128
token step.  JSON is written only with ``--out`` (the reference's
``BENCH_elementwise.json`` is its own).
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

import repro_torch.ff as ff
from repro_torch import resolve_device
from repro_torch.core.ff import FF, sqrt_rn
from repro_torch.ff.tuning import time_interleaved

SHAPES = ((256, 1024), (4096, 4096), (512, 2048))
# reduction chains may differ from the op-by-op chain by the final
# rounding ulp (two compensated summation orders); elementwise chains by 0
ULP_TOL = {"adamw": 0.0, "axpy": 0.0, "softmax": 2.0, "logsumexp": 1.0,
           "rmsnorm_stats": 1.0, "norm_stats": 2.0}


def _ulp_diff(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float((np.abs(a - b) / np.spacing(np.maximum(
        np.abs(b), np.float32(1e-30)))).max())


# --------------------------------------------------------------------------
# chains: each factory returns dict(make, fused, unfused, library, resolved,
# primary).  ``make()`` gives fresh inputs on the device (the AdamW arms
# update theirs in place); ``primary(out)`` the f32 output both arms are
# compared on.  ``unfused`` runs eagerly, one dispatch per operator.
# --------------------------------------------------------------------------

def _on(dev):
    return lambda a: torch.from_numpy(a).to(dev, copy=True)  # noqa: E731


def _mk_adamw(rng, R, C, dev):
    sh = (R, C)
    host = (rng.standard_normal(sh).astype(np.float32),
            (rng.standard_normal(sh) * 0.1).astype(np.float32),
            np.abs(rng.standard_normal(sh) * 0.01).astype(np.float32),
            rng.standard_normal(sh).astype(np.float32),
            (rng.standard_normal(sh) * 1e-8).astype(np.float32))
    lr, b1, b2, bc1, bc2 = (torch.tensor(s, dtype=torch.float32, device=dev)
                            for s in (1e-3, 0.9, 0.95, 0.1, 0.05))
    eps, wd = 1e-8, 0.1

    def op_by_op(g, m, v, w, wlo):
        # the AdamW leaf op by op (sqrt_rn: the correctly rounded root)
        m2 = b1 * m + (1.0 - b1) * g
        v2 = b2 * v + (1.0 - b2) * g * g
        u = (m2 / bc1) / (sqrt_rn(v2 / bc2) + eps)
        u = u + wd * w
        d = -lr * u
        new = ff.add(FF(w, wlo), d)
        return new.hi, new.lo, m2, v2

    def chain(g, m, v, w, wlo):
        ff.adamw_update(g, m, v, w, wlo, lr, b1, b2, bc1, bc2, eps=eps,
                        wd=wd)                       # in place
        return w, wlo, m, v

    def library(g, m, v, w, wlo):
        p = torch.nn.Parameter(w)
        p.grad = g
        opt = torch.optim.AdamW([p], lr=1e-3, betas=(0.9, 0.95), eps=eps,
                                weight_decay=wd, fused=True)
        return lambda: opt.step()

    return {"make": lambda: tuple(map(_on(dev), host)), "fused": chain,
            "unfused": op_by_op, "library": library,
            "resolved": ff.resolve_name("adamw_update", None, dev),
            "primary": lambda out: out[0]}


def _x(rng, R, C, dev):
    x = rng.standard_normal((R, C)).astype(np.float32)
    return lambda: (_on(dev)(x),)


def _mk_softmax(rng, R, C, dev):
    def op_by_op(x):
        m = torch.amax(x, dim=-1, keepdim=True)
        e = torch.exp(x - m)
        s = ff.sum(e, axis=-1, block=256)
        return e / s.to_f32()[..., None]

    return {"make": _x(rng, R, C, dev), "fused": lambda x: ff.softmax(x),
            "unfused": op_by_op,
            "library": lambda x: lambda: torch.softmax(x, -1),
            "resolved": ff.resolve_name("softmax", None, dev),
            "primary": lambda out: out}


def _mk_logsumexp(rng, R, C, dev):
    def op_by_op(x):
        m = torch.amax(x, dim=-1, keepdim=True)
        e = torch.exp(x - m)
        s = ff.sum(e, axis=-1, block=256)
        return m.squeeze(-1) + torch.log(s.to_f32())

    return {"make": _x(rng, R, C, dev), "fused": lambda x: ff.logsumexp(x),
            "unfused": op_by_op,
            "library": lambda x: lambda: torch.logsumexp(x, -1),
            "resolved": ff.resolve_name("logsumexp", None, dev),
            "primary": lambda out: out}


def _mk_rmsnorm_stats(rng, R, C, dev):
    n = torch.tensor(float(C), device=dev)    # an IEEE division on the card

    def op_by_op(x):
        return ff.sum(x * x, axis=-1, block=128).to_f32() / n

    return {"make": _x(rng, R, C, dev), "fused": lambda x: ff.mean_sq(x),
            "unfused": op_by_op,
            "library": lambda x: lambda: torch.linalg.vecdot(x, x) / C,
            "resolved": ff.resolve_name("mean_sq", None, dev),
            "primary": lambda out: out}


def _mk_norm_stats(rng, R, C, dev):
    n = torch.tensor(float(C), device=dev)    # an IEEE division on the card

    def op_by_op(x):
        mu = ff.sum(x, axis=-1, block=128).to_f32() / n
        d = x - mu[..., None]
        var = ff.sum(d * d, axis=-1, block=128).to_f32() / n
        return mu, var

    return {"make": _x(rng, R, C, dev), "fused": lambda x: ff.norm_stats(x),
            "unfused": op_by_op,
            "library": lambda x: lambda: torch.var_mean(x, -1,
                                                        correction=0),
            "resolved": ff.resolve_name("norm_stats", None, dev),
            "primary": lambda out: out[1]}


def _mk_axpy(rng, R, C, dev):
    """The generic ff.fused chain: z = a*x + y over FF tensors."""
    sh = (R, C)
    xh = rng.standard_normal(sh).astype(np.float32)
    yh = rng.standard_normal(sh).astype(np.float32)
    host = (xh, (xh * 1e-8 * rng.standard_normal(sh)).astype(np.float32),
            yh, (yh * 1e-8 * rng.standard_normal(sh)).astype(np.float32))
    a = torch.tensor(1.618, dtype=torch.float32, device=dev)
    chain = ff.fused(lambda a, x, y: a * x + y)

    def op_by_op(xh, xl, yh, yl):
        return ff.add(ff.mul(FF(xh, xl), a), FF(yh, yl)).astuple()

    return {"make": lambda: tuple(map(_on(dev), host)),
            "fused": lambda xh, xl, yh, yl: chain(
                a, FF(xh, xl), FF(yh, yl)).astuple(),
            "unfused": op_by_op, "library": None,
            "resolved": f"fused({'cuda' if dev.type == 'cuda' else 'torch'})",
            "primary": lambda out: out[0]}


CHAINS: Dict[str, Callable] = {
    "adamw": _mk_adamw,
    "softmax": _mk_softmax,
    "logsumexp": _mk_logsumexp,
    "rmsnorm_stats": _mk_rmsnorm_stats,
    "norm_stats": _mk_norm_stats,
    "axpy": _mk_axpy,
}


def _host(out) -> np.ndarray:
    return out.detach().cpu().numpy()


def run(shapes: Sequence[Tuple[int, int]] = SHAPES,
        chains: Optional[Sequence[str]] = None, device=None,
        reps: int = 5, rounds: int = 9) -> List[Dict]:
    device = resolve_device(device)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    rng = np.random.default_rng(0)
    rows: List[Dict] = []
    for R, C in shapes:
        for name in (chains or CHAINS):
            spec = CHAINS[name](rng, R, C, device)
            # the precision contract: fused against op by op, each on its
            # own fresh inputs (the AdamW arms update theirs in place)
            out_f = _host(spec["primary"](spec["fused"](*spec["make"]())))
            out_u = _host(spec["primary"](spec["unfused"](*spec["make"]())))
            ulp = _ulp_diff(out_f, out_u)
            # each arm times on inputs of its own
            arms = ["fused", "unfused"]
            calls = [lambda fn=spec[a], x=spec["make"](): fn(*x)
                     for a in arms]
            if spec["library"] is not None:
                arms.append("library")
                calls.append(spec["library"](*spec["make"]()))
            res = time_interleaved(calls, (), reps, device=device,
                                   rounds=rounds, sample_target_s=0.05,
                                   rep_cap=25 * reps, min_reps=2)
            t = {a: r[0] for a, r in zip(arms, res)}
            rows.append({
                "chain": name, "R": R, "C": C,
                "us_fused": t["fused"] * 1e6,
                "us_unfused": t["unfused"] * 1e6,
                "us_library": (t["library"] * 1e6 if "library" in t
                               else None),
                "speedup": t["unfused"] / t["fused"],
                "resolved_impl": spec["resolved"],
                "max_ulp_diff": ulp,
                "ulp_tol": ULP_TOL[name],
                "device": device.type, "kind": kind,
                "torch": torch.__version__,
            })
            if ulp > ULP_TOL[name]:
                raise AssertionError(
                    f"fused {name} diverged from the op-by-op path by "
                    f"{ulp:.1f} ulp (allowed {ULP_TOL[name]}) at "
                    f"({R}, {C}): precision regression")
    return rows


def render(rows: List[Dict]) -> str:
    lines = [f"{'chain':<15}{'RxC':>11}{'us fused':>12}{'us unfused':>13}"
             f"{'us library':>12}{'speedup':>9}{'ulp':>5}  resolved"]
    for r in rows:
        lib = ("-" if r["us_library"] is None
               else f"{r['us_library']:.1f}")
        lines.append(f"{r['chain']:<15}{r['R']:>5}x{r['C']:<5}"
                     f"{r['us_fused']:>12.1f}{r['us_unfused']:>13.1f}"
                     f"{lib:>12}{r['speedup']:>8.2f}x"
                     f"{r['max_ulp_diff']:>5.1f}  {r['resolved_impl']}")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default=",".join(f"{r}x{c}"
                                                 for r, c in SHAPES),
                    help="comma-separated RxC shapes")
    ap.add_argument("--chains", default="",
                    help="comma-separated subset of chains to bench")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=9)
    ap.add_argument("--out", default="", help="write the rows as JSON here")
    args = ap.parse_args(argv)
    shapes = tuple(tuple(int(d) for d in s.split("x"))
                   for s in args.shapes.split(",") if s)
    chains = tuple(c for c in args.chains.split(",") if c) or None
    rows = run(shapes, chains, device=args.device, reps=args.reps,
               rounds=args.rounds)
    print(render(rows))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows}, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
