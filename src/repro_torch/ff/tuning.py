"""Measurement-driven dispatch tuning for ``repro_torch.ff`` (``ff.tune``;
counterpart of ``repro.ff.tuning``).

``tune()`` times the registered implementations of an op, and the block
configurations of each, per (device, shape bucket), and caches the
winners in a JSON sidecar, so that later calls consult measurements::

    ff.tune("silu", shapes=[(512, 8192)])     # times + caches, on the card
    y = ff.silu(x)                            # default = the measured winner

Winners are recorded per accuracy class, so tuning never trades accuracy
for speed silently: ``fast`` (the fastest impl that ``_FAST_ELIGIBLE``
allows to replace the default: it keeps the default's bit contract) and
``accurate`` (the fastest paper-quality impl).  ``dispatch.resolve_name``
consults the ``fast`` winner where resolution falls through to the
static default, and ``"tuned"`` / ``"tuned_accurate"`` name the winners
from any call site; ``lookup_opts`` gives the winning block
configuration of an impl chosen by name.

The table is keyed ``cuda/<op>`` and ``cpu/<op>`` (the device of the
call).  The sidecar is the port's own, ``FF_TUNE_torch.json`` at the root
of the checkout or ``$REPRO_TORCH_FF_TUNE_CACHE``, never the reference's
``FF_TUNE.json``; its meta records the card and the torch version.  A
cached bucket is trusted as it is: a second ``tune()`` is a pure cache
hit (``force=True`` re-measures).  Unlike the reference, a candidate
that raises is not skipped: the error propagates.
"""

from __future__ import annotations

import json
import os
import time
import warnings
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs

CACHE_ENV = "REPRO_TORCH_FF_TUNE_CACHE"
SIDECAR = "FF_TUNE_torch.json"

# accuracy tier of each matmul impl (relative error against |A||B|): fast
# ~2^-24 (the naive class or better), accurate ~2^-44 (paper quality)
ACCURACY_CLASS: Dict[str, str] = {
    "hybrid": "fast",
    "pallas_hybrid": "fast",
    "compensated": "fast",
    "split": "fast",
    "dot2": "accurate",
    "pallas_dot2": "accurate",
    "ozaki": "accurate",
    "pallas_ozaki": "accurate",
    "f64": "accurate",
    "sharded": "fast",
    "sharded_accurate": "accurate",
}

# per-op tiers beyond matmul: sloppy Add22 has no relative bound under
# cancellation (only "accurate" is in the accurate tier); the ff.math
# family's jnp/pallas/f64 meet the FF contract, "fast" is the f32
# builtin; the softmax/logsumexp impls with f32-builtin exponentials are
# the fast class, "ff" the accurate tier
_MATH_TIER = {"jnp": "accurate", "pallas": "accurate", "f64": "accurate",
              "fast": "fast"}
_OP_ACCURACY: Dict[str, Dict[str, str]] = {
    "matmul": ACCURACY_CLASS,
    "add": {"jnp": "fast", "pallas": "fast", "accurate": "accurate"},
    "softmax": {"jnp": "fast", "pallas": "fast", "f64": "fast",
                "ff": "accurate"},
    "logsumexp": {"jnp": "fast", "pallas": "fast", "f64": "fast",
                  "ff": "accurate"},
    "attention": {"fast": "fast", "ff": "accurate", "pallas": "accurate",
                  "f64": "accurate"},
    **{op: _MATH_TIER for op in ("exp", "expm1", "log", "log1p", "tanh",
                                 "sigmoid", "erf", "gelu", "silu", "pow")},
}


def accuracy_class(op: str, impl: str) -> str:
    return _OP_ACCURACY.get(op, {}).get(impl, "accurate")


# block configurations swept per matmul impl
SWEEP_CONFIGS: Dict[str, List[dict]] = {
    "hybrid": [{"block_k": 256}, {"block_k": 512}, {"block_k": 1024},
               {"block_k": 2048}],
    "compensated": [{"block_k": 512}, {"block_k": 1024}],
    "split": [{"block_k": 512}, {"block_k": 1024}],
    "dot2": [{}],
    "f64": [{}],
    "ozaki": [{"block_k": 512}, {"block_k": 1024}],
    "pallas_hybrid": [{"bk": 512}],
    "pallas_dot2": [{}],
    "pallas_ozaki": [{"bk": 512}],
}

# which impls may be crowned the fast (default-replacing) winner, per op:
# within the op's bit contract ("cascade" sums in another order, the
# "accurate" Add22 is another algorithm, the "fast" math tier and the
# accurate "ff" composites change bits); ops absent allow any timed impl
_FAST_ELIGIBLE: Dict[str, Tuple[str, ...]] = {
    "sum": ("blocked", "pallas_rowsum"),
    "add": ("jnp", "pallas"),
    "softmax": ("jnp", "pallas", "f64"),
    "logsumexp": ("jnp", "pallas", "f64"),
    "attention": ("fast",),
    **{op: ("jnp", "pallas", "f64") for op in
       ("exp", "expm1", "log", "log1p", "tanh", "sigmoid", "erf", "gelu",
        "silu", "pow")},
}

# elementwise / reduction family: sweeps only over knobs that cannot
# change result bits (tile shapes; the jnp reduction "block" would, and
# is not swept)
_EW_BLOCKS = [{"block": (128, 512)}, {"block": (256, 512)},
              {"block": (512, 512)}]
_ROW_BLOCKS = [{"br": 128}, {"br": 256}]
_MATH_BLOCKS = [{"block": (64, 512)}, {"block": (128, 512)},
                {"block": (256, 512)}]
SWEEP_CONFIGS_BY_OP: Dict[str, Dict[str, List[dict]]] = {
    "matmul": SWEEP_CONFIGS,
    "add": {"pallas": _EW_BLOCKS},
    "mul": {"pallas": _EW_BLOCKS},
    "div": {"pallas": _EW_BLOCKS},
    "sqrt": {"pallas": _EW_BLOCKS},
    "sum": {"pallas_rowsum": [{"br": 256, "bc": 512},
                              {"br": 512, "bc": 512}]},
    "logsumexp": {"pallas": _ROW_BLOCKS, "ff": _ROW_BLOCKS},
    "softmax": {"pallas": _ROW_BLOCKS, "ff": _ROW_BLOCKS},
    "norm_stats": {"pallas": _ROW_BLOCKS},
    **{op: {"pallas": _MATH_BLOCKS} for op in
       ("exp", "expm1", "log", "log1p", "tanh", "sigmoid", "erf", "gelu",
        "silu", "pow")},
}


def _sweep(op: str, impl: str) -> List[dict]:
    return SWEEP_CONFIGS_BY_OP.get(op, {}).get(impl, [{}])


# -- per-op operand builders: (rng, dims, device) -> (args, static kwargs);
# the reference's, from the same numpy stream -------------------------------

def _t(x: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(x).to(device)


def _ff_pair(rng, shape, device, positive=False):
    from repro_torch.core.ff import FF
    h = rng.standard_normal(shape).astype(np.float32)
    if positive:
        h = np.abs(h) + 0.5
    lo = (h * 1e-8 * rng.standard_normal(shape)).astype(np.float32)
    return FF(_t(h, device), _t(lo, device))


def _f32(rng, shape, device):
    return _t(rng.standard_normal(shape).astype(np.float32), device)


def _args_matmul(rng, dims, device):
    M, K, N = dims
    return (_f32(rng, (M, K), device), _f32(rng, (K, N), device)), {}


def _args_ew2(positive=False):
    def mk(rng, dims, device):
        return (_ff_pair(rng, tuple(dims), device, positive),
                _ff_pair(rng, tuple(dims), device, positive)), {}
    return mk


def _args_ew1(rng, dims, device):
    return (_ff_pair(rng, tuple(dims), device, positive=True),), {}


def _args_row(rng, dims, device):
    return (_f32(rng, tuple(dims), device),), {"axis": -1}


def _args_stats(rng, dims, device):
    return (_f32(rng, tuple(dims), device),), {}


def _args_attention(rng, dims, device):
    """(R, C) bucket -> q (1, R, 4, 64), k/v (1, C, 2, 64)."""
    r, c = int(dims[0]), int(dims[1])
    q = _f32(rng, (1, r, 4, 64), device)
    k = _f32(rng, (1, c, 2, 64), device)
    v = _f32(rng, (1, c, 2, 64), device)
    return (q, k, v), {"causal": True}


def _args_adamw(rng, dims, device):
    shape = tuple(dims)
    scal = (torch.tensor(s, dtype=torch.float32, device=device)
            for s in (1e-3, 0.9, 0.95, 0.1, 0.05))
    args = (_f32(rng, shape, device),                 # g
            _f32(rng, shape, device) * 0.1,           # m
            torch.abs(_f32(rng, shape, device)) * 0.01,  # v
            _f32(rng, shape, device),                 # w
            _f32(rng, shape, device) * 1e-8,          # wlo
            *scal)
    return args, {"eps": 1e-8, "wd": 0.1}


def _args_pow(rng, dims, device):
    return (_ff_pair(rng, tuple(dims), device, positive=True),
            _ff_pair(rng, tuple(dims), device)), {}


_TUNE_ARGS: Dict[str, Callable] = {
    "matmul": _args_matmul,
    "add": _args_ew2(),
    "mul": _args_ew2(),
    "div": _args_ew2(positive=True),
    "sqrt": _args_ew1,
    "sum": _args_row,
    "logsumexp": _args_row,
    "softmax": _args_row,
    "mean_sq": _args_stats,
    "norm_stats": _args_stats,
    "attention": _args_attention,
    "adamw_update": _args_adamw,
    **{op: _args_ew1 for op in ("exp", "expm1", "log", "log1p", "tanh",
                                "sigmoid", "erf", "gelu", "silu")},
    "pow": _args_pow,
}

_TABLE: Dict[str, dict] = {}     # "<device>/<op>" -> bucket -> record
_LOADED_FROM: Optional[str] = None


def default_cache_path() -> str:
    """``$REPRO_TORCH_FF_TUNE_CACHE``, else ``FF_TUNE_torch.json`` at the
    root of the checkout (the working directory outside one)."""
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.abspath(os.path.join(here, "..", "..", ".."))
    if os.path.isdir(os.path.join(root, "src")):
        return os.path.join(root, SIDECAR)
    return os.path.join(os.getcwd(), SIDECAR)


def _pow2_bucket(x: int) -> int:
    b = 1
    while b < x:
        b <<= 1
    return b


def bucket_key(shape: Sequence[int]) -> str:
    """Shape bucket: dims rounded up to powers of two."""
    return "x".join(str(_pow2_bucket(int(d))) for d in shape)


def _dev(device) -> str:
    return torch.device(device if device is not None else "cpu").type


def _bucket_store(op: str, device, create: bool = False) -> dict:
    key = f"{_dev(device)}/{op}"
    if create:
        return _TABLE.setdefault(key, {})
    return _TABLE.get(key, {})


def clear() -> None:
    """Drop the in-memory table (the sidecar is untouched); the next
    lookup loads the sidecar again."""
    global _LOADED_FROM
    _TABLE.clear()
    _LOADED_FROM = None


def _warn_tune(msg: str) -> None:
    from repro_torch.ff.guard import FFTuneWarning
    obs.record("record_warning", "tune")
    warnings.warn(msg, FFTuneWarning, stacklevel=3)


def load(path: Optional[str] = None) -> dict:
    """Merge the sidecar into the in-memory table.  A malformed sidecar
    never takes dispatch down: it warns (``FFTuneWarning``) and keeps the
    well-formed ``device/op`` entries.  The path counts as loaded even
    when the file is missing or bad, so it is read (and warned about)
    once, not on every dispatch."""
    global _LOADED_FROM
    path = path or default_cache_path()
    _LOADED_FROM = path
    if not os.path.exists(path):
        return dict(_TABLE)
    try:
        with open(path) as f:
            payload = json.load(f)
    except (json.JSONDecodeError, OSError, UnicodeDecodeError) as e:
        _warn_tune(f"FF_TUNE sidecar {path!r} is unreadable "
                   f"({type(e).__name__}: {e}); falling back to static "
                   f"dispatch defaults")
        return dict(_TABLE)
    table = payload.get("table") if isinstance(payload, dict) else None
    if not isinstance(table, dict):
        _warn_tune(f"FF_TUNE sidecar {path!r} has no 'table' mapping; "
                   f"falling back to static dispatch defaults")
        return dict(_TABLE)
    dropped = 0
    for key, buckets in table.items():
        if not (isinstance(key, str) and isinstance(buckets, dict)
                and all(isinstance(b, str) and isinstance(rec, dict)
                        for b, rec in buckets.items())):
            dropped += 1
            continue
        _TABLE.setdefault(key, {}).update(buckets)
    if dropped:
        _warn_tune(f"FF_TUNE sidecar {path!r}: dropped {dropped} malformed "
                   f"table entr{'y' if dropped == 1 else 'ies'} (kept "
                   f"{len(table) - dropped}); static defaults cover the "
                   f"rest")
    return dict(_TABLE)


def save(path: Optional[str] = None, device=None) -> str:
    """Write the table atomically (``<path>.tmp``, fsync, ``os.replace``);
    the meta names the device the caller tuned on and torch's version."""
    path = path or _LOADED_FROM or default_cache_path()
    dev = torch.device(device if device is not None else "cpu")
    payload = {
        "meta": {
            "device": dev.type,
            "card": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "torch": torch.__version__,
            "format": 1,
        },
        "table": _TABLE,
    }
    tmp = path + ".tmp"
    try:
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def _ensure_loaded() -> None:
    if _LOADED_FROM is None and not _TABLE:
        load()


def lookup(op: str, shape: Sequence[int], accuracy: str = "fast",
           device=None) -> Optional[dict]:
    """The tuned winner record {"impl", "opts", "us"} of the class
    ``accuracy`` for the shape bucket on ``device`` (None: none)."""
    _ensure_loaded()
    rec = _bucket_store(op, device).get(bucket_key(shape))
    obs.record("record_tune_lookup",
               bool(rec) and rec.get(accuracy) is not None)
    return rec.get(accuracy) if rec else None


def lookup_impl(op: str, shape: Sequence[int], accuracy: str = "fast",
                device=None) -> Optional[str]:
    rec = lookup(op, shape, accuracy, device)
    return rec["impl"] if rec else None


def _detuple(opts: dict) -> dict:
    """JSON gives tuples back as lists; block shapes come back as tuples."""
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in opts.items()}


def lookup_opts(op: str, impl: str, shape: Sequence[int],
                device=None) -> dict:
    """Measured-best block config for an impl chosen by name (may be {})."""
    _ensure_loaded()
    rec = _bucket_store(op, device).get(bucket_key(shape))
    if rec:
        per = rec.get("impls", {}).get(impl)
        if per:
            return _detuple(per.get("opts", {}))
    return {}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_interleaved(fns: Sequence[Callable], args, reps: int, *,
                     device, rounds: int = 5,
                     sample_target_s: float = 0.03, rep_cap: int = 0,
                     min_reps: int = 2) -> List[Tuple[float, float]]:
    """Time each candidate ``fn(*args)``: once per round, in a fresh
    (deterministic) shuffled order each round after the first, so that
    no candidate always follows the same one.  Each sample runs a
    time-targeted number of calls (``sample_target_s`` from a warm-up
    estimate, at least ``min_reps``, at most ``rep_cap``, default
    ``6 * reps``) between two synchronisations of ``device`` (the card
    runs asynchronously), on the host clock.

    Returns, per candidate, ``(min_s, median_s)`` per call across rounds.
    Unlike the reference, a candidate that raises is not skipped: the
    error propagates."""
    device = torch.device(device)
    nreps: List[int] = []
    for fn in fns:
        fn(*args)                                  # warm (and build)
        _sync(device)
        t0 = time.perf_counter()
        fn(*args)
        _sync(device)
        est = time.perf_counter() - t0
        cap = rep_cap or 6 * reps
        nreps.append(max(min_reps,
                         min(cap, int(sample_target_s / max(est, 1e-7)))))
    samples: List[List[float]] = [[] for _ in fns]
    order = list(range(len(fns)))
    shuffler = np.random.default_rng(0)
    for r in range(rounds):
        for i in (order if r == 0 else list(shuffler.permutation(order))):
            _sync(device)
            t0 = time.perf_counter()
            for _ in range(nreps[i]):
                fns[i](*args)
            _sync(device)
            samples[i].append((time.perf_counter() - t0) / nreps[i])
    out: List[Tuple[float, float]] = []
    for s in samples:
        s = sorted(s)
        out.append((s[0], s[len(s) // 2]))
    return out


def _time_candidates(fns: Sequence[Callable], args, reps: int, device,
                     rounds: int = 5) -> List[float]:
    """Tune's view of :func:`time_interleaved`: min-of-rounds per
    candidate (a module attribute, so a test can check that a cached
    bucket is never re-timed)."""
    return [r[0] for r in time_interleaved(fns, args, reps, device=device,
                                           rounds=rounds)]


def tune(op: str = "matmul",
         shapes: Optional[Iterable[Sequence[int]]] = None,
         impls: Optional[Sequence[str]] = None,
         reps: int = 5,
         cache: Optional[str] = None,
         force: bool = False,
         device=None) -> dict:
    """Time the registered ``op`` impls x block configs per shape bucket
    on ``device`` (None: the CUDA card; raises without one), cache and
    return the winners.  A bucket already in the cache is returned
    without re-timing unless ``force``.

    ``shapes``: shape tuples to bucket and measure (default: a small and
    a large bucket of the op's family, (M, K, N) for matmul, (R, C)
    otherwise).  ``impls``: the impl names to time (default: every
    registered impl, without the ``pallas*`` kernel tiers off the card,
    as the reference leaves out interpret-mode Pallas off the TPU).
    ``cache``: the sidecar (default :func:`default_cache_path`).

    Returns ``{"table": <op's buckets on device>, "cache": <path>}``.
    Each record holds every timed impl's best config and µs (``impls``),
    the ``fast`` winner among ``_FAST_ELIGIBLE`` impls (none if none was
    timed: the static default keeps its bits) and the ``accurate``
    winner among accurate-class impls."""
    from repro_torch import resolve_device
    from repro_torch.ff import dispatch

    if op not in _TUNE_ARGS:
        raise NotImplementedError(
            f"ff.tune has no operand builder for {op!r}; tunable: "
            f"{tuple(sorted(_TUNE_ARGS))}")
    dev = resolve_device(device)
    if shapes is None:
        shapes = (((128, 512, 128), (128, 4096, 128)) if op == "matmul"
                  else ((256, 1024), (4096, 4096)))
    if cache or not _TABLE:
        load(cache)
    store = _bucket_store(op, dev, create=True)
    if impls:
        names = tuple(impls)
    else:
        names = tuple(n for n in dispatch.impls(op)
                      if not n.startswith("sharded")
                      and (dev.type == "cuda" or not n.startswith("pallas")))
    rng = np.random.default_rng(0)

    for shape in shapes:
        key = bucket_key(shape)
        if key in store and not force:
            continue
        dims = tuple(int(d) for d in key.split("x"))
        args, static_kw = _TUNE_ARGS[op](rng, dims, dev)
        cands: List[Tuple[str, dict]] = []
        calls = []
        for name in names:
            fn = dispatch.lookup(op, name)
            for cfg in _sweep(op, name):
                cands.append((name, dict(cfg)))
                calls.append(lambda *a, fn=fn, cfg=cfg: fn(*a, **static_kw,
                                                           **cfg))
        times = _time_candidates(calls, args, reps, dev)
        per_impl: Dict[str, dict] = {}
        for (name, cfg), t in zip(cands, times):
            if name not in per_impl or t * 1e6 < per_impl[name]["us"]:
                per_impl[name] = {"opts": cfg, "us": t * 1e6}
        rec: Dict[str, dict] = {"impls": per_impl}
        pool = [n for n in per_impl if n in _FAST_ELIGIBLE.get(op, per_impl)]
        if pool:
            fast = min(pool, key=lambda n: per_impl[n]["us"])
            rec["fast"] = {"impl": fast, **per_impl[fast]}
        acc_names = [n for n in per_impl
                     if accuracy_class(op, n) == "accurate"]
        if acc_names:
            acc = min(acc_names, key=lambda n: per_impl[n]["us"])
            rec["accurate"] = {"impl": acc, **per_impl[acc]}
        store[key] = rec
        del args

    path = save(cache, dev)
    return {"table": dict(_bucket_store(op, dev)), "cache": path}
