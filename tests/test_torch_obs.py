"""The port's ``obs`` tier against the reference's ``repro.obs``.

  * the registry and the trace recorder are copies: the same calls give
    equal snapshots, deltas, JSON and Prometheus text, equal span
    structures and equal Chrome traces;
  * the engine: port and reference engines serve the same model and
    requests (the config, weights and policy scopes of
    ``tests/test_torch_serve_durable.py``) under ``sync_every`` 1 and 4
    and record the same request, token and guard counts, histogram
    counts, final gauges and span structure; the port's decode-step
    histogram is ``decode_s``;
  * the hooks: guard violations accumulate past the warn-once, tune
    lookups count hits and misses, the journal's event counts and the
    dispatch resolutions' series are the reference's (the port counts a
    resolution on every call, the same event as ``RESOLUTIONS``);
  * ``annotate`` is a no-op outside ``obs.enable()`` and names a
    ``torch.profiler`` range inside it;
  * a restored engine resumes its guard counts in its metrics.

Local generators only; counts compared exactly.
"""

import contextlib
import json
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ff as ref_ff
import repro_torch.ff as port_ff
from repro import obs as ref_obs
from repro.ff import tuning as ref_tuning
from repro.ff.guard import GuardScope as RefGuardScope
from repro.obs.registry import MetricsRegistry as RefRegistry
from repro.obs.trace import TraceRecorder as RefTrace
from repro.serve import Request as RefRequest
from repro_torch import obs
from repro_torch.ff import dispatch
from repro_torch.ff import tuning as port_tuning
from repro_torch.ff.guard import FFGuardWarning, GuardScope
from repro_torch.obs.registry import LOG2_BUCKETS, MetricsRegistry
from repro_torch.obs.trace import TraceRecorder
from repro_torch.serve import GUARD_STAT_KEYS, Request, ServeEngine
from test_torch_serve_durable import (FIELDS, PORT_CFG,  # noqa: F401
                                      _port_engine, _ref_engine, _ref_scope,
                                      weights)


# --------------------------------------------------------------------------
# the registry and the trace: copies of the reference's
# --------------------------------------------------------------------------

def _registry_calls(seed, n=60):
    """A seeded sequence of (kind, name, labels, op, value) calls, with
    values spread over every histogram bucket, zero, NaN and +Inf."""
    rng = np.random.default_rng(seed)
    names = {"counter": ("req_total", "tok_total"),
             "gauge": ("depth", "pages"),
             "histogram": ("lat_seconds", "flush_seconds")}
    calls = []
    for _ in range(n):
        kind = ("counter", "gauge", "histogram")[rng.integers(3)]
        name = names[kind][rng.integers(2)]
        labels = {} if rng.integers(3) == 0 else {
            "status": ("OK", "TIMEOUT", "DEGRADED")[rng.integers(3)]}
        if rng.integers(4) == 0:
            labels["op"] = ("add", "matmul")[rng.integers(2)]
        if kind == "counter":
            calls.append((kind, name, labels, "inc", int(rng.integers(1, 5))))
        elif kind == "gauge":
            op = ("set", "inc")[rng.integers(2)]
            calls.append((kind, name, labels, op,
                          float(rng.standard_normal() * 10)))
        else:
            e = rng.uniform(-24, 9)
            v = (0.0, float("nan"), float("inf"))[rng.integers(3)] \
                if rng.integers(8) == 0 else float(2.0 ** e)
            calls.append((kind, name, labels, "observe", v))
    return calls


def _apply(reg, calls):
    for kind, name, labels, op, v in calls:
        getattr(getattr(reg, kind)(name, **labels), op)(v)


def _same(a, b):
    """Equal, NaN == NaN (a histogram sum may be NaN)."""
    return json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_matches_reference(seed):
    calls = _registry_calls(seed)
    ref, port = RefRegistry(), MetricsRegistry()
    _apply(ref, calls[:30])
    _apply(port, calls[:30])
    prev_r, prev_p = ref.snapshot(), port.snapshot()
    assert _same(prev_r, prev_p)
    _apply(ref, calls[30:])
    _apply(port, calls[30:])
    assert _same(port.snapshot(), ref.snapshot())
    assert _same(port.delta(prev_p), ref.delta(prev_r))
    assert _same(port.delta(None), ref.delta(None))
    assert port.to_json() == ref.to_json()
    assert port.to_json(indent=None) == ref.to_json(indent=None)
    assert port.to_prometheus() == ref.to_prometheus()
    hist = port.snapshot()["histograms"]
    assert all(len(h["buckets"]) == len(LOG2_BUCKETS) + 1
               for h in hist.values())


def _trace_calls(rec, explicit_ts):
    """One request's lifecycle and engine events, with explicit or
    recorder-clock timestamps."""
    def ts(t):
        return {"ts_us": float(t)} if explicit_ts else {}
    for uid in (0, 3):
        rec.name_request_track(uid)
        tid = rec.request_tid(uid)
        base = 100.0 * (uid + 1)
        t0 = base if explicit_ts else rec.now()
        rec.complete("queued", t0, 5.0, tid=tid)
        rec.complete("prefill", t0 + 5, 7.5, tid=tid,
                     args={"prompt_len": 9})
        rec.complete("decode", t0 + 12.5, 40.0, tid=tid)
        rec.complete("request", t0, 60.0, tid=tid,
                     args={"status": ("OK", "DEGRADED")[uid % 2],
                           "uid": uid, "tokens": 6, "detail": ""})
        rec.instant("preempt", args={"uid": uid}, **ts(base + 20))
        rec.counter("queue", {"depth": uid, "active": 1}, **ts(base + 30))
    rec.instant("host_sync", args={"steps": 4}, **ts(999.0))
    rec.complete("negative", 1.0, -3.0)          # dur clamps to 0


@pytest.mark.parametrize("explicit_ts", [True, False])
def test_trace_matches_reference(explicit_ts, tmp_path):
    ref, port = RefTrace(), TraceRecorder()
    _trace_calls(ref, explicit_ts)
    _trace_calls(port, explicit_ts)
    assert port.span_structure() == ref.span_structure()
    got, want = port.to_chrome_trace(), ref.to_chrome_trace()
    assert got["displayTimeUnit"] == want["displayTimeUnit"] == "ms"

    def strip(evs):
        key = (lambda e: (e["ph"] != "M", e["ts"])) if explicit_ts else \
            (lambda e: (e["ph"], e["tid"], e["name"]))
        return [{k: v for k, v in e.items()
                 if explicit_ts or k not in ("ts", "dur")}
                for e in sorted(evs, key=key)]
    assert strip(got["traceEvents"]) == strip(want["traceEvents"])
    if explicit_ts:
        assert got == want
    port.dump(str(tmp_path / "t.json"))
    with open(tmp_path / "t.json") as f:
        assert json.load(f) == json.loads(json.dumps(got))


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------

def _obs_reqs(seed=41, n=3, max_new=6, lens=(9, 14, 9)):
    """``n`` requests; two prompt lengths (each length the reference
    engine sees costs it a prefill compile), the third request queued
    behind the first two."""
    rng = np.random.default_rng(seed)
    return [dict(uid=i, prompt=rng.integers(1, FIELDS["vocab_size"],
                                            size=lens[i]).astype(np.int32),
                 max_new=max_new) for i in range(n)]


def _engine_view(snap):
    """What two engines' metrics must share: the counters, the histograms'
    counts, the gauges."""
    return (snap["counters"], snap["gauges"],
            {k: h["count"] for k, h in snap["histograms"].items()})


@pytest.mark.parametrize("sync_every", [1, 4])
def test_engine_metrics_and_spans_match_reference(weights, sync_every):
    ref_w, port_w = weights
    reqs = _obs_reqs()
    kw = dict(max_batch=2, page_size=8, max_ctx=48, sync_every=sync_every)
    with _ref_scope():
        ref = _ref_engine(ref_w, obs=ref_obs.Observer(), **kw)
        for r in reqs:
            ref.submit(RefRequest(**r))
        ref_res = ref.run()
    observer = obs.Observer()
    eng = _port_engine(port_w, obs=observer, **kw)
    assert eng.obs is observer
    for r in reqs:
        eng.submit(Request(**r))
    res = eng.run()
    for uid, r in res.items():
        assert r.status == ref_res[uid].status
        assert np.array_equal(r.tokens, ref_res[uid].tokens), uid
    snap, ref_snap = eng.obs.snapshot(), ref.obs.snapshot()
    assert _engine_view(snap) == _engine_view(ref_snap)
    assert snap["counters"]['serve_requests_total{status="OK"}'] == len(reqs)
    assert snap["counters"]["serve_tokens_emitted_total"] == sum(
        len(r.tokens) for r in res.values())
    assert eng.obs.trace.span_structure() == ref.obs.trace.span_structure()
    # the decode-step histogram is decode_s: one observation a step
    h = snap["histograms"]["serve_decode_step_seconds"]
    assert h["count"] == eng.decode_steps == len(eng.decode_s)
    assert h["sum"] == pytest.approx(sum(eng.decode_s), rel=1e-12)
    assert snap["histograms"]["serve_prefill_seconds"]["sum"] == \
        pytest.approx(sum(eng.prefill_s), rel=1e-12)
    # Chrome JSON round trip: sorted non-negative timestamps, one
    # lifecycle (queued, prefill, decode, request) per uid
    payload = json.loads(json.dumps(eng.obs.to_chrome_trace()))
    ts = [e["ts"] for e in payload["traceEvents"] if e["ph"] != "M"]
    assert ts == sorted(ts) and all(t >= 0 for t in ts)
    spans = [e for e in payload["traceEvents"] if e["ph"] == "X"]
    assert all(e["dur"] >= 0 for e in spans)
    for r in reqs:
        tid = eng.obs.trace.request_tid(r["uid"])
        assert sorted(e["name"] for e in spans if e["tid"] == tid) == [
            "decode", "prefill", "queued", "request"]


def test_engines_keep_their_own_counts(weights):
    """Without ``obs=`` each engine builds its own Observer; guard_stats
    is a view over its serve_guard_events_total counters."""
    _, port_w = weights
    a, b = _port_engine(port_w), _port_engine(port_w)
    assert a.obs is not b.obs
    a.guard_stats["preempted"] += 2
    assert b.guard_stats["preempted"] == 0
    assert a.obs.snapshot()["counters"][
        'serve_guard_events_total{kind="preempted"}'] == 2
    assert dict(a.guard_stats) == {**dict.fromkeys(GUARD_STAT_KEYS, 0),
                                   "preempted": 2}
    assert a.guard_stats == {**dict.fromkeys(GUARD_STAT_KEYS, 0),
                             "preempted": 2}
    assert list(a.guard_stats) == list(GUARD_STAT_KEYS)
    assert a.guard_stats.get("nope", 7) == 7 and "nope" not in a.guard_stats


def test_guard_stats_resume_through_obs_counters(weights):
    """restore() seeds the counters with the snapshot's values: the
    restored engine's metrics resume (the reference's restart test)."""
    _, port_w = weights
    reqs = _obs_reqs(seed=789, n=2, max_new=5)
    src = _port_engine(port_w, guard="check")
    for r in reqs:
        src.submit(Request(**r))
    src.step()
    src.guard_stats["flagged_rows"] += 3
    src.guard_stats["preempted"] += 1
    arrays, meta = src.snapshot()
    assert meta["guard_stats"] == {**dict.fromkeys(GUARD_STAT_KEYS, 0),
                                   "flagged_rows": 3, "preempted": 1}
    dst = _port_engine(port_w, guard="check")
    dst.restore(arrays, meta, downtime_s=0.0)
    snap = dst.obs.snapshot()["counters"]
    assert snap['serve_guard_events_total{kind="flagged_rows"}'] == 3
    assert snap['serve_guard_events_total{kind="preempted"}'] == 1
    dst.guard_stats["flagged_rows"] += 2
    after = dst.obs.snapshot()["counters"]
    assert after['serve_guard_events_total{kind="flagged_rows"}'] == 5
    assert dst.guard_stats["flagged_rows"] == 5
    assert dst.snapshot()[1]["guard_stats"]["flagged_rows"] == 5
    # the restored rows reopen their timelines: each ends in one request
    res = dst.run()
    assert sorted(s[0] for s in dst.obs.trace.span_structure()
                  if s[1] == "request") == sorted(
        dst.obs.trace.request_tid(u) for u in res)


# --------------------------------------------------------------------------
# the hooks into obs.REGISTRY
# --------------------------------------------------------------------------

def _global_delta(reg, before, prefix):
    return {k: v for k, v in reg.delta(before)["counters"].items()
            if v and k.startswith(prefix)}


def test_guard_violations_accumulate_past_warn_once():
    """The FFGuardWarning is warn-once per (op, kind); the
    ff_guard_violations_total counter keeps growing: 4 records of 2 give
    8, one warning event, in both packages."""
    deltas = []
    for scope_cls, reg, warn in (
            (GuardScope, obs.REGISTRY, FFGuardWarning),
            (RefGuardScope, ref_obs.REGISTRY, ref_ff.FFGuardWarning)):
        scope = scope_cls("check")
        before = reg.snapshot()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for _ in range(4):
                scope.record("matmul", "nonfinite", 2)
        assert sum(issubclass(w.category, warn) for w in caught) == 1
        assert scope.counters[("matmul", "nonfinite")] == 8
        deltas.append(_global_delta(reg, before, "ff_"))
    assert deltas[0] == deltas[1] == {
        'ff_guard_violations_total{kind="nonfinite",op="matmul"}': 8,
        'ff_warnings_total{kind="guard"}': 1}


def test_degrade_resolution_warning_counts(weights):
    """The degrade-resolve warning is a guard warning event too."""
    from repro_torch.ff.guard import guard
    before = obs.REGISTRY.snapshot()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with guard(mode="degrade") as g:
            g.record("matmul", "nonfinite", 1)
            assert dispatch.resolve_name("matmul", "ozaki") != "ozaki"
            dispatch.resolve_name("matmul", "ozaki")
    d = _global_delta(obs.REGISTRY, before, "ff_")
    assert d['ff_warnings_total{kind="guard"}'] == 2   # record + resolve
    assert any('source="guard_degraded"' in k for k in d)


def test_tune_lookups_count_hits_and_misses(tmp_path):
    path = str(tmp_path / "FF_TUNE.json")
    with open(path, "w") as f:
        json.dump({"meta": {}, "table": {"cpu/add": {"16x16": {
            "fast": {"impl": "jnp", "opts": {}, "us": 1.0}}}}}, f)
    deltas = []
    for tuning, reg, kw in ((port_tuning, obs.REGISTRY, {"device": "cpu"}),
                            (ref_tuning, ref_obs.REGISTRY, {})):
        tuning.clear()
        try:
            tuning.load(path)
            before = reg.snapshot()
            assert tuning.lookup("add", (16, 16), "fast", **kw)["impl"] \
                == "jnp"
            assert tuning.lookup("add", (512, 512), "fast", **kw) is None
            assert tuning.lookup("add", (16, 16), "accurate", **kw) is None
            deltas.append(_global_delta(reg, before, "ff_tune"))
        finally:
            tuning.clear()
    assert deltas[0] == deltas[1] == {
        'ff_tune_cache_total{result="hit"}': 1,
        'ff_tune_cache_total{result="miss"}': 2}


def test_tune_warning_counts(tmp_path):
    path = str(tmp_path / "FF_TUNE.json")
    with open(path, "w") as f:
        f.write("{ not json")
    port_tuning.clear()
    before = obs.REGISTRY.snapshot()
    try:
        with pytest.warns(port_ff.FFTuneWarning):
            port_tuning.load(path)
    finally:
        port_tuning.clear()
    assert _global_delta(obs.REGISTRY, before, "ff_warnings") == {
        'ff_warnings_total{kind="tune"}': 1}


def test_journal_events_match_reference(weights, tmp_path):
    """The same journaled run (a mid-run snapshot compacts, the clean
    retirement truncates) counts the same journal events."""
    ref_w, port_w = weights
    reqs = _obs_reqs(seed=53, max_new=5)
    kw = dict(max_batch=2, page_size=8, max_ctx=48)
    deltas = []
    for name in ("port", "ref"):
        d = tmp_path / name
        wal, snap = str(d / "wal.jsonl"), str(d / "snap")
        reg = obs.REGISTRY if name == "port" else ref_obs.REGISTRY
        before = reg.snapshot()
        scope = _ref_scope() if name == "ref" else contextlib.nullcontext()
        with scope:
            eng = (_port_engine(port_w, journal=wal, **kw) if name == "port"
                   else _ref_engine(ref_w, journal=wal, **kw))
            mk = Request if name == "port" else RefRequest
            for r in reqs:
                eng.submit(mk(**r))
            for _ in range(3):
                eng.step()
            eng.save_snapshot(snap)
            eng.run()
        eng.journal.close()
        assert os.path.getsize(wal) == 0
        deltas.append(_global_delta(reg, before, "serve_journal"))
    assert deltas[0] == deltas[1]
    assert set(deltas[0]) == {f'serve_journal_events_total{{event="{e}"}}'
                              for e in ("append", "retire", "compact",
                                        "truncate")}


def _resolve_ops(m, A, x, a):
    """One call each of several dispatch routes (explicit, scope, static
    default, the matmul shape bucket, a 1-D dot without a bucket)."""
    m.matmul(A(a), A(a), impl="compensated")
    m.matmul(A(a), A(a), impl="ozaki")
    m.add(A(a), A(a))
    with m.use(mul="jnp"):
        m.mul(A(a), A(a))
    m.sum(A(x))
    m.dot(A(x[0]), A(x[1]))
    m.exp(A(x), impl="jnp")
    m.softmax(A(x), impl="jnp")


def test_resolution_series_match_reference_and_resolutions():
    rng = np.random.default_rng(47)
    a = rng.standard_normal((32, 32)).astype(np.float32)
    x = rng.standard_normal((4, 300)).astype(np.float32)
    prefix = "ff_dispatch_resolutions_total"
    rb, pb = ref_obs.REGISTRY.snapshot(), obs.REGISTRY.snapshot()
    counts0 = dict(dispatch.RESOLUTIONS)
    _resolve_ops(ref_ff, jnp.asarray, x, a)
    _resolve_ops(port_ff, torch.from_numpy, x, a)
    ref_d = _global_delta(ref_obs.REGISTRY, rb, prefix)
    port_d = _global_delta(obs.REGISTRY, pb, prefix)
    # the same (op, impl, source, backend, shape) series; backend "cpu" is
    # the JAX backend there and the device type here
    assert set(port_d) == set(ref_d)
    assert any('op="matmul"' in s and 'shape="32x32x32"' in s
               and 'impl="ozaki"' in s and 'source="explicit"' in s
               for s in port_d)
    assert any('op="mul"' in s and 'source="scope"' in s for s in port_d)
    # each series' count is RESOLUTIONS' count of the same key
    moved = {k: n - counts0.get(k, 0)
             for k, n in dispatch.RESOLUTIONS.items()
             if n != counts0.get(k, 0)}
    want = {f'{prefix}{{backend="{d}",impl="{i}",op="{o}",shape="{b}",'
            f'source="{s}"}}': n for (o, i, s, d, b), n in moved.items()}
    assert port_d == want


def test_resolution_telemetry_never_breaks_dispatch(monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("telemetry down")
    monkeypatch.setattr(obs, "record_resolution", boom)
    assert dispatch.resolve_name("add", device="cpu") == "jnp"


# --------------------------------------------------------------------------
# annotate
# --------------------------------------------------------------------------

def test_annotate_is_a_noop_outside_enable():
    assert not obs.enabled()
    assert isinstance(obs.annotate("x"), contextlib.nullcontext)
    with obs.enable():
        assert obs.enabled()
        with obs.enable(False):
            assert not obs.enabled()
            assert isinstance(obs.annotate("x"), contextlib.nullcontext)
        assert not isinstance(obs.annotate("x"), contextlib.nullcontext)
    assert not obs.enabled()


def test_annotate_names_profiler_ranges(weights):
    """Inside obs.enable() the prefill, the decode step and the Ozaki
    matmul appear in a CPU torch.profiler capture; outside, none does."""
    from torch.profiler import ProfilerActivity, profile
    _, port_w = weights
    a = torch.ones((4, 4))
    names = ("serve.prefill", "serve.decode_step", "ff.matmul_ozaki")
    # the default policy: few torch ops, so the capture stays small
    eng = ServeEngine(port_w, PORT_CFG, device="cpu", max_batch=1,
                      page_size=8, max_ctx=48)
    eng.submit(Request(**_obs_reqs(n=1, max_new=2)[0]))
    seen = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        port_ff.matmul(a, a, impl="ozaki")
        eng.step()
    seen[False] = {e.name for e in prof.events()}
    eng.submit(Request(**_obs_reqs(seed=42, n=1, max_new=2)[0]))
    with profile(activities=[ProfilerActivity.CPU]) as prof, obs.enable():
        port_ff.matmul(a, a, impl="ozaki")
        eng.run()
    seen[True] = {e.name for e in prof.events()}
    assert all(n in seen[True] for n in names), seen[True] & set(names)
    assert not any(n in seen[False] for n in names)
