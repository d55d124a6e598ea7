"""``repro_torch.obs`` — metrics, tracing and profiling for the port
(counterpart of ``repro.obs``).

Three layers, all host-side and stdlib-only at import time
(``repro_torch.obs`` never imports ``repro_torch.ff``: dispatch, guard,
tuning and the journal import *us*, and call the hooks through
:func:`record`, which never raises):

* **Metrics** (:mod:`repro_torch.obs.registry`): thread-safe counters,
  gauges and log2-bucket histograms with snapshot/delta and JSON and
  Prometheus exposition.  A process-global registry (:data:`REGISTRY`)
  collects dispatch-resolution, tune-cache, warning, guard-violation and
  journal counters.  Engines carry their own registry (in an
  :class:`Observer`), so concurrent engines and tests never share counts.
* **Tracing** (:mod:`repro_torch.obs.trace`): Chrome trace-event JSON
  (Perfetto-loadable): per-request span timelines and per-step engine
  events.
* **Profiling** (:mod:`repro_torch.obs.profiling`): the ``obs.enable()``
  scope gating ``torch.profiler.record_function`` (and NVTX) ranges
  around prefill, the decode step and the Ozaki matmul.

Two differences from the reference, both from running eagerly: a
resolution is recorded on every dispatch call, the event that
``ff.dispatch.RESOLUTIONS`` counts (the reference records at trace time
only), and its ``backend`` label is the call's device type (``cpu`` /
``cuda``) where the reference's is the JAX backend.

``python -m repro_torch.obs`` runs an instrumented serving smoke and
writes both artifacts — see :mod:`repro_torch.obs.__main__`.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.obs.profiling import annotate, enable, enabled
from repro_torch.obs.registry import (LOG2_BUCKETS, Counter, Gauge,
                                      Histogram, MetricsRegistry)
from repro_torch.obs.trace import ENGINE_TID, TraceRecorder

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "LOG2_BUCKETS",
    "TraceRecorder", "ENGINE_TID",
    "annotate", "enable", "enabled",
    "REGISTRY", "Observer",
    "record_resolution", "record_tune_lookup", "record_warning",
    "record_guard_violation", "record_journal_event", "record",
]

# Process-global registry: dispatch, tuning, guard and journal telemetry
# that no one engine owns.  Tests bracket assertions with snapshot/delta.
REGISTRY = MetricsRegistry()


# -- hooks called from repro_torch.ff and repro_torch.serve ------------------

def record_resolution(op: str, impl: str, source: str, backend: str,
                      shape_bucket: str) -> None:
    """One dispatch resolution: ``op`` resolved to ``impl`` because of
    ``source`` (explicit/scope/policy/tuned/.../guard_degraded) on the
    device type ``backend`` for the pow2 ``shape_bucket``; recorded on
    every call, as ``ff.dispatch.RESOLUTIONS`` counts."""
    REGISTRY.counter("ff_dispatch_resolutions_total", op=op, impl=impl,
                     source=source, backend=backend,
                     shape=shape_bucket).inc()


def record_tune_lookup(hit: bool) -> None:
    REGISTRY.counter("ff_tune_cache_total",
                     result=("hit" if hit else "miss")).inc()


def record_warning(kind: str) -> None:
    """``kind`` in {"tune", "guard"}: one FFTuneWarning/FFGuardWarning
    event (counted even when the warning itself is warn-once
    suppressed)."""
    REGISTRY.counter("ff_warnings_total", kind=kind).inc()


def record_guard_violation(op: str, kind: str, count: int = 1) -> None:
    """Per-(op, kind) guard violation count; accumulates on every call,
    unlike the warn-once user-facing warning."""
    if count > 0:
        REGISTRY.counter("ff_guard_violations_total",
                         op=op, kind=kind).inc(int(count))


def record_journal_event(event: str, n: int = 1) -> None:
    """Write-ahead-journal activity: append/retire/compact/truncate."""
    REGISTRY.counter("serve_journal_events_total", event=event).inc(int(n))


def record(hook: str, *args) -> None:
    """Call the hook named ``hook`` (one of the ``record_*`` above) with
    ``args``.  Dispatch, guard, tuning and the journal record through
    this: telemetry never breaks the call that reports it, so an error
    in a hook is dropped."""
    try:
        globals()[hook](*args)
    except Exception:
        pass


class Observer:
    """Per-engine observability bundle: a private metrics registry and a
    trace recorder.  ``ServeEngine(obs=...)`` takes one; without it the
    engine builds its own, so counts stay per instance."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 trace: Optional[TraceRecorder] = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.trace = trace if trace is not None else TraceRecorder()

    def snapshot(self) -> dict:
        return self.registry.snapshot()

    def delta(self, prev: Optional[dict]) -> dict:
        return self.registry.delta(prev)

    def to_chrome_trace(self) -> dict:
        return self.trace.to_chrome_trace()

    def dump_trace(self, path: str) -> None:
        self.trace.dump(path)

    def dump_metrics(self, path: str,
                     extra: Optional[MetricsRegistry] = None) -> None:
        """Write a combined metrics JSON: this observer's registry plus the
        process-global one (dispatch/tune/guard/journal counters), the
        artifact of ``launch/serve.py --metrics-json``."""
        import json
        payload = {"engine": self.registry.snapshot(),
                   "global": (extra if extra is not None
                              else REGISTRY).snapshot()}
        with open(path, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
