"""Chrome trace-event recording for the serving engine (counterpart of
``repro.obs.trace``, a copy: the same events for the same calls).

Emits the subset of the Trace Event Format that Perfetto (and Chrome's
``chrome://tracing``) load directly:

* ``ph="X"`` complete spans — one ``request`` span per request plus its
  ``queued`` / ``prefill`` / ``decode`` children, laid out one Perfetto
  track per request (``tid`` = request uid + ``REQUEST_TID_BASE``);
* ``ph="C"`` counter tracks — queue depth, active batch rows, page-pool
  occupancy, sampled once per scheduler step;
* ``ph="i"`` instants — preemptions, quarantines, snapshot writes,
  host syncs, paging rebuilds.

Timestamps are microseconds from ``time.perf_counter_ns`` relative to
recorder construction, so a trace is self-consistent and monotonic
regardless of wall-clock adjustments.  Everything is recorded from host
Python between device launches.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = ["TraceRecorder", "ENGINE_TID", "REQUEST_TID_BASE"]

# tid used for engine-wide (non-per-request) events; request spans use
# tid = uid + REQUEST_TID_BASE so uid 0 doesn't collide with the engine row.
ENGINE_TID = 0
REQUEST_TID_BASE = 1


class TraceRecorder:
    """Accumulates Chrome trace events; thread-safe, append-only."""

    def __init__(self, pid: int = 1):
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []
        self._t0 = time.perf_counter_ns()
        self._pid = pid
        self._meta(ENGINE_TID, "engine")

    # -- clock ------------------------------------------------------------
    def now(self) -> float:
        """Microseconds since recorder construction (monotonic)."""
        return (time.perf_counter_ns() - self._t0) / 1_000.0

    # -- event emission ---------------------------------------------------
    def _meta(self, tid: int, name: str) -> None:
        self._append({"ph": "M", "pid": self._pid, "tid": tid, "ts": 0,
                      "name": "thread_name", "args": {"name": name}})

    def _append(self, ev: Dict[str, Any]) -> None:
        with self._lock:
            self._events.append(ev)

    def request_tid(self, uid: int) -> int:
        return REQUEST_TID_BASE + int(uid)

    def name_request_track(self, uid: int) -> None:
        self._meta(self.request_tid(uid), f"request uid={uid}")

    def complete(self, name: str, ts_us: float, dur_us: float, *,
                 tid: int = ENGINE_TID, cat: str = "serve",
                 args: Optional[Dict[str, Any]] = None) -> None:
        """A ``ph="X"`` complete span covering [ts_us, ts_us + dur_us]."""
        ev = {"ph": "X", "pid": self._pid, "tid": tid, "name": name,
              "cat": cat, "ts": float(ts_us), "dur": max(float(dur_us), 0.0)}
        if args:
            ev["args"] = args
        self._append(ev)

    def instant(self, name: str, *, tid: int = ENGINE_TID, cat: str = "serve",
                ts_us: Optional[float] = None,
                args: Optional[Dict[str, Any]] = None) -> None:
        ev = {"ph": "i", "pid": self._pid, "tid": tid, "name": name,
              "cat": cat, "s": "t",
              "ts": self.now() if ts_us is None else float(ts_us)}
        if args:
            ev["args"] = args
        self._append(ev)

    def counter(self, name: str, values: Dict[str, float], *,
                ts_us: Optional[float] = None) -> None:
        self._append({"ph": "C", "pid": self._pid, "tid": ENGINE_TID,
                      "name": name, "cat": "serve",
                      "ts": self.now() if ts_us is None else float(ts_us),
                      "args": {k: float(v) for k, v in values.items()}})

    # -- export -----------------------------------------------------------
    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def to_chrome_trace(self) -> Dict[str, Any]:
        """``{"traceEvents": [...]}`` with events sorted by timestamp
        (metadata first), ready for ``json.dump`` → Perfetto."""
        evs = self.events()
        evs.sort(key=lambda e: (e["ph"] != "M", e["ts"]))
        return {"traceEvents": evs, "displayTimeUnit": "ms"}

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)

    # -- structural summary (for tests) -----------------------------------
    def span_structure(self) -> List[tuple]:
        """Timestamp-free span summary: sorted ``(tid, name, status)``
        tuples for every complete span.  Two runs of the same request set
        must agree here regardless of ``sync_every`` batching."""
        out = []
        for ev in self.events():
            if ev["ph"] != "X":
                continue
            status = (ev.get("args") or {}).get("status", "")
            out.append((ev["tid"], ev["name"], status))
        return sorted(out)
