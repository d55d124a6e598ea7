"""Thread-safe in-process metrics: counters, gauges, log2 histograms
(counterpart of ``repro.obs.registry``, a copy: the same series names,
snapshot dicts, JSON text and Prometheus text for the same calls).

The registry is deliberately tiny and stdlib-only: serving-engine steps
and dispatch resolution record into it from host Python, so the cost
model is "a dict lookup and an integer add under a lock", a few hundred
nanoseconds per event.  Nothing here touches a tensor.

Exposition formats:

* :meth:`MetricsRegistry.snapshot` — a plain ``dict`` (JSON-ready) that
  tests and the chaos tier assert on;
* :meth:`MetricsRegistry.delta` — counter/histogram differences against a
  previous snapshot (gauges report their current value), so a test can
  bracket exactly one engine run;
* :meth:`MetricsRegistry.to_json` / :meth:`MetricsRegistry.to_prometheus`
  — the serialized forms ``launch/serve.py --metrics-json`` and
  ``--metrics-port`` emit.

Histograms use fixed log2 buckets: upper bounds ``2**e`` for
``e in [LOG2_LO, LOG2_HI)`` plus ``+Inf``.  With the default range the
buckets span 1 µs .. 64 s, wide enough for both a single decode step and
a cold restore, and *fixed* so two snapshots are always subtractable.
"""

from __future__ import annotations

import json
import math
import threading
from typing import Dict, List, Optional, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "LOG2_LO", "LOG2_HI", "LOG2_BUCKETS",
]

# Fixed log2 bucket upper bounds (seconds): 2^-20 s ~ 1 us .. 2^6 = 64 s.
LOG2_LO = -20
LOG2_HI = 7
LOG2_BUCKETS: Tuple[float, ...] = tuple(
    float(2.0 ** e) for e in range(LOG2_LO, LOG2_HI))


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt_labels(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + inner + "}"


class Counter:
    """Monotonic counter.  ``inc`` is the hot call; ``set`` exists only so
    snapshot *restore* paths (e.g. ``ServeEngine.restore``) can resume a
    persisted value."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    def set(self, v: int) -> None:
        with self._lock:
            self._value = int(v)

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    """Point-in-time value (queue depth, pool occupancy)."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Histogram over the fixed log2 buckets (plus +Inf overflow)."""

    __slots__ = ("_lock", "_counts", "_sum", "_count")

    def __init__(self):
        self._lock = threading.Lock()
        self._counts = [0] * (len(LOG2_BUCKETS) + 1)
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        if v <= 0.0 or math.isnan(v):
            idx = 0
        elif v > LOG2_BUCKETS[-1]:
            idx = len(LOG2_BUCKETS)          # +Inf overflow bucket
        else:
            # first bucket whose upper bound >= v:  2^ceil(log2 v)
            e = math.ceil(math.log2(v))
            idx = min(max(e - LOG2_LO, 0), len(LOG2_BUCKETS) - 1)
        with self._lock:
            self._counts[idx] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def buckets(self) -> List[Tuple[float, int]]:
        """Cumulative (le, count) pairs, Prometheus-style, ending at +Inf."""
        out, cum = [], 0
        with self._lock:
            counts = list(self._counts)
        for le, c in zip(LOG2_BUCKETS, counts[:-1]):
            cum += c
            out.append((le, cum))
        out.append((math.inf, cum + counts[-1]))
        return out


class MetricsRegistry:
    """Named, labeled metric families; creation is lazy and idempotent."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, tuple], Counter] = {}
        self._gauges: Dict[Tuple[str, tuple], Gauge] = {}
        self._histograms: Dict[Tuple[str, tuple], Histogram] = {}

    # -- metric accessors -------------------------------------------------
    def counter(self, name: str, **labels: str) -> Counter:
        key = (name, _label_key(labels))
        c = self._counters.get(key)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(key, Counter())
        return c

    def gauge(self, name: str, **labels: str) -> Gauge:
        key = (name, _label_key(labels))
        g = self._gauges.get(key)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(key, Gauge())
        return g

    def histogram(self, name: str, **labels: str) -> Histogram:
        key = (name, _label_key(labels))
        h = self._histograms.get(key)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(key, Histogram())
        return h

    # -- snapshot / delta --------------------------------------------------
    @staticmethod
    def _series_name(key: Tuple[str, tuple]) -> str:
        name, labels = key
        return name + _fmt_labels(labels)

    def snapshot(self) -> Dict[str, dict]:
        """Plain-dict snapshot: ``{"counters": {...}, "gauges": {...},
        "histograms": {series: {count, sum, buckets}}}``."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._histograms)
        snap: Dict[str, dict] = {"counters": {}, "gauges": {}, "histograms": {}}
        for key, c in sorted(counters.items()):
            snap["counters"][self._series_name(key)] = c.value
        for key, g in sorted(gauges.items()):
            snap["gauges"][self._series_name(key)] = g.value
        for key, h in sorted(hists.items()):
            snap["histograms"][self._series_name(key)] = {
                "count": h.count,
                "sum": h.sum,
                "buckets": [[("+Inf" if math.isinf(le) else le), n]
                            for le, n in h.buckets()],
            }
        return snap

    def delta(self, prev: Optional[Dict[str, dict]]) -> Dict[str, dict]:
        """Current snapshot minus ``prev`` (counters and histogram counts
        subtract; gauges pass through).  ``prev=None`` == full snapshot."""
        cur = self.snapshot()
        if not prev:
            return cur
        out: Dict[str, dict] = {"counters": {}, "gauges": dict(cur["gauges"]),
                                "histograms": {}}
        pc = prev.get("counters", {})
        for name, v in cur["counters"].items():
            out["counters"][name] = v - pc.get(name, 0)
        ph = prev.get("histograms", {})
        for name, h in cur["histograms"].items():
            p = ph.get(name, {"count": 0, "sum": 0.0})
            out["histograms"][name] = {
                "count": h["count"] - p.get("count", 0),
                "sum": h["sum"] - p.get("sum", 0.0),
                "buckets": h["buckets"],
            }
        return out

    # -- exposition --------------------------------------------------------
    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)

    def to_prometheus(self) -> str:
        """Prometheus text exposition (format 0.0.4)."""
        lines: List[str] = []
        with self._lock:
            counters = sorted(self._counters.items())
            gauges = sorted(self._gauges.items())
            hists = sorted(self._histograms.items())
        seen_types: Dict[str, str] = {}

        def _header(name: str, kind: str) -> None:
            if seen_types.get(name) != kind:
                lines.append(f"# TYPE {name} {kind}")
                seen_types[name] = kind

        for (name, labels), c in counters:
            _header(name, "counter")
            lines.append(f"{name}{_fmt_labels(labels)} {c.value}")
        for (name, labels), g in gauges:
            _header(name, "gauge")
            lines.append(f"{name}{_fmt_labels(labels)} {g.value}")
        for (name, labels), h in hists:
            _header(name, "histogram")
            base = dict(labels)
            for le, cum in h.buckets():
                ble = "+Inf" if math.isinf(le) else repr(le)
                lab = _fmt_labels(_label_key({**base, "le": ble}))
                lines.append(f"{name}_bucket{lab} {cum}")
            lines.append(f"{name}_sum{_fmt_labels(labels)} {h.sum}")
            lines.append(f"{name}_count{_fmt_labels(labels)} {h.count}")
        return "\n".join(lines) + "\n"
