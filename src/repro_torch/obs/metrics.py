"""Named counters, gauges, and log-bucketed histograms with snapshot/delta.

The registry is additive infrastructure: existing stat objects
(``ServerStats``, ``IOScheduler.summary()``, ...) *register into* it via
gauge callables rather than being replaced, so nothing about the legacy
reporting surface changes.

- :class:`Counter` — monotonically increasing, lock-guarded ``inc``.
- :class:`Gauge` — last-set value, or a zero-arg callable evaluated at
  read time (``set_fn``), which is how live objects expose their state.
- :class:`Histogram` — base-2 log-bucketed (bucket key is the binary
  exponent from ``math.frexp``), tracking count/sum/min/max. Cheap enough
  for per-step observation.

``MetricsRegistry.snapshot()`` returns a plain-dict view;
``MetricsRegistry.delta(prev)`` subtracts counter values and histogram
counts, while gauges always report their current reading.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Callable, Dict, Optional

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "get_metrics",
    "set_metrics",
]


class Counter:
    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    __slots__ = ("name", "_value", "_fn")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None

    def set(self, value: float) -> None:
        self._fn = None
        self._value = value

    def set_fn(self, fn: Callable[[], float]) -> None:
        self._fn = fn

    @property
    def value(self) -> float:
        if self._fn is not None:
            return float(self._fn())
        return self._value


class Histogram:
    """Base-2 log-bucketed histogram of non-negative observations.

    Bucket ``e`` holds values ``v`` with ``2**(e-1) <= v < 2**e``
    (``math.frexp(v)[1] == e``); zero/negative values land in the
    sentinel bucket ``"zero"``.
    """

    __slots__ = ("name", "count", "sum", "min", "max", "buckets", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.buckets: Dict[Any, int] = {}
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        key: Any = "zero" if value <= 0 else math.frexp(value)[1]
        with self._lock:
            self.count += 1
            self.sum += value
            if value < self.min:
                self.min = value
            if value > self.max:
                self.max = value
            self.buckets[key] = self.buckets.get(key, 0) + 1

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "count": self.count,
                "sum": self.sum,
                "min": self.min if self.count else None,
                "max": self.max if self.count else None,
                "buckets": dict(self.buckets),
            }


class MetricsRegistry:
    """Create-or-get registry of named metrics."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name)
            return g

    def register_gauge(self, name: str, fn: Callable[[], float]) -> Gauge:
        """Register (or re-point) a gauge backed by a live callable."""
        g = self.gauge(name)
        g.set_fn(fn)
        return g

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(name)
            return h

    def snapshot(self) -> dict:
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._histograms)
        gauge_values = {}
        for name, g in gauges.items():
            try:
                gauge_values[name] = g.value
            except Exception:
                # A gauge callable may outlive the object it reads from.
                gauge_values[name] = None
        return {
            "counters": {name: c.value for name, c in counters.items()},
            "gauges": gauge_values,
            "histograms": {name: h.snapshot() for name, h in hists.items()},
        }

    def delta(self, prev: dict, cur: Optional[dict] = None) -> dict:
        """Difference of two snapshots: counters/histogram counts subtract,
        gauges report the current reading."""
        if cur is None:
            cur = self.snapshot()
        d_counters = {
            name: value - prev.get("counters", {}).get(name, 0)
            for name, value in cur["counters"].items()
        }
        d_hists = {}
        for name, h in cur["histograms"].items():
            p = prev.get("histograms", {}).get(name, {})
            p_buckets = p.get("buckets", {})
            d_hists[name] = {
                "count": h["count"] - p.get("count", 0),
                "sum": h["sum"] - p.get("sum", 0.0),
                "buckets": {
                    k: v - p_buckets.get(k, 0)
                    for k, v in h["buckets"].items()
                    if v - p_buckets.get(k, 0)
                },
            }
        return {"counters": d_counters, "gauges": dict(cur["gauges"]), "histograms": d_hists}


_METRICS = MetricsRegistry()


def get_metrics() -> MetricsRegistry:
    """The process-global metrics registry."""
    return _METRICS


def set_metrics(registry: MetricsRegistry) -> MetricsRegistry:
    """Install a registry globally (tests use this); returns the previous one."""
    global _METRICS
    prev = _METRICS
    _METRICS = registry
    return prev
