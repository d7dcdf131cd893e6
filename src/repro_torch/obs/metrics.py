"""Process-local metrics: counters, gauges, and streaming histograms. A
copy of the JAX package's ``repro.obs.metrics``, which imports no JAX: the
port keeps its own.

The serving layer's latency accounting lives here.  A
:class:`MetricsRegistry` owns named instruments:

* :class:`Counter` — monotonically increasing totals (queries served,
  cache hits).
* :class:`Gauge` — last-written values (queue depth at flush time).
* :class:`Histogram` — streaming log-bucketed distributions with
  p50/p90/p99 quantile estimates, O(1) per observation and O(#buckets)
  memory regardless of stream length.  Built for latencies spanning
  microseconds to seconds: geometric buckets at ``growth`` spacing
  (default 2^(1/4) ≈ 19% relative error per bucket edge) starting from
  ``least`` (default 1 µs when observing seconds).

Everything is thread-safe: the registry locks its instrument maps, and
every instrument carries its own lock so concurrent ``inc``/``set``/
``observe`` calls (the async serving layer counts rejections from
submitting threads while the event loop records flush latencies) never
lose updates or tear a ``summary()``.  ``snapshot()`` renders the whole
registry as plain dicts of floats/ints — JSON-serializable, safe to hand
to callers (no live references escape).

This module has no dependencies on the rest of the repo (and nothing
below ``obs`` imports it) — the core numeric layer stays
instrumentation-free except for the one ``trace.active()`` check.
"""
from __future__ import annotations

import math
import threading
from typing import Any, Dict, List, Optional


class Counter:
    """A monotonically increasing integer total (thread-safe)."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, amount: int = 1) -> int:
        with self._lock:
            self.value += amount
            return self.value


class Gauge:
    """A last-written value (plus min/max watermarks since creation);
    thread-safe, so watermarks never miss a concurrent write."""

    __slots__ = ("name", "value", "lo", "hi", "writes", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        self.lo = math.inf
        self.hi = -math.inf
        self.writes = 0
        self._lock = threading.Lock()

    def set(self, value: float) -> float:
        with self._lock:
            self.value = value
            self.lo = min(self.lo, value)
            self.hi = max(self.hi, value)
            self.writes += 1
        return value


class Histogram:
    """A streaming log-bucketed histogram with quantile estimates.

    Observations land in geometric buckets ``[least * growth^i,
    least * growth^(i+1))``; values at or below ``least`` share bucket 0,
    so zero and negative observations are legal (they count toward the
    lowest bucket).  A quantile is reported as the geometric midpoint of
    the bucket containing it — relative error is bounded by
    ``sqrt(growth)`` (≈ 9% at the default growth of 2^(1/4)), which is
    plenty for latency percentiles.  Exact min/max/mean are tracked on
    the side.
    """

    __slots__ = ("name", "least", "growth", "_log_g", "buckets",
                 "count", "total", "lo", "hi", "_lock")

    def __init__(self, name: str, least: float = 1e-6,
                 growth: float = 2 ** 0.25):
        if not (least > 0 and growth > 1):
            raise ValueError("need least > 0 and growth > 1")
        self.name = name
        self.least = least
        self.growth = growth
        self._log_g = math.log(growth)
        self.buckets: Dict[int, int] = {}
        self.count = 0
        self.total = 0.0
        self.lo = math.inf
        self.hi = -math.inf
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        if value <= self.least:
            idx = 0
        else:
            idx = 1 + int(math.log(value / self.least) / self._log_g)
        with self._lock:
            self.buckets[idx] = self.buckets.get(idx, 0) + 1
            self.count += 1
            self.total += value
            self.lo = min(self.lo, value)
            self.hi = max(self.hi, value)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def _quantile(self, q: float) -> float:
        """q-quantile estimate; caller holds the lock (or owns the
        instrument exclusively)."""
        if self.count == 0:
            return 0.0
        # Rank of the target observation, 1-based; q=1 → the last one.
        rank = min(self.count, max(1, math.ceil(q * self.count)))
        seen = 0
        for idx in sorted(self.buckets):
            seen += self.buckets[idx]
            if seen >= rank:
                if idx == 0:
                    return min(self.least, self.hi) if self.hi > -math.inf \
                        else self.least
                # geometric midpoint of bucket [g^(i-1), g^i) * least
                mid = self.least * self.growth ** (idx - 0.5)
                return min(max(mid, self.lo), self.hi)
        return self.hi  # unreachable

    def quantile(self, q: float) -> float:
        """The estimated q-quantile (q in [0, 1])."""
        with self._lock:
            return self._quantile(q)

    def summary(self) -> Dict[str, float]:
        with self._lock:
            if self.count == 0:
                return {"count": 0}
            return {
                "count": self.count,
                "mean": self.mean,
                "min": self.lo,
                "max": self.hi,
                "p50": self._quantile(0.50),
                "p90": self._quantile(0.90),
                "p99": self._quantile(0.99),
            }


class MetricsRegistry:
    """A named collection of instruments. ``counter``/``gauge``/
    ``histogram`` create-or-return by name (idempotent), ``snapshot()``
    renders everything as plain JSON-safe dicts."""

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

    def histogram(self, name: str, least: float = 1e-6,
                  growth: float = 2 ** 0.25) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(name, least, growth)
            return h

    def snapshot(self) -> Dict[str, Any]:
        """Plain dicts only — callers can mutate the result freely."""
        with self._lock:
            out: Dict[str, Any] = {
                "counters": {n: c.value for n, c in self._counters.items()},
                "gauges": {
                    n: {"value": g.value, "min": g.lo, "max": g.hi,
                        "writes": g.writes}
                    for n, g in self._gauges.items() if g.writes
                },
                "histograms": {n: h.summary()
                               for n, h in self._histograms.items()},
            }
        return out


# A process-global default registry, for callers that don't carry their
# own (the server constructs a private one per instance).
_default: Optional[MetricsRegistry] = None


def default_registry() -> MetricsRegistry:
    global _default
    if _default is None:
        _default = MetricsRegistry()
    return _default


def percentile_exact(values: List[float], q: float) -> float:
    """Exact nearest-rank percentile of a small list — the test oracle
    for :meth:`Histogram.quantile`, and handy for one-off reports."""
    if not values:
        return 0.0
    xs = sorted(values)
    rank = min(len(xs), max(1, math.ceil(q * len(xs))))
    return xs[rank - 1]
