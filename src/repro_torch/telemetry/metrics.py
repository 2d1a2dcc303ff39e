"""Typed metrics for the serving fabric.

The platform components each grew their own ad-hoc counter fields
(``InstancePool.cold_starts``, ``ClusterRouter._lock``-guarded dicts,
``AdaptDaemon.reaped_swept`` …) with their own snapshot conventions —
some copied under a lock, some read field-by-field (torn).  This module
gives them one vocabulary:

* ``Counter``   — monotonically increasing int (``inc``)
* ``Gauge``     — point-in-time value, settable or callback-backed
* ``Histogram`` — streaming count/sum/min/max plus a bounded reservoir
  for percentile estimates

and a ``MetricsRegistry`` that names them.  Components keep exposing
their existing ``stats()`` dict shapes and counter *attributes* — those
are now **views** over registry metrics (via ``@property`` accessors),
so no caller breaks — while anything new reads the registry directly.

Instruments are internally locked and safe to bump from any thread;
callers that already hold a coarser lock (the pool condition variable)
pay one uncontended lock acquisition, which is noise next to the work
those paths do.  A component that wants a *consistent multi-counter
snapshot* should still copy all values under its own lock — the
registry makes each instrument atomic, not the set.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Union


class Counter:
    """Monotonic counter.  ``inc`` from any thread; ``value`` is atomic."""
    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str = ""):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> int:
        with self._lock:
            self._value += n
            return self._value

    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    def __int__(self) -> int:
        return self.value

    def __repr__(self) -> str:
        return f"Counter({self.name}={self.value})"


class Gauge:
    """Point-in-time value.  ``set`` a number, or ``set_fn`` a callback
    that is sampled at read time (pool depth, ring occupancy)."""
    __slots__ = ("name", "_value", "_fn", "_lock")

    def __init__(self, name: str = ""):
        self.name = name
        self._value: float = 0.0
        self._fn: Optional[Callable[[], float]] = None
        self._lock = threading.Lock()

    def set(self, value: float):
        with self._lock:
            self._value = value
            self._fn = None

    def set_fn(self, fn: Callable[[], float]):
        with self._lock:
            self._fn = fn

    @property
    def value(self) -> float:
        with self._lock:
            fn = self._fn
            if fn is None:
                return self._value
        try:
            return float(fn())
        except Exception:
            return 0.0

    def __repr__(self) -> str:
        return f"Gauge({self.name}={self.value})"


class Histogram:
    """Streaming histogram: exact count/sum/min/max plus a bounded
    reservoir for percentiles.  The reservoir keeps the most recent
    ``reservoir`` observations (recency beats uniform sampling for a
    serving system — operators ask about *now*)."""
    __slots__ = ("name", "_count", "_sum", "_min", "_max",
                 "_reservoir", "_cap", "_idx", "_lock")

    def __init__(self, name: str = "", reservoir: int = 1024):
        self.name = name
        self._count = 0
        self._sum = 0.0
        self._min: Optional[float] = None
        self._max: Optional[float] = None
        self._cap = max(1, reservoir)
        self._reservoir: List[float] = []
        self._idx = 0
        self._lock = threading.Lock()

    def observe(self, value: float):
        with self._lock:
            self._count += 1
            self._sum += value
            if self._min is None or value < self._min:
                self._min = value
            if self._max is None or value > self._max:
                self._max = value
            if len(self._reservoir) < self._cap:
                self._reservoir.append(value)
            else:
                self._reservoir[self._idx] = value
                self._idx = (self._idx + 1) % self._cap

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def mean(self) -> float:
        with self._lock:
            return self._sum / self._count if self._count else 0.0

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile over the reservoir (0 when empty).
        ``q`` is clamped to [0, 100]."""
        with self._lock:
            data = sorted(self._reservoir)
        if not data:
            return 0.0
        q = min(100.0, max(0.0, q))
        idx = min(len(data) - 1, max(0, int(round(q / 100.0 * (len(data) - 1)))))
        return data[idx]

    def summary(self) -> dict:
        with self._lock:
            count, total = self._count, self._sum
            lo, hi = self._min, self._max
            data = sorted(self._reservoir)

        def pct(q: float) -> float:
            if not data:
                return 0.0
            i = min(len(data) - 1, max(0, int(round(q / 100.0 * (len(data) - 1)))))
            return data[i]

        return {"count": count, "sum": total,
                "mean": (total / count) if count else 0.0,
                "min": lo if lo is not None else 0.0,
                "max": hi if hi is not None else 0.0,
                "p50": pct(50), "p95": pct(95), "p99": pct(99)}

    def __repr__(self) -> str:
        return f"Histogram({self.name} n={self.count})"


Metric = Union[Counter, Gauge, Histogram]


class MetricsRegistry:
    """Named get-or-create store of instruments.

    Each component owns its *own* registry (one per ``InstancePool``,
    one per scheduler, …) so metric names stay short and per-shard
    fn-name collisions can't happen; fabric-wide aggregation is a
    prefix-merge of ``snapshot()`` dicts at the reader (see
    ``FreshenScheduler.metrics_snapshot``)."""

    def __init__(self, prefix: str = ""):
        self.prefix = prefix
        self._lock = threading.Lock()
        self._metrics: Dict[str, Metric] = {}

    def _get_or_create(self, name: str, kind, **kwargs) -> Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = kind(name=self.prefix + name, **kwargs)
                self._metrics[name] = m
            elif not isinstance(m, kind):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, requested {kind.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, Gauge)

    def histogram(self, name: str, reservoir: int = 1024) -> Histogram:
        return self._get_or_create(name, Histogram, reservoir=reservoir)

    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        """Sorted ``<prefix><name>`` keys, matching ``snapshot()``."""
        with self._lock:
            return sorted(self.prefix + name for name in self._metrics)

    def snapshot(self) -> dict:
        """Plain-dict dump keyed ``<prefix><name>``: counters/gauges as
        numbers, histograms as summary dicts.  Per-instrument atomic
        (see module docstring for cross-instrument consistency)."""
        with self._lock:
            items = list(self._metrics.items())
        out: Dict[str, object] = {}
        for name, m in items:
            if isinstance(m, Histogram):
                out[self.prefix + name] = m.summary()
            else:
                out[self.prefix + name] = m.value
        return out
