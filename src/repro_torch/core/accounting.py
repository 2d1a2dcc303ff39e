"""Billing, accounting, and abuse policy (§3.3 "Billing and accounting" /
"Preventing abuse and misconfiguration").

* The application owner pays for freshen (attributed separately from
  function compute so the bill is inspectable).
* Misprediction tracking: a freshen whose function does not arrive within a
  horizon is a misprediction; sustained inaccuracy disables freshen
  ("Metrics ... could be used to stop freshen from running if predictions
  have been too inaccurate").
* Service classes: aggressive freshen for latency-sensitive apps, disabled
  for latency-insensitive ones.
* Latency accounting for the multi-instance platform: per-app end-to-end
  latency samples (queueing delay + service time), queueing delay, and
  cold-start counts, summarized as p50/p95/p99 via ``latency_summary`` —
  the metrics the pool load benchmark reports.
"""
from __future__ import annotations

import math
import threading
import time
from collections import deque
from dataclasses import dataclass, field, replace
from enum import Enum
from typing import Callable, Dict, List, Optional, Sequence, Tuple


def _percentile_sorted(vals: Sequence[float], q: float) -> float:
    """Linear-interpolated percentile over an ALREADY-SORTED sequence."""
    if not vals:
        return 0.0
    k = (len(vals) - 1) * (q / 100.0)
    lo = math.floor(k)
    hi = math.ceil(k)
    if lo == hi:
        return vals[int(k)]
    return vals[lo] * (hi - k) + vals[hi] * (k - lo)


def percentile(values: Sequence[float], q: float) -> float:
    """Linear-interpolated percentile (numpy-free; core stays dependency
    light).  ``q`` is clamped to [0, 100] and empty inputs return 0.0, so
    monitoring paths querying an idle platform get zeros instead of an
    IndexError."""
    return _percentile_sorted(sorted(values), min(100.0, max(0.0, q)))


class ServiceClass(Enum):
    LATENCY_SENSITIVE = "latency_sensitive"   # aggressive freshen
    STANDARD = "standard"
    BATCH = "batch"                           # freshen disabled

    @property
    def confidence_threshold(self) -> Optional[float]:
        return {ServiceClass.LATENCY_SENSITIVE: 0.2,
                ServiceClass.STANDARD: 0.5,
                ServiceClass.BATCH: None}[self]   # None => never freshen


@dataclass
class AppBill:
    function_seconds: float = 0.0
    freshen_seconds: float = 0.0
    freshen_invocations: int = 0
    function_invocations: int = 0
    mispredicted_freshens: int = 0
    useful_freshens: int = 0
    cold_starts: int = 0
    queue_seconds: float = 0.0

    @property
    def freshen_overhead_ratio(self) -> float:
        total = self.function_seconds + self.freshen_seconds
        return self.freshen_seconds / total if total else 0.0


class Accountant:
    """Per-application ledger + the confidence gate."""

    def __init__(self, misprediction_horizon: float = 5.0,
                 disable_after: int = 10, disable_miss_rate: float = 0.8,
                 latency_window: int = 65536,
                 clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        self.horizon = misprediction_horizon
        self.disable_after = disable_after
        self.disable_miss_rate = disable_miss_rate
        self.latency_window = latency_window
        self._bills: Dict[str, AppBill] = {}
        # fn -> [(anchor_ts, owning app), ...]; the anchor is the
        # predicted arrival time, the app is who gets billed when the
        # prediction resolves (useful or mispredicted)
        self._pending: Dict[str, List[Tuple[float, str]]] = {}
        # bounded sliding windows (deque maxlen) so a long-running platform
        # never accumulates unbounded per-invocation samples
        self._latencies: Dict[str, deque] = {}           # app -> e2e seconds
        self._queue_delays: Dict[str, deque] = {}        # app -> queue seconds
        self._lock = threading.Lock()
        self.service_class: Dict[str, ServiceClass] = {}

    def bill(self, app: str) -> AppBill:
        with self._lock:
            return self._bills.setdefault(app, AppBill())

    def peek_bill(self, app: str) -> AppBill:
        """Read-only view: a *copy* of the app's bill, or an empty
        unattached one.  Unlike ``bill`` this never inserts into the
        ledger, so cluster aggregation and monitoring loops can poll
        arbitrary app names without growing every shard's ``_bills`` with
        phantom entries — and because it is a snapshot, mutating the
        returned object can never corrupt the live ledger."""
        with self._lock:
            b = self._bills.get(app)
            return replace(b) if b is not None else AppBill()

    # ------------------------------------------------------------------
    def record_freshen(self, app: str, fn: str, seconds: float,
                       now: Optional[float] = None, *,
                       expected_delay: float = 0.0):
        """``expected_delay`` is the predictor's estimate of when the
        freshened function will run (e.g. a recurrence period).  The
        pending freshen is anchored at that expected arrival, so a
        60s-period timer prewarm is not charged as a misprediction just
        because the misprediction horizon is 5s — it expires only
        ``horizon`` seconds after the *predicted* arrival time."""
        now = self.clock() if now is None else now
        with self._lock:
            b = self._bills.setdefault(app, AppBill())
            b.freshen_seconds += seconds
            b.freshen_invocations += 1
            self._pending.setdefault(fn, []).append(
                (now + expected_delay, app))

    def record_invocation(self, app: str, fn: str, seconds: float,
                          now: Optional[float] = None, *,
                          queue_delay: float = 0.0, cold_start: bool = False):
        """``seconds`` is billed service time; ``queue_delay`` is time the
        invocation spent waiting for a pool instance.  End-to-end latency
        (queue_delay + seconds) feeds the percentile summary."""
        now = self.clock() if now is None else now
        with self._lock:
            b = self._bills.setdefault(app, AppBill())
            b.function_seconds += seconds
            b.function_invocations += 1
            b.queue_seconds += queue_delay
            if cold_start:
                # AppBill is the billing ledger, not a registry counter view
                b.cold_starts += 1               # fabriclint: allow[counter]
            self._latencies.setdefault(
                app, deque(maxlen=self.latency_window)).append(
                    seconds + queue_delay)
            self._queue_delays.setdefault(
                app, deque(maxlen=self.latency_window)).append(queue_delay)
            self._resolve_pending_locked(fn, now)

    def _resolve_pending_locked(self, fn: str, now: float):
        """One arrival resolves at most ONE pending freshen: the anchor
        nearest ``now`` within the misprediction horizon is credited as
        useful; anchors whose horizon has long passed are billed as
        mispredictions; future-anchored entries (more than ``horizon``
        ahead, e.g. a 60s-period timer prewarm) stay pending — an
        unrelated immediate arrival must neither consume nor discard
        them.  Useful/mispredicted counts are billed to the app recorded
        when the freshen was dispatched."""
        pend = self._pending.get(fn)
        if not pend:
            return
        keep: List[Tuple[float, str]] = []
        for ts, owner in pend:
            if now - ts > self.horizon:            # anchor long past: missed
                self._bills.setdefault(
                    owner, AppBill()).mispredicted_freshens += 1
            else:
                keep.append((ts, owner))
        best_i, best_d = -1, None
        for i, (ts, _owner) in enumerate(keep):
            d = abs(now - ts)
            if d <= self.horizon and (best_d is None or d < best_d):
                best_i, best_d = i, d
        if best_i >= 0:
            _ts, owner = keep.pop(best_i)
            self._bills.setdefault(owner, AppBill()).useful_freshens += 1
        if keep:
            self._pending[fn] = keep
        else:
            self._pending.pop(fn, None)

    def latency_samples(self, app: str) -> list:
        """Raw end-to-end latency samples (seconds, unsorted) in the
        current window.  Percentiles do not compose across ledgers, so
        cluster-wide aggregation (``repro_torch.cluster.ClusterAccountant``)
        merges raw samples from every shard and re-ranks."""
        with self._lock:
            return list(self._latencies.get(app, ()))

    def queue_delay_samples(self, app: str) -> list:
        """Raw queueing-delay samples (seconds, unsorted) in the window."""
        with self._lock:
            return list(self._queue_delays.get(app, ()))

    def apps(self) -> list:
        """Every application this ledger has billed."""
        with self._lock:
            return sorted(self._bills)

    def latency_summary(self, app: str) -> dict:
        """p50/p95/p99 end-to-end latency, queueing delay, and cold starts
        for one application — the tail-latency view of the platform, over
        the last ``latency_window`` invocations.

        An unknown or not-yet-billed app yields a well-formed all-zero
        summary — and, like ``peek_bill``, never inserts a phantom ledger
        entry: monitoring loops polling arbitrary app names must not grow
        ``_bills`` (or skew ``apps()``) just by looking."""
        with self._lock:
            lats = sorted(self._latencies.get(app, []))
            qds = list(self._queue_delays.get(app, []))
            b = self._bills.get(app)
            cold = b.cold_starts if b is not None else 0
            invocations = b.function_invocations if b is not None else 0
        return {
            "count": len(lats),
            "p50": _percentile_sorted(lats, 50),
            "p95": _percentile_sorted(lats, 95),
            "p99": _percentile_sorted(lats, 99),
            "max": lats[-1] if lats else 0.0,
            "mean_queue_delay": sum(qds) / len(qds) if qds else 0.0,
            "max_queue_delay": max(qds) if qds else 0.0,
            "cold_starts": cold,
            # lifetime cold starts over lifetime invocations — the signal
            # HistoryPolicy.adapt trades against retention cost
            "cold_start_rate": cold / invocations if invocations else 0.0,
        }

    def sweep_expired(self, app: Optional[str] = None,
                      now: Optional[float] = None):
        """Charge freshens whose function never arrived as mispredictions.
        Each expiration is billed to the app recorded when the freshen was
        dispatched (``record_freshen`` knows the owner), never to whoever
        happens to run the sweep; the ``app`` argument is kept only for
        backward compatibility and is ignored."""
        now = self.clock() if now is None else now
        with self._lock:
            for fn, pend in list(self._pending.items()):
                keep: List[Tuple[float, str]] = []
                for ts, owner in pend:
                    if now - ts > self.horizon:
                        self._bills.setdefault(
                            owner, AppBill()).mispredicted_freshens += 1
                    else:
                        keep.append((ts, owner))
                if keep:
                    self._pending[fn] = keep
                else:
                    self._pending.pop(fn, None)

    # ------------------------------------------------------------------
    def should_freshen(self, app: str, confidence: float) -> bool:
        cls = self.service_class.get(app, ServiceClass.STANDARD)
        thresh = cls.confidence_threshold
        if thresh is None:
            return False
        if confidence < thresh:
            return False
        with self._lock:
            b = self._bills.setdefault(app, AppBill())
            total = b.useful_freshens + b.mispredicted_freshens
            if total >= self.disable_after:
                miss_rate = b.mispredicted_freshens / total
                if miss_rate > self.disable_miss_rate:
                    return False                 # accuracy gate tripped
        return True
