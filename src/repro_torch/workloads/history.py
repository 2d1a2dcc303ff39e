"""HistoryPolicy — from observed invocation history to pool policy.

This is the closed loop the ROADMAP names (SPES-style performance–resource
trade-off): per-function inter-arrival histograms, learned from a trace
(``fit``) or online (``observe``), drive

* **prewarm timing** — ``prime`` seeds a ``RecurrencePredictor`` so the
  scheduler's successor prediction includes "this function recurs every
  ~T seconds" and freshens its own pool ahead of the next arrival, and
* **pool sizing** — ``pool_config`` derives keep-alive from the
  inter-arrival (= idle time between recurrences) distribution and
  ``max_instances`` from Little's law over the busiest minute, and
* **runtime adaptation** — ``adapt`` widens keep-alive / instance caps
  when ``Accountant.latency_summary`` still reports cold starts above the
  target rate (prediction missed; pay for retention instead).

Invariants (enforced, tested): keep-alive is never below the pool's
cold-start cost (reaping faster than you can boot guarantees thrash) and
``max_instances`` is always >= 1.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Dict, List, Optional

from repro_torch.core.accounting import percentile
from repro_torch.core.pool import PoolConfig
from repro_torch.core.prediction import HybridPredictor, RecurrencePredictor

from repro_torch.workloads.trace import Trace


@dataclass
class _FnHistory:
    interarrivals: List[float]
    peak_per_minute: int = 0
    duration: float = 0.0          # representative service seconds (p95-ish)
    invocations: int = 0


class HistoryPolicy:
    """Inter-arrival histograms -> recurrence prediction + PoolConfig."""

    def __init__(self, keep_alive_percentile: float = 95.0,
                 keep_alive_margin: float = 1.25,
                 keep_alive_cap: float = 600.0,
                 max_instances_cap: int = 64,
                 target_cold_start_rate: float = 0.05,
                 min_adapt_samples: int = 20):
        self.keep_alive_percentile = keep_alive_percentile
        self.keep_alive_margin = keep_alive_margin
        self.keep_alive_cap = keep_alive_cap
        self.max_instances_cap = max_instances_cap
        self.target_cold_start_rate = target_cold_start_rate
        self.min_adapt_samples = min_adapt_samples
        self._hist: Dict[str, _FnHistory] = {}
        self._last_seen: Dict[str, float] = {}

    # -- learning -------------------------------------------------------
    def fit(self, trace: Trace) -> "HistoryPolicy":
        """Learn per-function histograms in one pass over the trace.
        (One pass matters: a real Azure trace slice has thousands of
        functions — per-function rescans would be quadratic.)"""
        per_min: Dict[str, Dict[int, int]] = {}
        durs: Dict[str, List[float]] = {}
        arrivals: Dict[str, List[float]] = {}
        for ev in trace.events():               # already time-sorted
            per_min.setdefault(ev.fn, {})
            minute = int(ev.t // 60.0)
            per_min[ev.fn][minute] = per_min[ev.fn].get(minute, 0) + 1
            durs.setdefault(ev.fn, []).append(ev.duration)
            arrivals.setdefault(ev.fn, []).append(ev.t)
        for fn in trace.functions:
            ts = arrivals.get(fn, [])
            gaps = [b - a for a, b in zip(ts, ts[1:])]
            prof = trace.profiles.get(fn)
            duration = max(
                prof.duration_p95 if prof else 0.0,
                percentile(durs.get(fn, []), 95) if durs.get(fn) else 0.0)
            self._hist[fn] = _FnHistory(
                interarrivals=gaps,
                peak_per_minute=max(per_min.get(fn, {0: 0}).values()),
                duration=duration,
                invocations=len(durs.get(fn, [])))
        return self

    def observe(self, fn: str, timestamp: float):
        """Online learning: record one arrival (monotone timestamps).

        Deliberately parallel to ``RecurrencePredictor.observe`` rather
        than delegating to it: the predictor keeps a bounded recent
        window (prediction follows drift), while policy percentiles and
        Little's law want the full history."""
        h = self._hist.setdefault(fn, _FnHistory(interarrivals=[]))
        last = self._last_seen.get(fn)
        if last is not None and timestamp >= last:
            h.interarrivals.append(timestamp - last)
        self._last_seen[fn] = timestamp
        h.invocations += 1

    # -- views ----------------------------------------------------------
    @property
    def functions(self) -> List[str]:
        return sorted(self._hist)

    def interarrivals(self, fn: str) -> List[float]:
        h = self._hist.get(fn)
        return list(h.interarrivals) if h else []

    # -- policy outputs -------------------------------------------------
    def pool_config(self, fn: str, base: Optional[PoolConfig] = None,
                    time_scale: float = 1.0,
                    measured_cold_start: Optional[float] = None
                    ) -> PoolConfig:
        """Derive a PoolConfig for ``fn`` from its history.

        ``time_scale`` converts trace seconds to wall seconds (match the
        replayer's scale).  Keep-alive covers the ``keep_alive_percentile``
        of observed idle gaps (times ``keep_alive_margin``) so recurrences
        land on warm instances; functions with <2 observed invocations
        keep the base keep-alive (no histogram to trust).  ``max_instances``
        is Little's law over the busiest minute: peak arrival rate x
        service time, floored at 1.

        ``measured_cold_start`` is the pool's observed mean boot time
        (``InstancePool.measured_cold_start``).  It matters under the
        subprocess/snapshot backends, where ``base.cold_start_cost`` is
        typically 0: without it a trace-derived config could set
        keep-alive below the real boot time and reap faster than the
        platform can provision.  The floor honors whichever of the
        configured and measured costs is larger — which is also what lets
        a cheap-restore (snapshot) backend *lower* the floor and release
        idle capacity sooner than a full-spawn backend safely could.
        """
        base = base or PoolConfig()
        h = self._hist.get(fn)
        keep_alive = base.keep_alive
        if h and h.interarrivals:
            keep_alive = (percentile(h.interarrivals,
                                     self.keep_alive_percentile)
                          * self.keep_alive_margin * time_scale)
        keep_alive = min(keep_alive, self.keep_alive_cap)
        # never reap faster than the pool can boot: below the (configured
        # or measured) boot cost, keep-alive buys nothing and guarantees
        # cold-start thrash
        keep_alive = max(keep_alive, base.cold_start_cost,
                         measured_cold_start or 0.0)
        max_instances = 1
        if h and h.peak_per_minute:
            # Little's law in wall time: compressing the trace clock
            # raises the wall arrival rate (rate / time_scale) but the
            # replayed function bodies still take their real duration,
            # so required concurrency grows as the clock compresses
            wall_rate = (h.peak_per_minute / 60.0) / time_scale
            concurrency = wall_rate * h.duration
            max_instances = max(1, math.ceil(concurrency))
        max_instances = min(max_instances, self.max_instances_cap)
        out = replace(base, keep_alive=keep_alive,
                      max_instances=max_instances)
        if base.graded_warmth and h and h.interarrivals:
            out = self._graded_keep_alives(out, h, time_scale,
                                           measured_cold_start)
        return out

    def _graded_keep_alives(self, config: PoolConfig, h: _FnHistory,
                            time_scale: float,
                            measured_cold_start: Optional[float]
                            ) -> PoolConfig:
        """Per-rung keep-alives from the idle-gap distribution: the HOT
        rung (most expensive to hold, cheapest to rebuild from
        INITIALIZED) covers only the typical gap (p50), the INITIALIZED
        rung the configured percentile (the binary keep-alive), and the
        near-free PROCESS rung the tail (p99) — so a long-tail recurrence
        lands on a standby instead of a full cold start.  Monotone by
        construction (hot <= initialized <= process) and the PROCESS rung
        is floored at the boot cost like the binary keep-alive."""
        gaps = h.interarrivals
        margin = self.keep_alive_margin * time_scale
        ka_init = config.keep_alive
        ka_hot = min(percentile(gaps, 50.0) * margin, ka_init)
        ka_proc = percentile(gaps, 99.0) * margin
        ka_proc = min(max(ka_proc, ka_init), self.keep_alive_cap)
        ka_proc = max(ka_proc, config.cold_start_cost,
                      measured_cold_start or 0.0)
        return replace(config, keep_alive_hot=ka_hot,
                       keep_alive_initialized=ka_init,
                       keep_alive_process=ka_proc)

    def prime(self, predictor: HybridPredictor,
              time_scale: float = 1.0) -> RecurrencePredictor:
        """Attach (or reuse) a RecurrencePredictor on ``predictor`` and
        seed it with every function's scaled inter-arrival history, so the
        scheduler self-prewarms periodic functions from the first replayed
        invocation instead of re-learning the period online."""
        rec = predictor.recurrence
        if rec is None:
            rec = RecurrencePredictor()
            predictor.recurrence = rec
        for fn, h in self._hist.items():
            if h.interarrivals:
                rec.seed(fn, [g * time_scale for g in h.interarrivals])
        return rec

    def adapt(self, fn: str, summary: dict, config: PoolConfig,
              measured_cold_start: Optional[float] = None) -> PoolConfig:
        """Close the loop from ``Accountant.latency_summary`` output: if
        cold starts still exceed ``target_cold_start_rate`` after enough
        invocations, double keep-alive (capped) and add one instance of
        headroom — prediction under-covered, so buy retention instead.

        ``measured_cold_start`` is the pool's *observed* mean init time
        (``InstancePool.measured_cold_start``); under the subprocess
        backend it is real interpreter-spawn + import time, which can far
        exceed the configured ``cold_start_cost`` (often 0 there).  The
        keep-alive floor honors whichever is larger: reaping faster than
        the platform can actually boot guarantees thrash."""
        if summary.get("count", 0) < self.min_adapt_samples:
            return config
        rate = summary.get("cold_start_rate", 0.0)
        if rate <= self.target_cold_start_rate:
            return config
        boot_cost = max(config.cold_start_cost, measured_cold_start or 0.0)
        keep_alive = max(min(config.keep_alive * 2.0, self.keep_alive_cap),
                         boot_cost)
        max_instances = max(1, min(config.max_instances + 1,
                                   self.max_instances_cap))
        out = replace(config, keep_alive=keep_alive,
                      max_instances=max_instances)
        if config.graded_warmth:
            # widen every rung with the same pressure, keeping the ladder
            # monotone: cold starts above target mean demotion/reap came
            # too early at every level
            def _scale(v):
                return (None if v is None
                        else max(min(v * 2.0, self.keep_alive_cap),
                                 boot_cost))
            ka_hot = _scale(config.keep_alive_hot)
            ka_init = _scale(config.keep_alive_initialized)
            ka_proc = _scale(config.keep_alive_process)
            if ka_init is not None and ka_hot is not None:
                ka_hot = min(ka_hot, ka_init)
            if ka_proc is not None:
                ka_proc = max(ka_proc, keep_alive)
            out = replace(out, keep_alive_hot=ka_hot,
                          keep_alive_initialized=ka_init,
                          keep_alive_process=ka_proc)
        return out
