"""TraceReplayer — open-loop replay of a Trace against the platform.

Arrivals fire at ``t0 + event.t * time_scale`` regardless of how the
platform is keeping up (open loop: a slow platform accumulates queueing
delay, it does not slow the workload down), via the target's concurrent
admission (``submit`` / ``submit_chain`` for chain-rooted events).

The replay target is anything speaking the invocation-target protocol —
``has_function(fn)``, ``submit``, ``submit_chain``, ``prewarm(fn)`` — so
the same trace replays into one ``FreshenScheduler`` or a whole
``repro_torch.cluster.ClusterRouter`` unchanged; against a cluster, oracle
prewarms go through the router's placement decision, exactly where the
arrival will be routed.

``oracle_lead`` enables the oracle arm of the benchmark: the replayer
*knows* the full schedule, so it dispatches a prewarm freshen to the
target pool exactly ``oracle_lead`` trace-seconds before every arrival —
the upper bound any predictor can reach.

``controls`` makes the replay elastic-fleet-capable: a sequence of
``(trace_time, callable)`` pairs fired in schedule order alongside the
arrivals — e.g. ``(t, lambda: cluster.add_worker())`` resizes the fleet
mid-replay, exercising reshard/drain under live open-loop traffic.  A
control firing ``remove_worker(drain=True)`` blocks the replay clock
while it drains; subsequent arrivals fire late and are reported as lag,
exactly like any other platform stall under open-loop replay.
"""
from __future__ import annotations
# fabriclint: allow-file[clock] -- open-loop replay paces arrivals
# against the real wall clock by contract (time-compressed traces
# still sleep real seconds).

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

from repro_torch.core.accounting import percentile

from repro_torch.workloads.trace import Trace


@dataclass
class ReplayReport:
    """What one replay run did (latencies live in the Accountant)."""
    requests: int = 0
    prewarms: int = 0
    errors: int = 0
    skipped: int = 0               # events for unregistered functions
    controls: int = 0              # control callables fired
    control_errors: int = 0        # control callables that raised
    wall: float = 0.0              # wall seconds for the whole replay
    lag_p95: float = 0.0           # p95 of (actual - scheduled) fire time
    lags: List[float] = field(default_factory=list, repr=False)


class TraceReplayer:
    """Drive a scheduler's (or cluster's) ``submit``/``submit_chain``
    from a Trace."""

    def __init__(self, scheduler, trace: Trace,
                 time_scale: float = 1.0,
                 oracle_lead: Optional[float] = None,
                 args_fn=None, strict: bool = True,
                 result_timeout: float = 120.0,
                 controls: Optional[Sequence[Tuple[float, Callable]]] = None):
        if time_scale <= 0:
            raise ValueError("time_scale must be positive")
        self.scheduler = scheduler
        self.trace = trace
        self.time_scale = time_scale
        self.oracle_lead = oracle_lead
        self.args_fn = args_fn                 # (event) -> invocation args
        self.strict = strict
        self.result_timeout = result_timeout
        # (trace_time, callable) fired once each in schedule order —
        # fleet resizes, config pushes, fault injection
        self.controls = list(controls or [])

    # ------------------------------------------------------------------
    def _schedule(self):
        """Merged, ordered (when, kind, event) actions in trace time."""
        actions = []
        for ev in self.trace.events():
            if self.oracle_lead is not None:
                actions.append((max(0.0, ev.t - self.oracle_lead),
                                "prewarm", ev))
            actions.append((ev.t, "invoke", ev))
        for when, call in self.controls:
            actions.append((when, "control", call))
        # stable sort on timestamp only: controls are appended after the
        # trace events, so a control tied with an arrival fires *after*
        # it — schedule the control strictly earlier to precede one
        actions.sort(key=lambda a: a[0])
        return actions

    def _registered(self, ev) -> bool:
        fns = ev.chain if ev.chain else (ev.fn,)
        return all(self.scheduler.has_function(fn) for fn in fns)

    def run(self, freshen: bool = True) -> ReplayReport:
        """Replay the whole trace; blocks until every result resolves."""
        report = ReplayReport()
        actions = self._schedule()
        if self.strict:
            missing = sorted({ev.fn for _, kind, ev in actions
                              if kind != "control"
                              and not self._registered(ev)})
            if missing:
                raise KeyError(f"trace functions not registered: {missing}")
        futures = []
        t0 = time.monotonic()
        for when, kind, ev in actions:
            target = t0 + when * self.time_scale
            delay = target - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            if kind == "control":
                report.controls += 1
                try:
                    ev()
                except Exception:              # noqa: BLE001
                    # a failed resize must not kill the replay: the
                    # arrivals keep firing, the failure is reported
                    report.control_errors += 1
                continue
            if not self._registered(ev):
                if kind == "invoke":     # count each trace event once,
                    report.skipped += 1  # not its oracle prewarm too
                continue
            report.lags.append(max(0.0, time.monotonic() - target))
            if kind == "prewarm":
                # oracle: freshen the pool the arrival will land on —
                # through the cluster router's placement decision when the
                # target is a cluster — provisioning off the critical path
                # if it scaled to zero
                self.scheduler.prewarm(ev.fn, provision=True)
                report.prewarms += 1
                continue
            args = self.args_fn(ev) if self.args_fn is not None else None
            if ev.chain:
                futures.append(self.scheduler.submit_chain(
                    list(ev.chain), args, freshen=freshen))
            else:
                futures.append(self.scheduler.submit(
                    ev.fn, args, freshen_successors=freshen))
            report.requests += 1
        for fut in futures:
            try:
                fut.result(timeout=self.result_timeout)
            except Exception:
                report.errors += 1
        report.wall = time.monotonic() - t0
        report.lag_p95 = percentile(report.lags, 95)
        return report
