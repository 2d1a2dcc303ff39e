"""AdaptDaemon — the online adaptation loop as a background thread.

PR 2 made adaptation *possible* (``HistoryPolicy.adapt`` turns an
``Accountant.latency_summary`` into a widened ``PoolConfig``) but left it
caller-driven.  This daemon closes the loop unattended: every
``interval`` seconds it snapshots each scheduler's per-app latency
summary, asks the policy whether any pool's cold-start rate still
exceeds target, and live-applies the widened config through
``FreshenScheduler.apply_pool_config``.

It adapts one scheduler or many — hand it a cluster's per-shard
schedulers (``[w.scheduler for w in router.workers]``) and each shard is
retuned against *its own* ledger: a shard the router keeps hot widens
retention while an idle shard keeps the lean config, which is exactly the
per-placement sizing a merged ledger would blur away.

With ``cluster=`` set the same loop also resizes the *fleet*
(``FleetPolicy``): aggregate queue depth or a windowed cold-start rate
above target adds a shard (``ClusterRouter.add_worker``), and a fleet
that has sat fully idle for several consecutive passes drains its
newest idle shard (``remove_worker(..., drain=True)``) — proactive
capacity one level above the pools the daemon already retunes.  The
shard set is re-read from the cluster every pass, so pools on elastic
shards are adapted the pass after they appear.

``step()`` runs one pass synchronously (tests and benchmarks call it
directly); ``start()``/``stop()`` manage the thread — both idempotent in
any order (``stop`` before ``start`` is a no-op; a second ``start``
joins a stopped-but-unjoined thread instead of leaking a second loop),
and the worker thread is a daemon so a forgotten ``stop`` never blocks
interpreter exit.  The daemon is also a context manager.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple, Union

from repro_torch.core.pool import PoolConfig
from repro_torch.core.scheduler import FreshenScheduler
from repro_torch.telemetry import MetricsRegistry

from repro_torch.workloads.history import HistoryPolicy


@dataclass
class FleetPolicy:
    """When the daemon grows or shrinks the shard set.

    Scale-out fires when either pressure signal trips: the cluster-wide
    queue depth (blocked acquires across every shard — work is waiting
    that more capacity would admit) or the cold-start rate over the
    invocations seen *since the last pass* (a lifetime rate would take
    forever to notice a fresh burst going cold).  Scale-in requires
    ``scale_in_idle_passes`` consecutive passes with zero in-flight work
    anywhere, then drains one shard per pass — deliberately slower than
    scale-out, the classic asymmetry that avoids flapping."""
    min_shards: int = 1
    max_shards: int = 8
    scale_out_queue_depth: int = 4        # aggregate blocked acquires
    scale_out_cold_rate: float = 0.5      # cold rate since the last pass
    min_window_invocations: int = 8       # rate needs this many to count
    scale_in_idle_passes: int = 3         # consecutive all-idle passes


class AdaptDaemon:
    """Periodic latency-summary -> HistoryPolicy.adapt -> pool reconfig,
    plus (with a cluster) FleetPolicy-driven shard add/remove."""

    def __init__(self,
                 schedulers: Union[FreshenScheduler,
                                   Iterable[FreshenScheduler], None] = None,
                 policy: Optional[HistoryPolicy] = None,
                 interval: float = 1.0,
                 cluster=None,
                 fleet: Optional[FleetPolicy] = None,
                 adapt_pools: bool = True):
        if isinstance(schedulers, FreshenScheduler):
            schedulers = [schedulers]
        self.schedulers: List[FreshenScheduler] = list(schedulers or [])
        self.policy = policy or HistoryPolicy()
        self.interval = interval
        self.cluster = cluster                 # a ClusterRouter, or None
        self.fleet = fleet or (FleetPolicy() if cluster is not None else None)
        self.adapt_pools = adapt_pools
        if cluster is None and not self.schedulers:
            raise ValueError("AdaptDaemon needs schedulers, a cluster, "
                             "or both")
        # the daemon's counters live in its metrics registry; the legacy
        # attribute names are read-only property views below
        self.metrics = MetricsRegistry("daemon.")
        self._c_passes = self.metrics.counter("passes")
        self._c_adaptations = self.metrics.counter("adaptations")
        self._c_reaped = self.metrics.counter("reaped_swept")
        self._c_demoted = self.metrics.counter("demoted_swept")
        self._c_scale_outs = self.metrics.counter("scale_outs")
        self._c_scale_ins = self.metrics.counter("scale_ins")
        self._c_errors = self.metrics.counter("errors")
        self._c_expired = self.metrics.counter("freshen_spans_expired")
        self._c_waiters = self.metrics.counter("waiters_expired")
        self.fleet_actions: List[Tuple[int, str, int]] = []
        self._idle_passes = 0
        # windowed cold-rate baselines, seeded from the cluster's current
        # bills: history that predates the daemon must not read as a
        # "since last pass" cold burst on the first pass.  Apps first seen
        # later start their window at zero (their whole history postdates
        # the daemon).
        self._window_bill: Dict[str, Tuple[int, int]] = {}
        if cluster is not None:
            for app in cluster.accountant.apps():
                b = cluster.accountant.bill(app)
                self._window_bill[app] = (b.cold_starts,
                                          b.function_invocations)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._state_lock = threading.Lock()

    # -- legacy counter views (registry-backed) --------------------------
    @property
    def passes(self) -> int:
        return self._c_passes.value

    @property
    def adaptations(self) -> int:
        return self._c_adaptations.value

    @property
    def reaped_swept(self) -> int:
        return self._c_reaped.value

    @property
    def demoted_swept(self) -> int:
        return self._c_demoted.value

    @property
    def scale_outs(self) -> int:
        return self._c_scale_outs.value

    @property
    def scale_ins(self) -> int:
        return self._c_scale_ins.value

    @property
    def errors(self) -> int:
        return self._c_errors.value

    @property
    def waiters_expired(self) -> int:
        return self._c_waiters.value

    # ------------------------------------------------------------------
    def _live_schedulers(self) -> List[FreshenScheduler]:
        """Static schedulers plus the cluster's *current* shard set —
        re-read every pass so elastic shards join the adaptation loop."""
        scheds = list(self.schedulers)
        if self.cluster is not None:
            seen = {id(s) for s in scheds}
            for w in self.cluster.workers:
                if id(w.scheduler) not in seen:
                    scheds.append(w.scheduler)
        return scheds

    def step(self) -> Dict[Tuple[int, str], PoolConfig]:
        """One adaptation pass over every scheduler: returns the configs
        that were applied, keyed ``(scheduler_index, fn)``.  Summaries are
        snapshotted per app once per scheduler (pools of one app share a
        ledger), then each pool is adapted against its app's summary.
        With a cluster attached, one fleet sizing decision follows."""
        applied: Dict[Tuple[int, str], PoolConfig] = {}
        schedulers = self._live_schedulers()
        # keep-alive sweep first, independent of adapt_pools: the pool's
        # own reap() only runs inside acquire/prewarm_freshen, so a
        # function that goes quiet would otherwise park its (subprocess/
        # snapshot worker) instances forever — scale-to-zero needs a
        # traffic-independent clock tick, and the daemon pass is it.
        # On graded pools the same tick drives the demotion ladder: each
        # pass drops expired instances one warmth rung (tracked via the
        # pool's demotion counter delta).
        # the same tick also sweeps closure-parked acquire_async waiters
        # past their deadline: a timed-out waiter's callback (its
        # PoolSaturated) must fire even if no release ever comes.
        for sched in schedulers:
            for pool in list(sched.pools.values()):
                before = pool.demotions
                self._c_reaped.inc(pool.reap())
                self._c_demoted.inc(pool.demotions - before)
                self._c_waiters.inc(pool.sweep_waiters())
        # expire stale freshen spans on the same traffic-independent tick:
        # the tracer otherwise only sweeps lazily on export, so a fabric
        # that goes quiet would hold "pending" anchors forever.  Shards
        # share one cluster tracer — dedupe by identity.
        for tracer in {id(s.tracer): s.tracer for s in schedulers
                       if s.tracer.enabled}.values():
            self._c_expired.inc(tracer.sweep_expired())
        if self.adapt_pools:
            for idx, sched in enumerate(schedulers):
                summaries: Dict[str, dict] = {}
                for fn, pool in list(sched.pools.items()):
                    app = pool.spec.app
                    if app not in summaries:
                        summaries[app] = sched.accountant.latency_summary(app)
                    cfg = self.policy.adapt(
                        fn, summaries[app], pool.config,
                        measured_cold_start=pool.measured_cold_start())
                    if (cfg.keep_alive == pool.config.keep_alive
                            and cfg.max_instances == pool.config.max_instances):
                        continue
                    sched.apply_pool_config(fn, cfg)
                    applied[(idx, fn)] = cfg
        if self.cluster is not None and self.fleet is not None:
            self._fleet_step()
        self._c_passes.inc()
        self._c_adaptations.inc(len(applied))
        return applied

    # -- fleet sizing ----------------------------------------------------
    def _window_cold_rate(self) -> float:
        """Cold-start rate over invocations since the window was last
        consumed, summed across apps (retired shards included via the
        cluster accountant, so a mid-window drain does not dent the
        window).  A window smaller than ``min_window_invocations`` is
        left to accumulate — advancing the baselines on every pass would
        silently discard cold starts arriving slower than the pass rate
        and never trip the rule."""
        cold = invocations = 0
        totals: Dict[str, Tuple[int, int]] = {}
        for app in self.cluster.accountant.apps():
            b = self.cluster.accountant.bill(app)
            last_c, last_i = self._window_bill.get(app, (0, 0))
            cold += b.cold_starts - last_c
            invocations += b.function_invocations - last_i
            totals[app] = (b.cold_starts, b.function_invocations)
        if invocations < self.fleet.min_window_invocations:
            return 0.0
        self._window_bill.update(totals)
        return cold / invocations

    def _fleet_step(self):
        fleet = self.fleet
        workers = self.cluster.workers
        queue_depth = sum(w.queue_depth() for w in workers)
        load = sum(w.load() for w in workers)
        cold_rate = self._window_cold_rate()
        if len(workers) < fleet.max_shards and (
                queue_depth >= fleet.scale_out_queue_depth
                or cold_rate > fleet.scale_out_cold_rate):
            shard = self.cluster.add_worker().shard_id
            self._c_scale_outs.inc()
            self._idle_passes = 0
            self.fleet_actions.append((self.passes, "add", shard))
            return
        if load == 0:
            self._idle_passes += 1
            if (len(workers) > fleet.min_shards
                    and self._idle_passes >= fleet.scale_in_idle_passes):
                victim = self._scale_in_victim(workers)
                if victim is not None:
                    self.cluster.remove_worker(victim, drain=True)
                    self._c_scale_ins.inc()
                    self._idle_passes = 0
                    self.fleet_actions.append(
                        (self.passes, "remove", victim))
        else:
            self._idle_passes = 0

    @staticmethod
    def _scale_in_victim(workers):
        """Newest shard whose removal leaves every function it hosts
        routable elsewhere (LIFO keeps shard 0 — and its accumulated
        warmth — as the stable floor).  A shard that is the *sole* host
        of some function (an explicit shard-subset registration, which
        add_worker never replays) is never drained automatically: an
        idle gap must not take a live function out of service."""
        for w in sorted(workers, key=lambda w: -w.shard_id):
            others = [o for o in workers if o is not w]
            if all(any(o.has_function(fn) for o in others)
                   for fn in list(w.scheduler.pools)):
                return w.shard_id
        return None

    def _run(self):
        while not self._stop.wait(self.interval):
            try:
                self.step()
            except Exception:                  # noqa: BLE001
                # the loop must survive a transient failure (e.g. a shard
                # shutting down mid-snapshot); surfaced via self.errors
                self._c_errors.inc()

    # ------------------------------------------------------------------
    def start(self) -> "AdaptDaemon":
        with self._state_lock:
            if (self._thread is not None and self._thread.is_alive()
                    and not self._stop.is_set()):
                return self                    # idempotent: already running
            if self._thread is not None:
                # a stop(wait=False)'d thread may still be mid-pass (or may
                # not have observed the event yet): join it before clearing
                # the event, or clearing could revive the old loop and leak
                # a second one running alongside the new thread
                self._stop.set()
                # start/stop are rare control-plane calls; joining the old
                # loop under _state_lock is what makes restart atomic
                self._thread.join()              # fabriclint: allow[blocking]
            self._stop.clear()
            self._thread = threading.Thread(target=self._run,
                                            name="adapt-daemon", daemon=True)
            self._thread.start()
        return self

    def stop(self, wait: bool = True):
        """Idempotent, safe before ``start`` (no-op) and from any thread.
        With ``wait=False`` the thread reference is retained so a later
        ``start`` can join the old loop instead of racing it."""
        with self._state_lock:
            self._stop.set()
            th = self._thread
        if th is None or th is threading.current_thread():
            return
        if wait:
            th.join()
            with self._state_lock:
                if self._thread is th:
                    self._thread = None

    @property
    def running(self) -> bool:
        th = self._thread
        return th is not None and th.is_alive()

    def __enter__(self) -> "AdaptDaemon":
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False
