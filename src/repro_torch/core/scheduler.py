"""The platform-side freshen scheduler (§2, §3.3) as a concurrent,
multi-instance router.

On every function invocation the scheduler predicts the successors and
dispatches ``freshen`` inside the trigger-delay window — gated by the
Accountant's confidence/service-class/accuracy policy.  Unlike the seed
(one synchronous ``Runtime`` per function), each registered function is
backed by an ``InstancePool`` (repro_torch.core.pool):

* ``invoke``  — acquire an instance (possibly cold-starting or queueing),
  run, release; queueing delay and cold starts are reported to the
  Accountant alongside service time.
* ``submit`` / ``submit_chain`` — admit invocations concurrently; returns
  a Future.  ``submit`` is a *single-submission fast path*: it calls
  ``InstancePool.try_acquire`` inline on the caller thread and, on a warm
  hit, hands only the run-and-release tail to the router executor — one
  hop, ``queue`` phase ≈ the executor handoff.  When nothing is
  immediately available the request parks a **closure** in the pool's
  ``acquire_async`` waiter queue (no router thread blocks on the
  condition variable); ``release`` hands the freed instance straight to
  it.  Freshen prediction (``on_invocation_start``) runs on a dedicated
  single-worker executor off the critical path — observation order is
  preserved (FIFO), admission latency stops paying for it.  Constructing
  the scheduler with ``fast_path=False`` restores the PR 8 two-hop
  admission (the measured baseline in ``benchmarks/hot_path.py``).
* ``submit`` on an unregistered function raises ``UnknownFunction`` at
  admission time (synchronously) rather than surfacing a bare KeyError
  later inside the Future.
* freshen dispatch targets *idle pooled instances* (prewarm-aware): the
  §3.1 hook becomes a pool policy, and with ``PoolConfig.prewarm_provision``
  it proactively cold-starts an instance off the critical path —
  SPES-style provisioning unified with the paper's prediction machinery.

Backwards-compatible single-instance view: ``register`` still returns a
Runtime (the pool's primary instance) and ``self.runtimes`` still maps
function name -> that runtime, so code written against the seed API keeps
working unchanged.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field, replace
from typing import Callable, Deque, Dict, List, Optional

from repro_torch.core.accounting import Accountant
from repro_torch.core.backend import make_backend
from repro_torch.core.pool import InstancePool, PoolConfig
from repro_torch.core.prediction import HybridPredictor, Prediction
from repro_torch.core.runtime import FunctionSpec, Runtime, WarmthLevel
from repro_torch.telemetry import MetricsRegistry, NULL_TRACER, Tracer


class UnknownFunction(KeyError):
    """``submit``/``invoke``/``submit_chain`` named a function that was
    never ``register``-ed with this scheduler.  Raised synchronously at
    admission time — the caller holds a programming error, not a
    capacity problem, so it must not surface later inside a Future the
    way a bare KeyError from the pool lookup used to.  (The cluster
    router already rejects unknowns at route time.)"""

    def __init__(self, fn: str):
        self.fn = fn
        super().__init__(fn)

    def __str__(self) -> str:
        return (f"function {self.fn!r} is not registered with this "
                f"scheduler (call register() first)")


@dataclass
class FreshenEvent:
    fn: str
    confidence: float
    dispatched: bool
    reason: str
    at: float = field(default_factory=time.monotonic)


@dataclass
class WarmthPolicy:
    """Maps prediction confidence to a target warmth rung (SPES-style):
    how warm an instance is worth making is a function of how sure the
    predictor is.  High-regularity functions earn a full HOT prewarm
    (caches populated), medium confidence an INITIALIZED instance
    (servable, caches cold), and the long tail a cheap PROCESS-rung
    sandbox standby.  ``standby_on_gate``: even when the Accountant's
    confidence/accuracy gate refuses a *freshen*, a graded pool may still
    buy the near-free PROCESS standby — the gate protects freshen
    accounting and cache work, not sandbox residency."""

    hot_confidence: float = 0.7
    init_confidence: float = 0.35
    standby_on_gate: bool = True

    def target_level(self, probability: float) -> WarmthLevel:
        if probability >= self.hot_confidence:
            return WarmthLevel.HOT
        if probability >= self.init_confidence:
            return WarmthLevel.INITIALIZED
        return WarmthLevel.PROCESS


class _PrimaryRuntimeView:
    """Seed-compat ``scheduler.runtimes`` mapping: fn -> the pool's live
    primary runtime.  Resolved per access (never a snapshot), so a primary
    reaped by keep-alive expiry is transparently replaced by the pool's
    next (or a freshly provisioned) instance."""

    def __init__(self, pools: Dict[str, InstancePool]):
        self._pools = pools

    def __getitem__(self, fn: str) -> Runtime:
        return self._pools[fn].ensure_primary()

    def get(self, fn: str, default=None):
        pool = self._pools.get(fn)
        return default if pool is None else pool.ensure_primary()

    def __contains__(self, fn: str) -> bool:
        return fn in self._pools

    def __iter__(self):
        return iter(self._pools)

    def keys(self):
        return self._pools.keys()

    def __len__(self):
        return len(self._pools)


class FreshenScheduler:
    """Global scheduling entity: instance pools + predictor + policy."""

    def __init__(self, predictor: Optional[HybridPredictor] = None,
                 accountant: Optional[Accountant] = None,
                 pool_config: Optional[PoolConfig] = None,
                 max_router_threads: int = 16,
                 event_window: int = 4096,
                 warmth_policy: Optional["WarmthPolicy"] = None,
                 tracer: Optional[Tracer] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 fast_path: bool = True):
        self.predictor = predictor or HybridPredictor()
        self.accountant = accountant or Accountant()
        self.pool_config = pool_config or PoolConfig()
        # telemetry: NULL_TRACER keeps every span call a constant-cost
        # no-op; a cluster passes one shared tracer to all shards so
        # cross-shard freshens and the arrivals they anchor meet in one
        # pending table
        self.tracer = tracer or NULL_TRACER
        self.metrics = metrics or MetricsRegistry("scheduler.")
        self._m_dispatched = self.metrics.counter("freshen.dispatched")
        self._m_gated = self.metrics.counter("freshen.gated")
        self._m_no_target = self.metrics.counter("freshen.no_target")
        self._m_routed = self.metrics.counter("freshen.routed")
        self._m_e2e = self.metrics.histogram("invoke.e2e_seconds")
        self._m_queue = self.metrics.histogram("invoke.queue_delay_seconds")
        # admission-path split: fast = inline try_acquire hit (run-only
        # work dispatched), slow = parked in the pool's waiter queue or
        # fell back to a blocking acquire (spill/legacy path)
        self._m_fast = self.metrics.counter("invoke.fast_path")
        self._m_slow = self.metrics.counter("invoke.slow_path")
        # None = binary warmth (every prewarm targets HOT — seed behavior);
        # a WarmthPolicy makes prewarm depth confidence-driven
        self.warmth_policy = warmth_policy
        self.max_router_threads = max_router_threads
        # Cross-shard freshen propagation hook (repro_torch.cluster): when set,
        # every prediction is offered to the callback first.  Returning
        # None keeps the prediction shard-local (the target *is* this
        # shard, or no cluster routing applies); returning a bool means
        # the cluster router handled it on whichever shard it decided the
        # predicted invocation will land on — True if the target shard
        # actually dispatched the prewarm, False if its gate dropped it —
        # and the local dispatch path is skipped either way.
        self.freshen_route: Optional[
            Callable[[Prediction], Optional[bool]]] = None
        self.pools: Dict[str, InstancePool] = {}
        self.runtimes = _PrimaryRuntimeView(self.pools)
        # bounded: a long-running platform appends events per invocation
        self.events: Deque[FreshenEvent] = deque(maxlen=event_window)
        self._scopes: Dict[str, tuple] = {}      # chain-level shared scopes
        self._lock = threading.Lock()
        self._router: Optional[ThreadPoolExecutor] = None
        # single-submission fast path toggle: False restores the PR 8
        # two-hop admission (every submit routed through invoke) — the
        # legacy arm benchmarks/hot_path.py measures against
        self.fast_path = fast_path
        # freshen prediction off the critical path: one worker, so
        # predictor.observe keeps its arrival order (the Markov chain
        # detector is order-sensitive) while admission stops paying for
        # prediction + prewarm dispatch
        self._freshen_exec: Optional[ThreadPoolExecutor] = None

    # ------------------------------------------------------------------
    def register(self, spec: FunctionSpec, runtime: Optional[Runtime] = None,
                 scope_group: Optional[str] = None,
                 config: Optional[PoolConfig] = None,
                 backend: Optional[str] = None) -> Runtime:
        """Create the function's instance pool (with one eager instance so
        the seed-era single-runtime API keeps working) and return its
        primary runtime.

        ``scope_group``: §6 "different isolation scopes" — functions in
        the same group share runtime-scoped state (Azure-style chain-level
        isolation): one ``scope`` dict and one ``FreshenCache``, so a
        resource freshened for any member is visible to all of them.
        Every instance the pool ever creates joins the shared scope; each
        keeps its own fr_state (plans differ per function).

        ``backend`` overrides the pool config's instance backend
        (repro_torch.core.backend): "thread" runs hooks in-process, "subprocess"
        in a persistent worker process with measured cold starts,
        "snapshot" in processes forked from a pre-warmed per-pool
        template (measured fork+init cold starts; the template spawns
        here, at register time, off the first arrival's critical path).
        Scope groups are in-process state and require the thread
        backend."""
        # each pool gets its own config copy: tuning one pool must never
        # mutate another's policy through the shared scheduler default
        cfg = config or replace(self.pool_config)
        if backend is not None and backend != cfg.backend:
            cfg = replace(cfg, backend=backend)
        if scope_group is not None and cfg.backend != "thread":
            raise ValueError(
                f"scope_group {scope_group!r} shares in-process state and "
                f"requires the thread backend, not {cfg.backend!r}")

        def factory() -> Runtime:
            rt = Runtime(spec, cold_start_cost=cfg.cold_start_cost,
                         backend=make_backend(cfg.backend))
            self._join_scope(rt, scope_group)
            return rt

        pool = InstancePool(spec, cfg, runtime_factory=factory)
        if runtime is not None:
            self._join_scope(runtime, scope_group)
            pool.adopt(runtime)
        else:
            pool.adopt(factory())
        with self._lock:
            self.pools[spec.name] = pool
        return pool.primary

    def _join_scope(self, rt: Runtime, scope_group: Optional[str]):
        if scope_group is None:
            return
        with self._lock:
            shared = self._scopes.setdefault(scope_group, (rt.scope, rt.cache))
            rt.scope, rt.cache = shared

    def runtime(self, fn: str) -> Runtime:
        return self.runtimes[fn]

    def pool(self, fn: str) -> InstancePool:
        return self.pools[fn]

    def _pool_or_raise(self, fn: str) -> InstancePool:
        pool = self.pools.get(fn)
        if pool is None:
            raise UnknownFunction(fn)
        return pool

    def apply_pool_config(self, fn: str, config: PoolConfig) -> PoolConfig:
        """Live-retune one function's pool (the trace/history-adaptive
        control loop's write path); returns the previous config."""
        return self.pools[fn].reconfigure(config)

    def has_function(self, fn: str) -> bool:
        """Whether ``fn`` is registered — the invocation-target protocol
        shared with ``repro_torch.cluster.ClusterRouter`` (TraceReplayer speaks
        it, so a trace replays into a scheduler or a cluster unchanged)."""
        return fn in self.pools

    def prewarm(self, fn: str, provision: bool = True,
                level: Optional[WarmthLevel] = None
                ) -> List[threading.Thread]:
        """Externally-driven prewarm (oracle replay, cluster rebalancing):
        warm ``fn``'s pool to ``level`` (default HOT — the full freshen
        hook), provisioning off the critical path when nothing is idle."""
        return self.pools[fn].prewarm_freshen(provision=provision,
                                              level=level)

    # ------------------------------------------------------------------
    def _dispatch_freshen(self, pred: Prediction,
                          *, _routed: bool = False) -> bool:
        """Returns True when a prewarm was actually dispatched (locally or
        on the shard the cluster routed it to), False when it was dropped
        (unknown function, accounting gate, no target instance)."""
        if not _routed and self.freshen_route is not None:
            routed = self.freshen_route(pred)
            if routed is not None:
                # the target shard's scheduler traced the dispatch (the
                # fabric shares one tracer); count the routing hop here
                self._m_routed.inc()
                self.events.append(FreshenEvent(
                    pred.fn, pred.probability, bool(routed),
                    "routed-cross-shard" if routed
                    else "routed-cross-shard-gated"))
                return bool(routed)
        pool = self.pools.get(pred.fn)
        if pool is None:
            self._m_no_target.inc()
            self.events.append(FreshenEvent(pred.fn, pred.probability, False,
                                            "no-runtime"))
            return False
        app = pool.spec.app
        level = (WarmthLevel.HOT if self.warmth_policy is None
                 else self.warmth_policy.target_level(pred.probability))
        fspan = self.tracer.freshen(
            pred.fn, confidence=pred.probability, level=level.label,
            expected_delay=pred.expected_delay)
        if not self.accountant.should_freshen(app, pred.probability):
            if (self.warmth_policy is not None
                    and self.warmth_policy.standby_on_gate
                    and pool.config.graded_warmth):
                # the gate refused the freshen, not sandbox residency:
                # a PROCESS-rung standby is the long-tail consolation
                threads = pool.prewarm_freshen(level=WarmthLevel.PROCESS)
                if threads:
                    self._m_dispatched.inc()
                    fspan.dispatched("standby-process")
                    self.events.append(FreshenEvent(
                        pred.fn, pred.probability, True, "standby-process"))
                    return True
            self._m_gated.inc()
            fspan.gated("policy-gated")
            self.events.append(FreshenEvent(pred.fn, pred.probability, False,
                                            "policy-gated"))
            return False
        # fabriclint: allow[clock] -- measured service/freshen time is a wall-clock contract
        t0 = time.monotonic()
        threads = pool.prewarm_freshen(level=level)
        if not threads:
            self._m_no_target.inc()
            fspan.gated("no-idle-instance")
            self.events.append(FreshenEvent(pred.fn, pred.probability, False,
                                            "no-idle-instance"))
            return False
        self._m_dispatched.inc()
        fspan.dispatched("dispatched" if level >= WarmthLevel.HOT
                         else f"dispatched-{level.label}")
        self.events.append(FreshenEvent(
            pred.fn, pred.probability, True,
            "dispatched" if level >= WarmthLevel.HOT
            else f"dispatched-{level.label}"))

        if level >= WarmthLevel.HOT:
            # freshen accounting tracks cache-population work; partial
            # warms never touch the caches and must not skew the paper's
            # accuracy gate
            def _account():
                for th in threads:
                    th.join()
                fspan.dispatch_done()
                self.accountant.record_freshen(
                    # fabriclint: allow[clock] -- measured service/freshen time is a wall-clock contract
                    app, pred.fn, time.monotonic() - t0,
                    expected_delay=pred.expected_delay)

            threading.Thread(target=_account, daemon=True).start()
        return True

    def on_invocation_start(self, fn: str, now: Optional[float] = None):
        """Called when fn begins: the best moment to freshen successors —
        the successor will not start until fn finishes + trigger delay.
        ``now`` lets the fast path stamp the *admission* time even though
        this runs later on the freshen executor (prediction inter-arrival
        statistics must not absorb executor lag)."""
        self.predictor.observe(fn, time.monotonic() if now is None else now)
        for pred in self.predictor.successors(fn):
            self._dispatch_freshen(pred)

    def _ensure_freshen_exec(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._freshen_exec is None:
                self._freshen_exec = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="freshen-predict")
            return self._freshen_exec

    def _freshen_async(self, fn: str):
        """Queue prediction + prewarm dispatch for ``fn``'s admission on
        the dedicated freshen executor — off the request critical path."""
        # fabriclint: allow[clock] -- measured service/freshen time is a wall-clock contract
        now = time.monotonic()
        try:
            self._ensure_freshen_exec().submit(
                self.on_invocation_start, fn, now)
        except RuntimeError:
            pass      # shutting down: predictions are best-effort

    # ------------------------------------------------------------------
    def invoke(self, fn: str, args=None, freshen_successors: bool = True,
               acquire_timeout: Optional[float] = None, _span=None):
        """Run fn on a pooled instance with full bookkeeping: predecessor
        prediction, instance acquisition (cold start / queueing), service
        timing, and latency accounting.

        ``_span``: an open ``InvocationSpan`` handed down by an outer
        layer (``submit`` stamps admission time there; the cluster router
        opens it around placement).  When absent one is opened here, so
        direct ``invoke`` callers still trace."""
        pool = self._pool_or_raise(fn)
        span = _span if _span is not None else self.tracer.invocation(
            fn, app=pool.spec.app)
        if span.enabled and span.submitted_at is not None:
            # the router-executor hop: admission -> this thread
            span.phase_from("queue", span.submitted_at)
        try:
            if freshen_successors:
                with span.phase("route"):
                    self.on_invocation_start(fn)
            with span.phase("acquire"):
                inst, queue_delay, cold = pool.acquire(
                    timeout=acquire_timeout)
            span.annotate(queue_delay=queue_delay, cold=cold)
            # fabriclint: allow[clock] -- measured service/freshen time is a wall-clock contract
            t0 = time.monotonic()
            try:
                # activate so Runtime's lazy boot path attaches
                # boot_process/boot_init phases to this invocation
                with span.phase("run"), span.active():
                    result = inst.runtime.run(args)
            finally:
                with span.phase("release"):
                    pool.release(inst)
        except BaseException as exc:
            span.finish(error=type(exc).__name__)
            raise
        # accounting only on success (seed semantics): a raising function
        # body must not be billed, skew latency percentiles, or credit
        # pending freshens as useful
        # fabriclint: allow[clock] -- measured service/freshen time is a wall-clock contract
        service = time.monotonic() - t0
        self._m_e2e.observe(queue_delay + service)
        self._m_queue.observe(queue_delay)
        span.finish()
        self.accountant.record_invocation(
            pool.spec.app, fn, service,
            queue_delay=queue_delay, cold_start=cold)
        return result

    def _run_acquired(self, fn: str, pool: InstancePool, inst, args,
                      span, queue_delay: float, cold: bool):
        """Run-and-release tail of an admission whose acquire already
        happened (fast-path ``try_acquire`` hit or ``acquire_async``
        grant).  Same bookkeeping contract as ``invoke``: accounting on
        success only, span finished on every path."""
        if span.enabled and span.submitted_at is not None:
            # admission -> this thread: the only hop the fast path pays
            span.phase_from("queue", span.submitted_at)
        span.annotate(queue_delay=queue_delay, cold=cold)
        # fabriclint: allow[clock] -- measured service/freshen time is a wall-clock contract
        t0 = time.monotonic()
        try:
            try:
                with span.phase("run"), span.active():
                    result = inst.runtime.run(args)
            finally:
                with span.phase("release"):
                    pool.release(inst)
        except BaseException as exc:
            span.finish(error=type(exc).__name__)
            raise
        # fabriclint: allow[clock] -- measured service/freshen time is a wall-clock contract
        service = time.monotonic() - t0
        self._m_e2e.observe(queue_delay + service)
        self._m_queue.observe(queue_delay)
        span.finish()
        self.accountant.record_invocation(
            pool.spec.app, fn, service,
            queue_delay=queue_delay, cold_start=cold)
        return result

    def run_chain(self, fns: List[str], args=None,
                  freshen: bool = True):
        """Execute an explicit chain sequentially (orchestration-style)."""
        out = args
        for fn in fns:
            out = self.invoke(fn, out, freshen_successors=freshen)
        return out

    # ------------------------------------------------------------------
    # The thread-pool router: concurrent admission.
    def _ensure_router(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._router is None:
                self._router = ThreadPoolExecutor(
                    max_workers=self.max_router_threads,
                    thread_name_prefix="freshen-router")
            return self._router

    def submit(self, fn: str, args=None, freshen_successors: bool = True,
               acquire_timeout: Optional[float] = None,
               _span=None) -> Future:
        """Admit one invocation; returns a Future for the function result.

        Single-submission fast path: ``try_acquire`` runs inline on the
        caller thread — a warm hit dispatches only the run-and-release
        tail to the router (one hop, ``invoke.fast_path``).  On a miss
        (``invoke.slow_path``): with an ``acquire_timeout`` the request
        takes the legacy blocking-acquire path unchanged, so spill
        semantics (``PoolSaturated`` surfacing on the Future within the
        deadline) are exactly the PR 8 behavior; without one it parks a
        closure in the pool's admission-ordered ``acquire_async`` queue
        and the next ``release`` hands it the freed instance directly.
        Raises ``UnknownFunction`` synchronously for an unregistered
        ``fn``."""
        pool = self._pool_or_raise(fn)
        if _span is None:
            _span = self.tracer.invocation(fn, app=pool.spec.app)
        if not self.fast_path:
            _span.mark_submitted()
            return self._ensure_router().submit(
                self.invoke, fn, args, freshen_successors, acquire_timeout,
                _span)
        with _span.phase("acquire"):
            grabbed = pool.try_acquire()
        _span.mark_submitted()
        if grabbed is not None:
            inst, cold = grabbed
            self._m_fast.inc()
            if freshen_successors:
                self._freshen_async(fn)
            return self._ensure_router().submit(
                self._run_acquired, fn, pool, inst, args, _span, 0.0, cold)
        self._m_slow.inc()
        if acquire_timeout is not None:
            # spill path unchanged: blocking acquire with a deadline in a
            # router thread (the cluster's retry chain needs PoolSaturated
            # raised from the acquire, not a swept waiter)
            return self._ensure_router().submit(
                self.invoke, fn, args, freshen_successors, acquire_timeout,
                _span)
        if freshen_successors:
            self._freshen_async(fn)
        fut: Future = Future()
        fut.set_running_or_notify_cancel()

        def _granted(inst, queue_delay, cold, error):
            if error is not None:
                _span.finish(error=type(error).__name__)
                fut.set_exception(error)
                return
            # the waiter left the pool queue before this callback runs, so
            # shutdown's drain (which watches async_waiting_count) can kill
            # the router inside that window; don't _ensure_router here —
            # that would resurrect a leaked executor after shutdown
            with self._lock:
                router = self._router
            if router is not None:
                try:
                    inner = router.submit(
                        self._run_acquired, fn, pool, inst, args, _span,
                        queue_delay, cold)
                except RuntimeError:
                    router = None      # shut down between grant and handoff
                else:
                    inner.add_done_callback(lambda f: (
                        fut.set_exception(f.exception())
                        if f.exception() is not None
                        else fut.set_result(f.result())))
            if router is None:
                # run the tail inline on the releasing thread — an
                # admitted future is never dropped
                try:
                    fut.set_result(self._run_acquired(
                        fn, pool, inst, args, _span, queue_delay, cold))
                except BaseException as exc:
                    fut.set_exception(exc)

        pool.acquire_async(_granted)
        return fut

    def submit_chain(self, fns: List[str], args=None,
                     freshen: bool = True) -> Future:
        """Admit a function chain; returns a Future for the final link's
        result.  Tracing parity with ``submit``: a parent span (named
        ``chain:a->b->…``) stamps admission and the router hop as its
        ``queue`` phase, and every link runs under its own child span
        (annotated with the parent id and link index) exactly as a
        single submit would.  Raises ``UnknownFunction`` synchronously
        when any link is unregistered."""
        if not fns:
            raise ValueError("submit_chain: empty chain")
        pools = [self._pool_or_raise(fn) for fn in fns]
        span = self.tracer.invocation(
            "chain:" + "->".join(fns), app=pools[0].spec.app,
            chain=list(fns))
        span.mark_submitted()
        return self._ensure_router().submit(
            self._run_chain_traced, fns, args, freshen, span)

    def _run_chain_traced(self, fns: List[str], args, freshen: bool, span):
        if span.enabled and span.submitted_at is not None:
            span.phase_from("queue", span.submitted_at)
        out = args
        try:
            for i, fn in enumerate(fns):
                child = None
                if span.enabled:
                    child = self.tracer.invocation(
                        fn, app=self.pools[fn].spec.app,
                        chain_parent=span.span_id, link=i)
                    child.mark_submitted()
                out = self.invoke(fn, out, freshen_successors=freshen,
                                  _span=child)
        except BaseException as exc:
            span.finish(error=type(exc).__name__)
            raise
        span.finish()
        return out

    def shutdown(self, wait: bool = True):
        """Stop the router; with ``wait=True`` (the default) also close
        every pool's idle instances once in-flight work has drained —
        terminating subprocess backend workers so platforms never leak
        processes.  Pools stay usable afterwards (they re-provision).
        Closure-parked admissions are not router tasks yet, so the drain
        first waits for the pools' waiter queues to empty (releases from
        in-flight runs serve them) before stopping the router."""
        if wait:
            while any(p.async_waiting_count()
                      for p in list(self.pools.values())):
                time.sleep(0.001)
        with self._lock:
            router, self._router = self._router, None
            fexec, self._freshen_exec = self._freshen_exec, None
        if fexec is not None:
            fexec.shutdown(wait=wait)
        if router is not None:
            router.shutdown(wait=wait)
        if wait:
            for pool in list(self.pools.values()):
                pool.close()

    # ------------------------------------------------------------------
    def platform_stats(self) -> dict:
        """Pool + freshen counters across every registered function."""
        return {name: {**pool.stats(), **pool.freshen_stats()}
                for name, pool in self.pools.items()}

    def metrics_snapshot(self) -> dict:
        """Unified registry dump: the scheduler's own instruments plus
        every pool's (each registry's prefix — ``scheduler.`` /
        ``pool.<fn>.`` — is baked into its snapshot keys, so the merge
        is flat)."""
        out = dict(self.metrics.snapshot())
        for pool in list(self.pools.values()):
            out.update(pool.metrics.snapshot())
        return out
