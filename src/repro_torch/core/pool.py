"""Per-function instance pools — the multi-instance container model.

The seed platform held exactly one ``Runtime`` (warm container) per
function, so freshen could only be exercised one synchronous invocation at
a time.  This module generalizes that into an OpenWhisk/SPES-style pool:

* **Warm containers with keep-alive** — idle instances are retained for
  ``PoolConfig.keep_alive`` seconds, then reaped (scale-to-zero).
* **Queue-depth-driven scale-up** — when no idle instance exists and the
  pool is below ``max_instances``, an arrival provisions a new (cold)
  instance; ``scale_up_queue_depth`` throttles how eagerly.
* **Configurable cold-start cost** — new instances pay
  ``cold_start_cost`` seconds in their ``init`` hook, so cold-start
  dynamics show up in measured latency exactly where they would on a real
  platform.
* **Prewarm-aware freshen dispatch** — ``prewarm_freshen`` routes the
  paper's §3.1 freshen hook to *idle pooled instances* (and, with
  ``prewarm_provision``, proactively cold-starts an instance off the
  critical path when none is idle), unifying freshen with SPES-style
  proactive provisioning: prewarming becomes a pool policy rather than a
  per-runtime call.

Idle instances are reused LIFO (most recently used first), so the
instance an invocation lands on is the one most likely to have been
freshened — that is what makes per-instance ``fr_state`` prewarming pay
off under load.

Thread-safety: all pool state is guarded by one condition variable;
``acquire`` blocks (measuring queueing delay) when the pool is saturated.

Two admission modes share that state (event-driven lifecycle control,
arxiv 2604.05465):

* **Thread-parked** — the legacy blocking ``acquire(timeout)``: the
  calling thread waits on the condition variable.
* **Closure-parked** — ``try_acquire()`` grabs an instance without ever
  blocking, and ``acquire_async(cb, timeout)`` parks a *callback* in an
  admission-ordered waiter queue when nothing is available.  ``release``
  hands the freed instance straight to the next parked waiter under the
  same single lock acquisition (no executor round-trip); waiter timeouts
  are swept by the ``AdaptDaemon`` tick via ``sweep_waiters``.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field, fields, replace
from enum import Enum
from typing import Callable, Deque, Dict, List, Optional, Tuple

from repro_torch.core.backend import make_backend
from repro_torch.core.runtime import FunctionSpec, Runtime, WarmthLevel
from repro_torch.telemetry import MetricsRegistry


@dataclass
class PoolConfig:
    """Sizing and lifecycle policy for one function's instance pool."""
    max_instances: int = 4
    keep_alive: float = 30.0          # idle seconds before an instance is reaped
    cold_start_cost: float = 0.0      # simulated sandbox-creation seconds
                                      # (thread backend only; the subprocess
                                      # backend's cold start is measured)
    scale_up_queue_depth: int = 1     # waiters needed before scaling up (>=1)
    prewarm_provision: bool = False   # cold-start a fresh instance for prewarm
    prewarm_fanout: int = 1           # idle instances to freshen per dispatch
    prewarm_busy_fallback: bool = True  # no idle instance: freshen a busy one
                                        # (seed behavior — fr_state is
                                        # thread-safe under the run hook)
    backend: str = "thread"           # instance backend (repro_torch.core.backend:
                                      # thread | subprocess | snapshot); a
                                      # live change applies to instances
                                      # provisioned after it
    # -- graded warmth (SPES-style partial-warm ladder) ------------------
    graded_warmth: bool = False       # keep-alive expiry demotes one warmth
                                      # rung per sweep instead of reaping
    process_boot_fraction: float = 0.8  # thread backend: share of the
                                        # simulated cold start that is
                                        # sandbox boot (PROCESS rung)
    # per-level idle limits; None falls back to ``keep_alive``.  An
    # instance idle at a rung past its limit drops one rung (HOT ->
    # INITIALIZED -> PROCESS); past the PROCESS limit it is reaped.
    keep_alive_hot: Optional[float] = None
    keep_alive_initialized: Optional[float] = None
    keep_alive_process: Optional[float] = None


class InstanceState(Enum):
    IDLE = "idle"
    BUSY = "busy"
    REAPED = "reaped"


@dataclass
class PooledInstance:
    """One warm container slot: a Runtime plus pool-side lifecycle state."""
    instance_id: int
    runtime: Runtime
    state: InstanceState = InstanceState.IDLE
    created_at: float = 0.0
    last_used: float = 0.0
    level_since: float = 0.0          # when the current warmth rung was set
    invocations: int = 0


class PoolSaturated(TimeoutError):
    """acquire() timed out: every instance busy and the pool at its cap.

    Carries the saturation context as structured fields (``fn``,
    ``queue_depth``, ``pool_size``, ``max_instances``, ``shard``) so
    callers catching it out of a router Future — notably the cluster
    benchmarks — can report *which* function on *which* shard saturated,
    not just that something timed out."""

    def __init__(self, fn: str, queue_depth: int = 0, pool_size: int = 0,
                 max_instances: int = 0, shard: Optional[int] = None):
        self.fn = fn
        self.queue_depth = queue_depth
        self.pool_size = pool_size
        self.max_instances = max_instances
        self.shard = shard
        where = f" on shard {shard}" if shard is not None else ""
        super().__init__(
            f"pool {fn!r}{where} saturated: {queue_depth} waiting, "
            f"{pool_size}/{max_instances} instances all busy")


# AcquireCallback signature: cb(instance, queue_delay_seconds, cold, error).
# Exactly one of (instance, error) is non-None; the callback fires exactly
# once, always OUTSIDE the pool lock — from the admitting thread (immediate
# grant), a releasing thread (direct handoff), or the daemon sweep (timeout).
AcquireCallback = Callable[
    [Optional["PooledInstance"], float, bool, Optional[BaseException]], None]


@dataclass
class _AsyncWaiter:
    """One parked ``acquire_async`` request.  ``enqueued``/``deadline``
    are ``time.monotonic``-domain (matching blocking ``acquire``'s
    timeout semantics), NOT the injectable pool clock — waiter timeouts
    are wall-clock contracts with the caller, not policy time."""
    cb: AcquireCallback
    enqueued: float
    deadline: Optional[float]
    state: str = "pending"            # pending | served | failed | cancelled
    error: Optional[BaseException] = None


class AcquireWaiter:
    """Caller-side handle for one parked ``acquire_async`` request."""
    __slots__ = ("_pool", "_waiter")

    def __init__(self, pool: "InstancePool", waiter: _AsyncWaiter):
        self._pool = pool
        self._waiter = waiter

    @property
    def pending(self) -> bool:
        with self._pool._cond:
            return self._waiter.state == "pending"

    def cancel(self) -> bool:
        """Withdraw the request.  Returns True if it was still parked —
        the callback will then never fire.  Returns False when the grant
        or timeout already won the race (the callback fired or is about
        to)."""
        with self._pool._cond:
            if self._waiter.state != "pending":
                return False
            self._waiter.state = "cancelled"
            try:
                self._pool._async_waiters.remove(self._waiter)
            except ValueError:
                pass
            return True


class InstancePool:
    """All instances of one function, plus the scale/keep-alive policy."""

    def __init__(self, spec: FunctionSpec, config: Optional[PoolConfig] = None,
                 runtime_factory: Optional[Callable[[], Runtime]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 eager_instances: int = 0):
        self.spec = spec
        self.config = config or PoolConfig()
        self.clock = clock
        # set by repro_torch.cluster.ClusterWorker so saturation errors and stats
        # name the shard this pool lives on; None outside a cluster
        self.shard: Optional[int] = None
        self._factory = runtime_factory or (
            lambda: Runtime(spec, cold_start_cost=self.config.cold_start_cost,
                            clock=clock,
                            backend=make_backend(self.config.backend),
                            process_boot_fraction=self.config
                            .process_boot_fraction))
        self._cond = threading.Condition()
        self._instances: Dict[int, PooledInstance] = {}
        self._idle: List[PooledInstance] = []     # LIFO stack
        self._next_id = 0
        self._waiting = 0
        # admission-ordered FIFO of closure-parked acquires (acquire_async);
        # cancelled waiters are removed eagerly, so len() is live demand
        self._async_waiters: Deque[_AsyncWaiter] = deque()
        self._retired = False         # retire(): released instances close
        # lifecycle counters live in the pool's own metrics registry;
        # the legacy attribute names (``pool.cold_starts`` …) are
        # read-only property views below, and ``stats()`` still copies
        # the whole set under the pool lock in one go (never
        # field-by-field from outside — that tears)
        self.metrics = MetricsRegistry(f"pool.{spec.name}.")
        self._c_cold = self.metrics.counter("cold_starts")
        self._c_warm = self.metrics.counter("warm_acquires")
        self._c_queued = self.metrics.counter("queued_acquires")
        self._c_reaped = self.metrics.counter("reaped")
        self._c_dead = self.metrics.counter("dead_evictions")
        self._c_demotions = self.metrics.counter("demotions")
        self._c_partial = self.metrics.counter("partial_cold_starts")
        self._c_prewarms = self.metrics.counter("prewarm_dispatches")
        self._c_provisioned = self.metrics.counter("prewarm_provisioned")
        self._h_queue_delay = self.metrics.histogram("queue_delay_seconds")
        self.metrics.gauge("instances").set_fn(self.size)
        self.metrics.gauge("idle").set_fn(self.idle_count)
        # lifetime fr_state counters of reaped instances, folded in by
        # reap() so freshen_stats() is a lifetime view, not survivors-only
        self._reaped_freshen_stats = {"freshened": 0, "inline": 0,
                                      "waits": 0, "hits": 0}
        # measured init seconds of reaped instances: [sum, count] — keeps
        # measured_cold_start() a lifetime mean across instance churn
        self._reaped_init = [0.0, 0]
        # per-rung splits of the same fold: sandbox-boot (PROCESS) share
        # and init_fn/plan (INITIALIZED) share
        self._reaped_process = [0.0, 0]
        self._reaped_init_step = [0.0, 0]
        # snapshot-backend fork source: one template per (function, pool),
        # shared by every instance the pool ever provisions.  Started
        # eagerly at pool construction (= register time) so the template
        # spawn + working-set record happen off the first arrival's
        # critical path; closed with the pool (restartable).
        self._template = None
        if self.config.backend == "snapshot":
            self._ensure_template().start()
        with self._cond:
            for _ in range(eager_instances):
                self._create_locked()

    # -- legacy counter views (registry-backed) --------------------------
    # callers and tests read these as plain ints; writes go through the
    # registry counters at the increment sites
    @property
    def cold_starts(self) -> int:
        return self._c_cold.value

    @property
    def warm_acquires(self) -> int:
        return self._c_warm.value

    @property
    def queued_acquires(self) -> int:
        return self._c_queued.value

    @property
    def reaped(self) -> int:
        return self._c_reaped.value

    @property
    def dead_evictions(self) -> int:
        return self._c_dead.value

    @property
    def demotions(self) -> int:
        return self._c_demotions.value

    @property
    def partial_cold_starts(self) -> int:
        return self._c_partial.value

    @property
    def prewarm_dispatches(self) -> int:
        return self._c_prewarms.value

    @property
    def prewarm_provisioned(self) -> int:
        return self._c_provisioned.value

    # -- construction ---------------------------------------------------
    def _ensure_template(self):
        if self._template is None:
            from repro_torch.core.backend_template import SnapshotTemplate
            self._template = SnapshotTemplate(self.spec)
        return self._template

    @property
    def template(self):
        """The pool-owned ``SnapshotTemplate``, or None (non-snapshot
        backends, or snapshot configured but nothing provisioned yet)."""
        return self._template

    def _attach_backend_locked(self, runtime: Runtime) -> Runtime:
        """Pool-side backend wiring: a templateless ``SnapshotBackend``
        gets the pool's shared template, so fork economics (one warm
        template, many cheap restores) hold across instance churn."""
        from repro_torch.core.backend import SnapshotBackend
        backend = runtime.backend
        if isinstance(backend, SnapshotBackend) and backend.template is None:
            backend.template = self._ensure_template()
        return runtime

    def _create_locked(self) -> PooledInstance:
        inst = PooledInstance(self._next_id,
                              self._attach_backend_locked(self._factory()),
                              created_at=self.clock(), last_used=self.clock(),
                              level_since=self.clock())
        self._next_id += 1
        self._instances[inst.instance_id] = inst
        self._idle.append(inst)
        return inst

    def adopt(self, runtime: Runtime) -> PooledInstance:
        """Install a caller-built Runtime as a pool instance (compat path)."""
        with self._cond:
            inst = PooledInstance(self._next_id,
                                  self._attach_backend_locked(runtime),
                                  created_at=self.clock(),
                                  last_used=self.clock())
            self._next_id += 1
            self._instances[inst.instance_id] = inst
            self._idle.append(inst)
            self._cond.notify()
        self._pump_async()            # the adoptee may serve a parked waiter
        return inst

    @property
    def primary(self) -> Optional[Runtime]:
        """The longest-lived live instance's runtime (single-instance view)."""
        with self._cond:
            if not self._instances:
                return None
            return self._instances[min(self._instances)].runtime

    def ensure_primary(self) -> Runtime:
        """Live single-instance view that survives scale-to-zero: provisions
        a fresh instance when the pool is empty and cold-starts it so
        seed-era callers that dereference ``fr_state`` directly always see
        a live runtime (the original always-initialized contract)."""
        with self._cond:
            if not self._instances:
                self._create_locked()
                self._cond.notify()
            rt = self._instances[min(self._instances)].runtime
        if not rt.initialized:
            # Idempotent and lock-guarded inside Runtime: concurrent callers
            # block here until whoever got there first finishes the cold
            # start, so no caller ever sees fr_state=None.
            rt.init()
        return rt

    # -- sizing ---------------------------------------------------------
    def size(self) -> int:
        with self._cond:
            return len(self._instances)

    def idle_count(self) -> int:
        with self._cond:
            return len(self._idle)

    def warm_idle_count(self,
                        min_level: WarmthLevel = WarmthLevel.INITIALIZED
                        ) -> int:
        """Idle instances at or above ``min_level`` that an arrival can
        *actually* land on warm — which excludes instances whose freshen/
        partial-warm is still in flight, because ``acquire``'s warm path
        skips those while another warm container is available.  This is
        the warmth signal the cluster's warmth-aware routing policy
        reads, so it must match acquire's preference, not overstate it."""
        with self._cond:
            return sum(1 for i in self._idle
                       if i.runtime.warmth >= min_level
                       and not i.runtime.freshen_in_flight())

    def warm_total_count(self,
                         min_level: WarmthLevel = WarmthLevel.INITIALIZED
                         ) -> int:
        """Instances at or above ``min_level`` whether idle, busy, or
        mid-freshen — the warmth a drain must not discard: a busy
        instance is warmth an in-flight invocation merely borrowed, and
        an in-flight freshen is warmth already paid for."""
        with self._cond:
            return sum(1 for i in self._instances.values()
                       if i.runtime.warmth >= min_level)

    def warmth_score(self) -> float:
        """Level-weighted warmth of the idle, immediately-landable
        instances: each contributes ``warmth / HOT`` (a HOT instance
        counts 1.0, a PROCESS standby 1/3).  The graded analogue of
        ``warm_idle_count`` for warmth-aware routing — a shard holding a
        HOT instance outranks one holding only a PROCESS standby."""
        with self._cond:
            return sum(int(i.runtime.warmth) / int(WarmthLevel.HOT)
                       for i in self._idle
                       if not i.runtime.freshen_in_flight())

    def waiting_count(self) -> int:
        """Acquires currently waiting for an instance (queue depth) —
        thread-parked blocking acquires plus closure-parked async
        waiters.  The load signal cluster routing and rebalancing read."""
        with self._cond:
            return self._waiting + len(self._async_waiters)

    def async_waiting_count(self) -> int:
        """Closure-parked waiters only (``acquire_async`` requests not
        yet granted or timed out) — what a drain must wait out."""
        with self._cond:
            return len(self._async_waiters)

    def busy_count(self) -> int:
        with self._cond:
            return len(self._instances) - len(self._idle)

    def load(self) -> int:
        """Busy instances + waiting acquires (both parking modes) under
        ONE lock acquisition — the cluster load signal.  Summing
        ``busy_count()`` and ``waiting_count()`` from outside tears: a
        release between the two reads double-counts (the instance
        already idle, the waiter not yet woken) and routing chases
        phantom load."""
        with self._cond:
            return (len(self._instances) - len(self._idle)) \
                + self._waiting + len(self._async_waiters)

    def idle_capacity(self) -> int:
        """Immediately-usable headroom (idle instances + unprovisioned
        slots) under one lock acquisition — the cross-shard freshen
        placement signal.  The former read (``stats()`` then
        ``config.max_instances`` separately) could tear across a
        concurrent reconfigure."""
        with self._cond:
            return len(self._idle) + max(
                0, self.config.max_instances - len(self._instances))

    # -- lifecycle ------------------------------------------------------
    def _keep_alive_for(self, level: WarmthLevel) -> float:
        """The idle limit for one warmth rung (graded mode); per-level
        overrides fall back to the binary ``keep_alive``."""
        c = self.config
        if level >= WarmthLevel.HOT:
            v = c.keep_alive_hot
        elif level == WarmthLevel.INITIALIZED:
            v = c.keep_alive_initialized
        else:
            v = c.keep_alive_process
        return c.keep_alive if v is None else v

    def reap(self, now: Optional[float] = None) -> int:
        """Evict idle instances past keep-alive; returns how many died.
        Repeated traffic gaps longer than ``keep_alive`` return the pool
        all the way to zero (scale-to-zero).

        With ``graded_warmth`` on, expiry is a *ladder walk* instead of a
        cliff: an instance idle past its rung's limit drops exactly one
        rung per sweep (HOT -> INITIALIZED -> PROCESS — never skipping
        levels downward), and only an instance idle past the PROCESS
        rung's limit is reaped outright.  Demotion releases the rung's
        cost (caches, inited runtime) while keeping the cheaper remainder
        resident, so a late arrival pays a partial — not full — cold
        start."""
        now = self.clock() if now is None else now
        if self.config.graded_warmth:
            return self._reap_graded(now)
        dead: List[PooledInstance] = []
        with self._cond:
            keep: List[PooledInstance] = []
            for inst in self._idle:
                if now - inst.last_used > self.config.keep_alive \
                        and not inst.runtime.freshen_in_flight():
                    # an in-flight prewarm marks the instance as predicted
                    # traffic: never reap out from under it
                    dead.append(inst)
                else:
                    keep.append(inst)
            self._idle = keep
            for inst in dead:
                inst.state = InstanceState.REAPED
                del self._instances[inst.instance_id]
            self._c_reaped.inc(len(dead))
        self._fold_and_close(dead, join_timeout=0.0)
        return len(dead)

    def _reap_graded(self, now: float) -> int:
        dead: List[PooledInstance] = []
        demote: List[PooledInstance] = []
        with self._cond:
            keep: List[PooledInstance] = []
            for inst in self._idle:
                if inst.runtime.freshen_in_flight():
                    keep.append(inst)      # predicted traffic: hands off
                    continue
                level = inst.runtime.warmth
                idle_for = now - max(inst.last_used, inst.level_since)
                if idle_for <= self._keep_alive_for(level):
                    keep.append(inst)
                elif level > WarmthLevel.PROCESS:
                    demote.append(inst)    # one rung down, stays resident
                else:
                    dead.append(inst)      # past the PROCESS floor: evict
            # demote targets leave the idle list while their (possibly
            # remote, pipe-round-trip) demotion runs unlocked, so no
            # acquire can land on a rung mid-teardown
            self._idle = keep
            for inst in dead:
                inst.state = InstanceState.REAPED
                del self._instances[inst.instance_id]
            self._c_reaped.inc(len(dead))
        self._fold_and_close(dead, join_timeout=0.0)
        failed: List[PooledInstance] = []
        for inst in demote:
            target = WarmthLevel(int(inst.runtime.warmth) - 1)
            try:
                inst.runtime.demote_to(target)
            except Exception:
                failed.append(inst)        # substrate died mid-demote
                continue
            with self._cond:
                if self._retired:
                    failed.append(inst)    # pool retired mid-demote
                    continue
                if inst.instance_id in self._instances:
                    inst.level_since = now
                    # re-enter at the *cold* end of the LIFO stack: a
                    # freshly demoted instance should be the last reused
                    self._idle.insert(0, inst)
                    self._c_demotions.inc()
                    self._cond.notify()
        if failed:
            with self._cond:
                for inst in failed:
                    if inst.instance_id in self._instances:
                        inst.state = InstanceState.REAPED
                        del self._instances[inst.instance_id]
                        self._c_dead.inc()
                        self._cond.notify()
            self._fold_and_close(failed, join_timeout=0.0)
        if demote:
            # demoted instances re-entered the idle list: a parked
            # waiter may land on one (paying only the missing rungs)
            self._pump_async()
        return len(dead) + len(failed)

    def _fold_and_close(self, dead: List[PooledInstance],
                        join_timeout: Optional[float] = 0.0):
        """Fold dying instances' lifetime counters into the pool and close
        their runtimes (terminating subprocess backend workers).  Runs
        outside the pool lock: a subprocess backend's stats query is a
        pipe round-trip and must never stall acquires."""
        folded: List[dict] = []
        init_s, init_n = 0.0, 0
        proc_s, proc_n = 0.0, 0
        step_s, step_n = 0.0, 0
        for inst in dead:
            inst.runtime.join_freshen(timeout=join_timeout)
            stats = inst.runtime.freshen_stats()
            if stats:
                folded.append(stats)
            if inst.runtime.warmth >= WarmthLevel.PROCESS:
                proc_s += inst.runtime.process_seconds
                proc_n += 1
            if inst.runtime.initialized:
                init_s += inst.runtime.init_seconds
                init_n += 1
                step_s += inst.runtime.init_step_seconds
                step_n += 1
            inst.runtime.close()
        if not dead:
            return
        with self._cond:
            for stats in folded:
                for k in self._reaped_freshen_stats:
                    self._reaped_freshen_stats[k] += stats.get(k, 0)
            self._reaped_init[0] += init_s
            self._reaped_init[1] += init_n
            self._reaped_process[0] += proc_s
            self._reaped_process[1] += proc_n
            self._reaped_init_step[0] += step_s
            self._reaped_init_step[1] += step_n

    def close(self):
        """Shut the pool down: evict every idle instance regardless of
        keep-alive and close its runtime (terminating subprocess backend
        workers).  Busy instances are left to their in-flight invocation —
        drain first (``FreshenScheduler.shutdown(wait=True)`` does).  The
        pool stays usable: a later acquire provisions fresh instances.
        A snapshot template is closed too (it is restartable, so that
        later acquire transparently re-spawns it)."""
        with self._cond:
            dead, self._idle = self._idle, []
            for inst in dead:
                inst.state = InstanceState.REAPED
                del self._instances[inst.instance_id]
            self._c_reaped.inc(len(dead))
        self._fold_and_close(dead, join_timeout=5.0)
        if self._template is not None:
            self._template.close()
        # any waiters parked through the close re-provision fresh
        # instances (the pool stays usable) — no admitted request drops
        self._pump_async()

    def retire(self):
        """``close()`` with no way back: instances released *after* this
        call are closed instead of re-idled.  For pools on a shard that
        left its cluster undrained — a busy instance finishing later
        must not park a subprocess backend worker in an idle list nobody
        will ever reap.  Closure-parked waiters are failed with
        ``PoolSaturated`` (their callbacks see the error — no admitted
        request silently drops)."""
        with self._cond:
            self._retired = True
            failed: List[_AsyncWaiter] = []
            while self._async_waiters:
                w = self._async_waiters.popleft()
                if w.state == "pending":
                    w.state = "failed"
                    w.error = self._saturated_locked()
                    failed.append(w)
        self._dispatch_async([], failed)
        self.close()

    def _pop_warmest_locked(self) -> PooledInstance:
        """Warmth-aware LIFO: prefer the *highest-rung* servable instance
        whose freshen is not mid-flight (HOT over merely INITIALIZED),
        most recently used among equals, so an arrival neither lands on a
        still-booting provisioned instance nor blocks in FrWait behind an
        in-progress prewarm while another warm container sits idle.
        Below the servable tier the ladder still ranks: a PROCESS standby
        beats a COLD slot — the arrival pays only the init share.  (With
        a single idle instance there is no choice — waiting on its
        in-flight freshen costs no more than doing the work inline.)"""
        best_i, best_key = None, None
        for i in range(len(self._idle) - 1, -1, -1):
            rt = self._idle[i].runtime
            in_flight = rt.freshen_in_flight()
            key = (rt.warmth >= WarmthLevel.INITIALIZED and not in_flight,
                   int(rt.warmth), not in_flight, i)
            if best_key is None or key > best_key:
                best_i, best_key = i, key
        return self._idle.pop(best_i)

    def _scale_up_allowed_locked(self, extra_waiters: int = 0) -> bool:
        """Demand counts thread-parked acquires (``_waiting`` includes a
        blocked requester), closure-parked async waiters, and
        ``extra_waiters`` for a requester not represented in either (a
        ``try_acquire``/``acquire_async`` caller probing before parking)
        — so with the default depth of 1 any arrival that finds no idle
        instance provisions a new one."""
        if len(self._instances) >= self.config.max_instances:
            return False
        if not self._instances:
            return True                       # from zero: always start one
        demand = self._waiting + len(self._async_waiters) + extra_waiters
        return demand >= self.config.scale_up_queue_depth

    def _saturated_locked(self) -> PoolSaturated:
        return PoolSaturated(
            self.spec.name,
            queue_depth=self._waiting + len(self._async_waiters),
            pool_size=len(self._instances),
            max_instances=self.config.max_instances,
            shard=self.shard)

    def _try_take_locked(self, doomed: List[PooledInstance],
                         extra_waiters: int = 0
                         ) -> Optional[PooledInstance]:
        """One non-blocking grab attempt: pop the warmest *healthy* idle
        instance (corpses are evicted into ``doomed`` for the caller to
        fold outside the lock — dropping one shrinks the pool, so the
        same call may then scale up fresh instead of failing), else
        provision when allowed.  Returns None when saturated."""
        while self._idle:
            inst = self._pop_warmest_locked()
            if not inst.runtime.healthy():
                # any provisioned rung can die under us — a PROCESS
                # standby corpse is as unusable as a dead HOT worker
                inst.state = InstanceState.REAPED
                del self._instances[inst.instance_id]
                self._c_dead.inc()
                doomed.append(inst)
                continue
            return inst
        if self._scale_up_allowed_locked(extra_waiters):
            inst = self._create_locked()
            self._idle.remove(inst)
            return inst
        return None

    def _mark_acquired_locked(self, inst: PooledInstance,
                              waited: bool) -> bool:
        """Transition a just-granted instance to BUSY and account the
        acquire; returns the cold-start flag."""
        inst.state = InstanceState.BUSY
        cold = not inst.runtime.initialized
        if cold:
            self._c_cold.inc()
            if inst.runtime.warmth > WarmthLevel.COLD:
                # landing on a PROCESS standby: the sandbox share is
                # already paid, only the init share remains
                self._c_partial.inc()
        else:
            self._c_warm.inc()
        if waited:
            self._c_queued.inc()
        return cold

    def acquire(self, timeout: Optional[float] = None
                ) -> Tuple[PooledInstance, float, bool]:
        """Claim an instance for one invocation (thread-parked mode).

        Returns ``(instance, queue_delay_seconds, cold_start)``.  Prefers
        the most recently used idle instance (LIFO — the one a prewarm
        freshen most likely touched); scales up when allowed; otherwise
        blocks until a release, accumulating queueing delay.

        An idle instance whose backend substrate died (subprocess worker
        or snapshot fork killed) is evicted here instead of handed out:
        dropping it shrinks the pool, so the same loop iteration may then
        scale up a fresh instance rather than fail the invocation."""
        # fabriclint: allow[clock] -- waiter deadlines/queue delay are wall-clock contracts
        t0 = time.monotonic()
        self.reap()
        doomed: List[PooledInstance] = []
        try:
            with self._cond:
                waited = False
                self._waiting += 1
                try:
                    while True:
                        inst = self._try_take_locked(doomed)
                        if inst is not None:
                            break
                        remaining = (None if timeout is None
                                     else timeout - (time.monotonic() - t0))
                        if remaining is not None and remaining <= 0:
                            raise self._saturated_locked()
                        waited = True
                        self._cond.wait(remaining)
                finally:
                    self._waiting -= 1
                cold = self._mark_acquired_locked(inst, waited)
        finally:
            # close corpses outside the lock: stats/close on a dead
            # channel backend must never stall other acquires
            self._fold_and_close(doomed, join_timeout=0.0)
        # fabriclint: allow[clock] -- waiter deadlines/queue delay are wall-clock contracts
        queue_delay = time.monotonic() - t0
        self._h_queue_delay.observe(queue_delay)
        return inst, queue_delay, cold

    def try_acquire(self) -> Optional[Tuple[PooledInstance, bool]]:
        """Non-blocking acquire — the single-submission fast path.

        Returns ``(instance, cold_start)`` when an idle instance (or an
        allowed scale-up slot) is immediately available, else None: the
        caller then falls back to ``acquire``/``acquire_async``.  Never
        jumps the queue: while async waiters are parked, callers get
        None so admission order holds.  Runs the same opportunistic
        keep-alive reap as blocking ``acquire`` — the fast path must
        not hand out an instance whose keep-alive already expired (a
        daemon tick may not have swept it yet), or lifecycle policy
        would silently depend on the admission mode."""
        self.reap()
        doomed: List[PooledInstance] = []
        try:
            with self._cond:
                if self._async_waiters or self._retired:
                    return None
                inst = self._try_take_locked(doomed, extra_waiters=1)
                if inst is None:
                    return None
                cold = self._mark_acquired_locked(inst, waited=False)
        finally:
            self._fold_and_close(doomed, join_timeout=0.0)
        self._h_queue_delay.observe(0.0)
        return inst, cold

    def acquire_async(self, cb: AcquireCallback,
                      timeout: Optional[float] = None) -> AcquireWaiter:
        """Closure-parked acquire: park a callback, not a thread.

        When an instance is immediately available the callback fires
        synchronously on the calling thread (still outside the pool
        lock).  Otherwise the request joins an admission-ordered FIFO;
        ``release`` hands freed instances directly to the head waiter,
        and ``sweep_waiters`` (driven by the ``AdaptDaemon`` tick) fails
        expired waiters with ``PoolSaturated``.  The callback fires
        exactly once — ``cb(instance, queue_delay, cold, error)`` — or
        never, if the returned handle is cancelled first.  Like
        ``acquire``/``try_acquire``, the immediate-grant probe reaps
        expired idle instances first, so admission mode never changes
        keep-alive semantics."""
        self.reap()
        # fabriclint: allow[clock] -- waiter deadlines/queue delay are wall-clock contracts
        t0 = time.monotonic()
        deadline = None if timeout is None else t0 + timeout
        waiter = _AsyncWaiter(cb=cb, enqueued=t0, deadline=deadline)
        doomed: List[PooledInstance] = []
        inst = None
        cold = False
        with self._cond:
            if self._retired:
                waiter.state = "failed"
                waiter.error = self._saturated_locked()
            elif not self._async_waiters:
                inst = self._try_take_locked(doomed, extra_waiters=1)
                if inst is not None:
                    waiter.state = "served"
                    cold = self._mark_acquired_locked(inst, waited=False)
            if waiter.state == "pending":
                self._async_waiters.append(waiter)
        self._fold_and_close(doomed, join_timeout=0.0)
        if waiter.state == "served":
            # fabriclint: allow[clock] -- waiter deadlines/queue delay are wall-clock contracts
            queue_delay = time.monotonic() - t0
            self._h_queue_delay.observe(queue_delay)
            self._fire_cb(waiter, inst, queue_delay, cold, None)
        elif waiter.state == "failed":
            # fabriclint: allow[clock] -- waiter deadlines/queue delay are wall-clock contracts
            self._fire_cb(waiter, None, time.monotonic() - t0, False,
                          waiter.error)
        return AcquireWaiter(self, waiter)

    def _fire_cb(self, waiter: _AsyncWaiter, inst: Optional[PooledInstance],
                 queue_delay: float, cold: bool,
                 error: Optional[BaseException]):
        """Run one waiter callback, swallowing its exceptions: a raising
        callback must never break the releasing thread's path (it would
        leak the *next* release's handoff)."""
        try:
            waiter.cb(inst, queue_delay, cold, error)
        except Exception:
            pass

    def _serve_async_locked(self, doomed: List[PooledInstance]
                            ) -> Tuple[List, List]:
        """Match parked waiters with available capacity, in admission
        order.  Expired waiters encountered at the head are failed
        rather than served.  Returns ``(grants, expired)`` for
        ``_dispatch_async`` to fire outside the lock."""
        grants: List[Tuple[_AsyncWaiter, PooledInstance, bool]] = []
        expired: List[_AsyncWaiter] = []
        # fabriclint: allow[clock] -- waiter deadlines/queue delay are wall-clock contracts
        now = time.monotonic()
        while self._async_waiters:
            w = self._async_waiters[0]
            if w.state != "pending":          # defensive: cancel races
                self._async_waiters.popleft()
                continue
            if w.deadline is not None and now >= w.deadline:
                self._async_waiters.popleft()
                w.state = "failed"
                w.error = self._saturated_locked()
                expired.append(w)
                continue
            # the waiter itself is still in the deque, so demand already
            # counts it — no extra_waiters
            inst = self._try_take_locked(doomed)
            if inst is None:
                break
            self._async_waiters.popleft()
            w.state = "served"
            cold = self._mark_acquired_locked(inst, waited=True)
            grants.append((w, inst, cold))
        return grants, expired

    def _dispatch_async(self, grants: List, expired: List):
        """Fire grant/expiry callbacks collected under the lock."""
        # fabriclint: allow[clock] -- waiter deadlines/queue delay are wall-clock contracts
        now = time.monotonic()
        for w, inst, cold in grants:
            queue_delay = now - w.enqueued
            self._h_queue_delay.observe(queue_delay)
            self._fire_cb(w, inst, queue_delay, cold, None)
        for w in expired:
            self._fire_cb(w, None, now - w.enqueued, False, w.error)

    def _pump_async(self):
        """Serve parked waiters after capacity may have appeared
        (eviction, adoption, reconfigure, demotion re-idle).  Release
        integrates the same serve inline under its own lock hold."""
        doomed: List[PooledInstance] = []
        with self._cond:
            grants, expired = self._serve_async_locked(doomed)
        self._fold_and_close(doomed, join_timeout=0.0)
        self._dispatch_async(grants, expired)

    def sweep_waiters(self, now: Optional[float] = None) -> int:
        """Fail closure-parked waiters past their deadline with
        ``PoolSaturated`` and opportunistically serve any that capacity
        has appeared for (self-healing against a missed pump).  Driven
        by the ``AdaptDaemon`` tick — the async analogue of the blocking
        ``acquire``'s own timeout bookkeeping.  ``now`` is in the
        ``time.monotonic`` domain (waiter deadlines are wall-clock
        contracts, not pool-clock policy time)."""
        now = time.monotonic() if now is None else now
        expired: List[_AsyncWaiter] = []
        doomed: List[PooledInstance] = []
        with self._cond:
            keep: Deque[_AsyncWaiter] = deque()
            for w in self._async_waiters:
                if w.state == "pending" and w.deadline is not None \
                        and now >= w.deadline:
                    w.state = "failed"
                    w.error = self._saturated_locked()
                    expired.append(w)
                elif w.state == "pending":
                    keep.append(w)
            self._async_waiters = keep
            grants, late = self._serve_async_locked(doomed)
            expired.extend(late)
        self._fold_and_close(doomed, join_timeout=0.0)
        self._dispatch_async(grants, expired)
        return len(expired)

    def evict(self, inst: PooledInstance) -> bool:
        """Evict one instance the caller knows is unusable (its backend
        died mid-invocation).  Safe on busy or idle instances; returns
        False if the instance was already gone.  The next acquire then
        provisions fresh instead of re-failing on the corpse."""
        with self._cond:
            if inst.instance_id not in self._instances:
                return False
            if inst in self._idle:
                self._idle.remove(inst)
            inst.state = InstanceState.REAPED
            del self._instances[inst.instance_id]
            self._c_dead.inc()
            self._cond.notify()       # capacity freed: a waiter may scale up
        self._fold_and_close([inst], join_timeout=0.0)
        self._pump_async()            # freed capacity may admit a waiter
        return True

    def release(self, inst: PooledInstance):
        # liveness probe outside the lock (it may touch the backend); a
        # dead substrate is evicted instead of re-idled, so no later
        # acquire lands on a corpse and waits out keep-alive
        dead = not inst.runtime.healthy()
        doomed: List[PooledInstance] = []
        grants: List = []
        expired: List = []
        with self._cond:
            if inst.state is InstanceState.REAPED:
                return
            inst.invocations += 1
            if self._retired or dead:
                inst.state = InstanceState.REAPED
                del self._instances[inst.instance_id]
                if dead and not self._retired:
                    self._c_dead.inc()
                else:
                    self._c_reaped.inc()
                self._cond.notify()   # capacity freed: a waiter may scale up
            else:
                inst.state = InstanceState.IDLE
                inst.last_used = self.clock()
                self._idle.append(inst)
                # direct handoff: serve the parked waiter queue under
                # THIS lock hold — the freed instance reaches the next
                # closure-parked request without an executor round-trip
                grants, expired = self._serve_async_locked(doomed)
                self._cond.notify()
            closing = self._retired or dead
        if closing:
            self._fold_and_close([inst], join_timeout=0.0)
        self._fold_and_close(doomed, join_timeout=0.0)
        self._dispatch_async(grants, expired)
        if dead and not self._retired:
            # the corpse's slot is free again: a parked waiter may now
            # scale up a fresh instance
            self._pump_async()

    def reconfigure(self, config: PoolConfig) -> PoolConfig:
        """Swap the pool's sizing/lifecycle policy live; returns the old
        config (a copy).  Fields are copied *into* the existing config
        object so every closure holding a reference (the default runtime
        factory, scheduler-registered factories) sees the new values —
        this is how a trace-learned ``HistoryPolicy`` retunes a running
        pool.  Waiters are woken: a raised ``max_instances`` lets a queued
        acquire scale up immediately; a lowered cap or keep-alive takes
        effect at the next reap (busy instances are never force-killed)."""
        with self._cond:
            old = replace(self.config)
            for f in fields(PoolConfig):
                setattr(self.config, f.name, getattr(config, f.name))
            self._cond.notify_all()
        self._pump_async()        # a raised cap may admit parked waiters
        return old

    # -- prewarm-aware freshen dispatch --------------------------------
    def prewarm_freshen(self, max_dispatch: Optional[int] = None,
                        provision: Optional[bool] = None,
                        level: Optional[WarmthLevel] = None
                        ) -> List[threading.Thread]:
        """Dispatch warmth provisioning to idle pooled instances.

        This is the platform half of §3.1 under multi-instance pooling:
        the scheduler predicted this function will run soon, so warm the
        containers an arrival is most likely to land on (top of the LIFO
        idle stack).  ``level`` picks the target rung (default HOT — the
        full freshen hook); a lower level buys a cheap standby instead:
        high-confidence predictions justify HOT prewarm, long-tail
        functions only a PROCESS-rung sandbox.  When nothing is idle
        (below the target rung): with ``provision`` on, provision a
        brand-new instance *off the critical path* and warm it to the
        target — SPES-style proactive provisioning; otherwise (HOT only,
        by default) fall back to freshening a busy instance's runtime,
        the seed single-instance behavior — fr_state is thread-safe, so
        the in-flight invocation is unaffected and the next one on that
        instance hits.

        Warm-up is started while holding the pool lock, so ``reap`` (which
        skips instances with an in-flight freshen/partial warm) can never
        evict a target between selection and dispatch."""
        max_dispatch = (self.config.prewarm_fanout if max_dispatch is None
                        else max_dispatch)
        provision = (self.config.prewarm_provision if provision is None
                     else provision)
        level = WarmthLevel.HOT if level is None else WarmthLevel(level)
        self.reap()
        threads: List[threading.Thread] = []
        with self._cond:
            if level >= WarmthLevel.HOT:
                targets = list(reversed(self._idle))[:max_dispatch]
            else:
                # partial warm: only instances still below the target rung
                # benefit; never demote a warmer instance to "prewarm" it
                targets = [i for i in reversed(self._idle)
                           if i.runtime.warmth < level][:max_dispatch]
            if not targets and provision and \
                    len(self._instances) < self.config.max_instances:
                inst = self._create_locked()   # stays IDLE and acquirable
                self._c_provisioned.inc()
                self._cond.notify()
                targets = [inst]
            if not targets and level >= WarmthLevel.HOT \
                    and self.config.prewarm_busy_fallback:
                busy = [i for i in self._instances.values()
                        if i.state is InstanceState.BUSY]
                busy.sort(key=lambda i: i.last_used, reverse=True)
                targets = busy[:max_dispatch]
            self._c_prewarms.inc(len(targets))
            now = self.clock()
            for inst in targets:
                # predicted traffic counts as activity: keep-alive must not
                # evict an instance we just paid to warm before the
                # predicted arrival lands
                inst.last_used = now
                inst.level_since = now
                th = inst.runtime.warm_async(level)
                if th is not None:
                    threads.append(th)
        # a provisioned prewarm instance is idle capacity; real traffic
        # parked in the waiter queue outranks the prediction that bought it
        self._pump_async()
        return threads

    # -- introspection --------------------------------------------------
    def freshen_stats(self) -> dict:
        """Lifetime fr_state counters: every live instance plus the folded
        totals of instances already reaped."""
        with self._cond:
            agg = dict(self._reaped_freshen_stats)
            runtimes = [i.runtime for i in self._instances.values()]
        for rt in runtimes:
            stats = rt.freshen_stats()
            if stats:
                for k in agg:
                    agg[k] += stats.get(k, 0)
        return agg

    def _measured_init_locked(self) -> Tuple[float, int]:
        """(sum, count) of measured init seconds: reaped fold + live
        initialized instances.  Callers hold ``_cond``."""
        total, n = self._reaped_init
        for inst in self._instances.values():
            if inst.runtime.initialized:
                total += inst.runtime.init_seconds
                n += 1
        return total, n

    def measured_cold_start(self) -> float:
        """Mean *measured* init seconds over every instance this pool ever
        initialized (live + reaped).  Under the subprocess backend this is
        real interpreter-spawn + import + init_fn time; under the snapshot
        backend it is the fork-from-template *restore* time — in both
        cases the number retention policy should trade against
        (``HistoryPolicy.adapt`` and ``pool_config`` floor keep-alive at
        it).  Falls back to the configured ``cold_start_cost`` before
        anything has booted."""
        with self._cond:
            total, n = self._measured_init_locked()
        return total / n if n else self.config.cold_start_cost

    def _measured_levels_locked(self) -> Dict[str, float]:
        """Mean measured cost of each provisioning rung (lifetime: live +
        reaped fold).  ``process`` is the sandbox-boot share, ``init`` the
        init_fn/plan share — together the full cold start a partial-warm
        standby lets an arrival skip part of."""
        proc_s, proc_n = self._reaped_process
        step_s, step_n = self._reaped_init_step
        for inst in self._instances.values():
            if inst.runtime.warmth >= WarmthLevel.PROCESS:
                proc_s += inst.runtime.process_seconds
                proc_n += 1
            if inst.runtime.initialized:
                step_s += inst.runtime.init_step_seconds
                step_n += 1
        return {
            "measured_process_mean": proc_s / proc_n if proc_n else 0.0,
            "measured_init_step_mean": step_s / step_n if step_n else 0.0,
        }

    def stats(self) -> dict:
        with self._cond:
            total, n = self._measured_init_locked()
            levels = {lvl.label: 0 for lvl in WarmthLevel}
            for inst in self._instances.values():
                levels[inst.runtime.warmth.label] += 1
            out = {
                "instances": len(self._instances),
                "idle": len(self._idle),
                "waiting": self._waiting + len(self._async_waiters),
                "async_waiting": len(self._async_waiters),
                "cold_starts": self.cold_starts,
                "warm_acquires": self.warm_acquires,
                "queued_acquires": self.queued_acquires,
                "reaped": self.reaped,
                "dead_evictions": self.dead_evictions,
                "demotions": self.demotions,
                "partial_cold_starts": self.partial_cold_starts,
                "prewarm_dispatches": self.prewarm_dispatches,
                "prewarm_provisioned": self.prewarm_provisioned,
                "backend": self.config.backend,
                # live instances per warmth rung, busy or idle
                "levels": levels,
                # same fallback as measured_cold_start(): before anything
                # has booted, both report the configured cold_start_cost
                "measured_init_mean": (total / n if n
                                       else self.config.cold_start_cost),
            }
            out.update(self._measured_levels_locked())
            return out
