"""ClusterRouter — warmth-aware request routing and cross-shard freshen.

The router owns the cluster-level decisions the paper's single-node
freshen machinery cannot express:

* **Routing policies** (pluggable): which shard receives an arriving
  invocation.  ``least-loaded`` balances in-flight work, ``warmth-aware``
  prefers shards holding an idle *initialized* instance of the target
  function (a cold start avoided beats a marginally shorter queue), and
  ``sticky`` consistent-hashes the function name onto the shard ring so
  a function keeps hitting the same warm pool across arrivals — and only
  ~1/N of functions move when the shard count changes.
* **Cross-shard freshen propagation**: every worker's
  ``FreshenScheduler.freshen_route`` hook points back here, so when the
  predictor fires on shard A the router re-runs its *routing* decision
  for the predicted function and dispatches the prewarm on the shard an
  actual arrival would be sent to.  Prediction and placement agree: a
  prewarm that warms the wrong worker is a misprediction no matter how
  accurate the predictor was.
* **Queue rebalancing**: with ``spill_timeout`` set, an invocation that
  has queued on a saturated shard past the timeout is drained to the
  neighbor with the most idle capacity (cascading until some shard
  admits it); ``rebalance()`` additionally pushes warmth toward idle
  neighbors of hot shards so warmth-aware routing diverts *future*
  arrivals before they queue.
* **Elastic membership**: the shard set itself is mutable at runtime.
  ``add_worker`` spawns a new shard and replays every cluster-wide
  function registration onto it so routing can pick it immediately;
  ``remove_worker(shard, drain=True)`` walks the drain state machine —
  the shard stops accepting routes, its warm functions are
  prewarm-provisioned onto surviving shards (the rebalance neighbor
  choice), in-flight work completes, its ledger is folded into the
  cluster accountant's retained history, and only then is it shut down.
  Shard ids are never reused, so the sticky ring remap stays the
  consistent-hash minimum across any add/remove history.
"""
from __future__ import annotations

import bisect
import hashlib
import itertools
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.core.accounting import Accountant
from repro_torch.core.pool import PoolConfig, PoolSaturated
from repro_torch.core.prediction import HybridPredictor, Prediction
from repro_torch.core.runtime import FunctionSpec, Runtime
from repro_torch.telemetry import MetricsRegistry, NULL_TRACER, Tracer

from repro_torch.cluster.accounting import ClusterAccountant
from repro_torch.cluster.worker import ClusterWorker


class LeastLoadedPolicy:
    """Route to the shard with the least in-flight work (busy instances +
    queued acquires); ties are spread round-robin so an idle cluster does
    not funnel everything onto shard 0."""

    name = "least-loaded"

    def __init__(self):
        self._rr = itertools.count()

    def select(self, fn: str, workers: Sequence[ClusterWorker]) -> int:
        loads = [(w.load(), w.shard_id) for w in workers]
        lo = min(load for load, _ in loads)
        tied = [shard for load, shard in loads if load == lo]
        if len(tied) == 1:
            return tied[0]
        return tied[next(self._rr) % len(tied)]


class WarmthAwarePolicy:
    """Prefer shards holding an idle warm instance of the target function;
    among warm shards pick the warmest (then least loaded).  The signal is
    *level-weighted* (``ClusterWorker.warmth_weight``): a shard with a HOT
    instance outranks one with only an INITIALIZED instance, which
    outranks a PROCESS-rung standby — so under graded warmth an arrival
    lands on the cheapest-to-serve shard, and under binary warmth the
    ranking degenerates to the old idle-warm count.  With no warmth
    anywhere, fall back to ``fallback`` (least-loaded by default) — which
    is also where a cross-shard prewarm will have been sent, so the warmth
    this policy chases is the warmth the router itself placed."""

    name = "warmth-aware"

    def __init__(self, fallback=None):
        self.fallback = fallback or LeastLoadedPolicy()

    def select(self, fn: str, workers: Sequence[ClusterWorker]) -> int:
        # read each shard's warmth once: the score is a locked snapshot,
        # and re-reading could rank a shard on warmth it just lost
        warmth = [(w.warmth_weight(fn), w) for w in workers]
        warm = [(score, -w.load(), -w.shard_id, w.shard_id)
                for score, w in warmth if score > 0]
        if warm:
            return max(warm)[3]
        return self.fallback.select(fn, workers)


class StickyPolicy:
    """Consistent-hash affinity: hash the function name onto a virtual-node
    ring of shards.  Deterministic across router instances and processes
    (keyed hashing, not Python's salted ``hash``), and stable under shard
    count changes: growing N shards to N+1 remaps only the functions whose
    ring segment the new shard's virtual nodes capture (~1/(N+1)).

    Rings are memoized per shard-id tuple in a bounded LRU: an elastic
    cluster resharding repeatedly would otherwise leak one ring (of
    ``replicas`` × shards entries) per membership the fabric ever had."""

    name = "sticky"

    def __init__(self, replicas: int = 64, max_rings: int = 8):
        self.replicas = replicas
        self.max_rings = max(1, max_rings)
        self._rings: "OrderedDict[tuple, list]" = OrderedDict()
        self._ring_lock = threading.Lock()

    @staticmethod
    def _hash(key: str) -> int:
        digest = hashlib.blake2b(key.encode(), digest_size=8).digest()
        return int.from_bytes(digest, "big")

    def _ring(self, shard_ids: Sequence[int]) -> list:
        key = tuple(sorted(shard_ids))
        with self._ring_lock:
            ring = self._rings.get(key)
            if ring is not None:
                self._rings.move_to_end(key)
                return ring
        ring = sorted((self._hash(f"shard:{s}#vnode:{v}"), s)
                      for s in key for v in range(self.replicas))
        with self._ring_lock:
            self._rings[key] = ring
            self._rings.move_to_end(key)
            while len(self._rings) > self.max_rings:
                self._rings.popitem(last=False)
        return ring

    def select(self, fn: str, workers: Sequence[ClusterWorker]) -> int:
        ring = self._ring([w.shard_id for w in workers])
        idx = bisect.bisect_right(ring, (self._hash(fn), -1))
        return ring[idx % len(ring)][1]


POLICIES = {p.name: p for p in
            (LeastLoadedPolicy, WarmthAwarePolicy, StickyPolicy)}


def make_policy(policy: Union[str, object]):
    if isinstance(policy, str):
        try:
            return POLICIES[policy]()
        except KeyError:
            raise ValueError(f"unknown routing policy {policy!r}; "
                             f"one of {sorted(POLICIES)}") from None
    return policy


@dataclass
class _Registration:
    """What ``register`` was called with, so an added shard can replay it.
    ``elastic`` is False for explicit shard-subset registrations — those
    stay on their subset when the fleet grows."""
    spec: FunctionSpec
    config: Optional[PoolConfig]
    backend: Optional[str]
    elastic: bool


@dataclass
class DrainReport:
    """What ``remove_worker(shard, drain=True)`` did."""
    shard: int
    drained: bool
    handoffs: List[Tuple[str, int]] = field(default_factory=list)
    inflight_at_removal: int = 0


class ClusterRouter:
    """The sharded serving fabric's front door: route, propagate, drain,
    and — elastically — grow and shrink."""

    def __init__(self, workers: Sequence[ClusterWorker],
                 policy: Union[str, object] = "warmth-aware",
                 spill_timeout: Optional[float] = None,
                 cross_freshen: bool = True,
                 tracer: Optional[Tracer] = None,
                 clock: Callable[[], float] = time.monotonic):
        if not workers:
            raise ValueError("a cluster needs at least one worker")
        self.tracer = tracer or NULL_TRACER
        # drain deadlines pace real thread joins, so the default must be
        # the wall clock; injectable for tests
        self.clock = clock
        self._workers: List[ClusterWorker] = list(workers)
        self._by_shard = {w.shard_id: w for w in self._workers}
        if len(self._by_shard) != len(self._workers):
            raise ValueError("duplicate shard ids")
        self.policy = make_policy(policy)
        self.spill_timeout = spill_timeout
        self.cross_freshen = cross_freshen
        self.accountant = ClusterAccountant(
            [w.scheduler.accountant for w in self._workers])
        # how add_worker builds a shard's Accountant (benchmarks override
        # this to pre-configure service class / policy knobs on elastic
        # shards exactly as they did on the initial ones)
        self.accountant_factory = Accountant
        self._lock = threading.Lock()
        # control-plane lock: register / add_worker / remove_worker are
        # serialized against each other (a function registered while a
        # shard is joining must land on it exactly once — either via the
        # replay snapshot or via the registration's own target list).
        # The data plane (route/submit/stats) only ever takes _lock.
        self._admin = threading.RLock()
        self._closed = False
        # monotone shard-id allocator: departed ids are never reused, so
        # a re-added shard hashes to a fresh ring segment and per-shard
        # history stays unambiguous
        self._next_shard = max(self._by_shard) + 1
        self._registry: Dict[str, _Registration] = {}
        self._departed: List[int] = []
        # scalar router counters live in the registry (the legacy
        # attribute names below are read-only property views); the
        # per-shard dicts stay plain ints mutated and copied under
        # ``_lock``, which already makes their snapshots consistent
        self.metrics = MetricsRegistry("router.")
        self._c_added = self.metrics.counter("added")
        self._c_removed = self.metrics.counter("removed")
        self._c_cross = self.metrics.counter("cross_freshens")
        self._c_local = self.metrics.counter("local_freshens")
        self._c_spills = self.metrics.counter("spills")
        self.routed: Dict[int, int] = {w.shard_id: 0 for w in self._workers}
        self.saturations: Dict[int, int] = {w.shard_id: 0
                                            for w in self._workers}
        for w in self._workers:
            self._hook_freshen_route(w)
            # one tracer spans the fabric: a shard built without its own
            # inherits the router's, so cross-shard freshens and the
            # arrivals they anchor share one pending table
            if self.tracer.enabled and not w.scheduler.tracer.enabled:
                w.scheduler.tracer = self.tracer

    # -- legacy counter views (registry-backed) --------------------------
    @property
    def added(self) -> int:
        return self._c_added.value

    @property
    def removed(self) -> int:
        return self._c_removed.value

    @property
    def cross_freshens(self) -> int:
        return self._c_cross.value

    @property
    def local_freshens(self) -> int:
        return self._c_local.value

    @property
    def spills(self) -> int:
        return self._c_spills.value

    def _hook_freshen_route(self, w: ClusterWorker):
        w.scheduler.freshen_route = (
            lambda pred, _origin=w.shard_id:
                self._route_freshen(_origin, pred))

    # -- construction ---------------------------------------------------
    @classmethod
    def build(cls, num_shards: int,
              policy: Union[str, object] = "warmth-aware",
              pool_config: Optional[PoolConfig] = None,
              predictor: Optional[HybridPredictor] = None,
              devices: Optional[Sequence] = None,
              max_router_threads: int = 16,
              spill_timeout: Optional[float] = None,
              cross_freshen: bool = True,
              tracer: Optional[Tracer] = None,
              fast_path: bool = True) -> "ClusterRouter":
        """A local cluster: ``num_shards`` workers sharing one predictor
        (prediction is global knowledge) and one tracer (spans must link
        across shards) with per-shard accountants.  ``devices`` (optional
        jax device list) is partitioned round-robin so each worker pins
        its functions to a distinct slice.  ``fast_path=False`` restores
        the two-hop admission on every shard (the hot-path benchmark's
        legacy arm)."""
        predictor = predictor or HybridPredictor()
        slices = partition_devices(devices, num_shards)
        workers = [ClusterWorker(k, predictor=predictor,
                                 accountant=Accountant(),
                                 pool_config=pool_config,
                                 devices=slices[k],
                                 max_router_threads=max_router_threads,
                                 tracer=tracer,
                                 fast_path=fast_path)
                   for k in range(num_shards)]
        return cls(workers, policy=policy, spill_timeout=spill_timeout,
                   cross_freshen=cross_freshen, tracer=tracer)

    @property
    def workers(self) -> List[ClusterWorker]:
        """Snapshot of the live worker list (membership is mutable:
        iterate the snapshot, never the router's internal list)."""
        with self._lock:
            return list(self._workers)

    @property
    def num_shards(self) -> int:
        with self._lock:
            return len(self._workers)

    @property
    def predictor(self) -> HybridPredictor:
        with self._lock:
            return self._workers[0].scheduler.predictor

    def worker(self, shard: int) -> ClusterWorker:
        with self._lock:
            return self._by_shard[shard]

    def register(self, spec: FunctionSpec,
                 config: Optional[PoolConfig] = None,
                 shards: Optional[Sequence[int]] = None,
                 backend: Optional[str] = None
                 ) -> Dict[int, Runtime]:
        """Register a function on every shard (default) or a subset;
        returns the per-shard primary runtimes.  An explicit ``config``
        is copied per shard: pools own their config object (and
        ``reconfigure`` mutates it in place), so sharing one across
        shards would let adapting shard A silently retune shard B.
        ``backend`` selects the instance backend on every target shard.

        Cluster-wide registrations are remembered: a shard added later
        (``add_worker``) replays them so the new capacity can serve every
        elastic function the moment it joins the ring.  Explicit
        shard-subset registrations stay on their subset."""
        with self._admin:
            self._check_open()
            with self._lock:
                targets = (list(self._workers) if shards is None
                           else [self._by_shard[s] for s in shards])
                self._registry[spec.name] = _Registration(
                    spec, config, backend, elastic=shards is None)
            return {w.shard_id: w.register(
                        spec,
                        config=None if config is None else replace(config),
                        backend=backend)
                    for w in targets}

    # -- elastic membership ---------------------------------------------
    def add_worker(self, worker: Optional[ClusterWorker] = None,
                   devices: Optional[Sequence] = None,
                   pool_config: Optional[PoolConfig] = None,
                   max_router_threads: Optional[int] = None
                   ) -> ClusterWorker:
        """Grow the fleet by one shard at runtime.

        Builds a ``ClusterWorker`` on a fresh (never-reused) shard id —
        sharing the cluster predictor, with its own ``Accountant`` from
        ``accountant_factory`` — or adopts a caller-built ``worker``.
        Every cluster-wide function registration is replayed onto it
        *before* it joins the routing set, so the first arrival the
        policy sends its way finds a registered pool, and the sticky ring
        remaps only ~1/(N+1) of keys onto it."""
        with self._admin:
            self._check_open()
            with self._lock:
                template = self._workers[0].scheduler
                if worker is None:
                    shard_id = self._next_shard
                    self._next_shard += 1
                elif worker.shard_id in self._by_shard or \
                        worker.shard_id in self._departed:
                    raise ValueError(
                        f"shard id {worker.shard_id} already used by this "
                        f"cluster (ids are never reused)")
                else:
                    self._next_shard = max(self._next_shard,
                                           worker.shard_id + 1)
                registrations = [r for r in self._registry.values()
                                 if r.elastic]
            if worker is None:
                worker = ClusterWorker(
                    shard_id, predictor=template.predictor,
                    accountant=self.accountant_factory(),
                    pool_config=pool_config or template.pool_config,
                    devices=devices,
                    max_router_threads=(max_router_threads
                                        or template.max_router_threads),
                    tracer=self.tracer if self.tracer.enabled else None,
                    fast_path=template.fast_path)
            elif self.tracer.enabled and not worker.scheduler.tracer.enabled:
                # adopted workers join the fabric-wide tracer too
                worker.scheduler.tracer = self.tracer
            for reg in registrations:
                worker.register(
                    reg.spec,
                    config=None if reg.config is None
                    else replace(reg.config),
                    backend=reg.backend)
            self._hook_freshen_route(worker)
            self.accountant.attach(worker.scheduler.accountant)
            with self._lock:
                self._workers.append(worker)
                self._by_shard[worker.shard_id] = worker
                self.routed.setdefault(worker.shard_id, 0)
                self.saturations.setdefault(worker.shard_id, 0)
                self._c_added.inc()
            return worker

    def remove_worker(self, shard: int, drain: bool = True,
                      drain_timeout: float = 30.0) -> DrainReport:
        """Shrink the fleet by one shard without discarding its warmth.

        The drain state machine: (1) the shard leaves the routing set
        under the lock — no new route/submit can pick it; (2) its warm
        functions are prewarm-provisioned onto the surviving shard the
        rebalance neighbor-choice selects (most idle capacity, then least
        load), so the warmth the fleet paid for reappears where arrivals
        will now be routed; (3) in-flight and queued work on the shard
        completes (no future is ever dropped); (4) its ledger is folded
        into the cluster accountant's retained history; (5) the worker is
        shut down — subprocess workers terminated, pools closed.

        ``drain=False`` skips (2)–(3): the shard is cut loose immediately
        (its in-flight futures still complete — the worker owns them —
        but the router no longer waits for them; idle instances are
        still closed, so no backend worker processes leak)."""
        with self._admin:
            self._check_open()
            return self._remove_worker_locked(shard, drain, drain_timeout)

    def _remove_worker_locked(self, shard: int, drain: bool,
                              drain_timeout: float) -> DrainReport:
        with self._lock:
            if shard not in self._by_shard:
                raise KeyError(f"no live shard {shard} "
                               f"(live: {sorted(self._by_shard)})")
            if len(self._workers) == 1:
                raise ValueError("cannot remove the last shard: a cluster "
                                 "needs at least one worker")
            worker = self._by_shard.pop(shard)
            self._workers.remove(worker)
            self._departed.append(shard)
            self._c_removed.inc()
        worker.begin_drain()
        report = DrainReport(shard=shard, drained=drain,
                             inflight_at_removal=worker.load())
        if drain:
            # (2) warm-state handoff: every function holding an idle
            # initialized instance here is prewarm-provisioned on the
            # surviving neighbor the rebalance machinery would pick
            threads = []
            for fn in list(worker.scheduler.pools):
                if worker.warm_total(fn) <= 0:
                    continue
                target = self._handoff_target(fn, exclude=shard)
                if target is None:
                    continue
                threads.extend(target.prewarm(fn, provision=True))
                report.handoffs.append((fn, target.shard_id))
            # _admin is the slow control plane: a drain *waits* by design
            # (handoff threads, in-flight work) while the data-plane _lock
            # stays free — submits keep routing around the draining shard
            for th in threads:
                th.join(timeout=drain_timeout)   # fabriclint: allow[blocking]
            # (3) let in-flight and queued work finish: load counts busy
            # instances plus blocked acquires, so zero means every future
            # routed here has resolved
            deadline = self.clock() + drain_timeout
            while worker.load() > 0 and self.clock() < deadline:
                time.sleep(0.002)                # fabriclint: allow[blocking]
        # (4) fold the shard's ledger into retained cluster history
        self.accountant.retire(worker.scheduler.accountant)
        # (5) shut the worker down (with drain this also waits for any
        # router-thread stragglers before closing pools)
        worker.shutdown(wait=drain)              # fabriclint: allow[blocking]
        if not drain:
            # shutdown(wait=False) skips pool close; retire the pools so
            # idle instances close now and instances busy at removal
            # close when their invocation releases them — an undrained
            # removal must not leak subprocess backend workers either way
            for pool in list(worker.scheduler.pools.values()):
                pool.retire()
        return report

    def _handoff_target(self, fn: str,
                        exclude: int) -> Optional[ClusterWorker]:
        """The rebalance neighbor choice: the surviving shard with the
        most idle capacity for ``fn`` (then least loaded)."""
        survivors = [w for w in self._eligible(fn) if w.shard_id != exclude]
        if not survivors:
            return None
        return max(survivors, key=lambda n: (n.idle_capacity(fn), -n.load()))

    # -- routing --------------------------------------------------------
    def _check_open(self):
        if self._closed:
            raise RuntimeError("ClusterRouter is shut down: no further "
                               "routing or membership changes are possible")

    def _eligible(self, fn: str) -> List[ClusterWorker]:
        with self._lock:
            workers = list(self._workers)
        return [w for w in workers if w.has_function(fn)]

    def has_function(self, fn: str) -> bool:
        return bool(self._eligible(fn))

    def route(self, fn: str) -> int:
        """The placement decision: which shard an arrival of ``fn`` goes
        to right now.  Used identically for invocations, oracle prewarms,
        and predictor-driven cross-shard freshen."""
        self._check_open()
        eligible = self._eligible(fn)
        if not eligible:
            raise KeyError(f"function {fn!r} not registered on any shard")
        return self.policy.select(fn, eligible)

    def submit(self, fn: str, args=None, freshen_successors: bool = True
               ) -> Future:
        """Route one invocation; returns a Future.  With ``spill_timeout``
        set, saturation on the chosen shard drains the request to the
        neighbor with the most idle capacity instead of failing."""
        self._check_open()
        span = self.tracer.invocation(fn)
        with span.phase("route", policy=self.policy.name):
            shard = self.route(fn)
        span.annotate(shard=shard)
        if self.spill_timeout is None:
            with self._lock:
                worker = self._by_shard.get(shard)
                self.routed[shard] = self.routed.get(shard, 0) + 1
            if worker is None:       # removed between route() and here
                span.finish(error="ShardDeparted")
                return self.submit(fn, args, freshen_successors)
            try:
                return worker.submit(fn, args, freshen_successors,
                                     _span=span)
            except RuntimeError:     # began draining after the lookup
                span.finish(error="ShardDraining")
                return self.submit(fn, args, freshen_successors)
        outer: Future = Future()
        self._attempt(fn, args, freshen_successors, shard, set(), outer,
                      _span=span)
        return outer

    def _attempt(self, fn: str, args, freshen: bool, shard: int,
                 tried: set, outer: Future, _span=None):
        # each attempt owns one span: the saturated attempt's span was
        # finished (with the error) by the shard scheduler, so a spill
        # retry opens a fresh one marked ``spilled``
        span = _span if _span is not None else self.tracer.invocation(
            fn, spilled=True)
        span.annotate(shard=shard)
        tried.add(shard)
        with self._lock:
            worker = self._by_shard.get(shard)
            self.routed[shard] = self.routed.get(shard, 0) + 1
        rest = [w.shard_id for w in self._eligible(fn)
                if w.shard_id not in tried]
        if worker is None:
            # the chosen shard departed between selection and submission:
            # retry on a survivor (or fail loudly when none remains)
            span.finish(error="ShardDeparted")
            if rest:
                self._attempt(fn, args, freshen, rest[0], tried, outer)
            else:
                outer.set_exception(KeyError(
                    f"function {fn!r} not registered on any live shard"))
            return
        # the last untried shard gets no timeout: the request must land
        # somewhere, and by then every alternative has been offered
        timeout = self.spill_timeout if rest else None
        try:
            inner = worker.submit(fn, args, freshen, acquire_timeout=timeout,
                                  _span=span)
        except RuntimeError as e:    # began draining after the lookup
            span.finish(error="ShardDraining")
            if rest:
                self._attempt(fn, args, freshen, rest[0], tried, outer)
            else:
                outer.set_exception(e)
            return

        def _done(f: Future):
            # Future._invoke_callbacks swallows callback exceptions, so any
            # failure here must be routed to the outer future explicitly —
            # otherwise a caller blocked on outer.result() hangs forever
            try:
                exc = f.exception()
                if exc is None:
                    outer.set_result(f.result())
                    return
                if isinstance(exc, PoolSaturated) and rest:
                    with self._lock:
                        self._c_spills.inc()
                        self.saturations[shard] = \
                            self.saturations.get(shard, 0) + 1
                        # hold worker refs, not ids: a shard departing
                        # after this snapshot must not fail the retry
                        live = [(s, self._by_shard[s]) for s in rest
                                if s in self._by_shard]
                    if live:
                        nxt = max(live, key=lambda sw: (
                            sw[1].idle_capacity(fn), -sw[1].load()))[0]
                        # the saturated attempt already ran prediction +
                        # successor freshen for this arrival: a retry is the
                        # same logical invocation, so it must not observe or
                        # freshen again (double-counted inter-arrivals would
                        # corrupt the recurrence histograms)
                        self._attempt(fn, args, False, nxt, tried, outer)
                        return
                outer.set_exception(exc)
            except BaseException as e:                # noqa: BLE001
                if not outer.done():
                    outer.set_exception(e)

        inner.add_done_callback(_done)

    def submit_chain(self, fns: List[str], args=None,
                     freshen: bool = True) -> Future:
        """Chains route by their head function and run whole on one shard:
        chain members share a runtime scope, which never spans workers."""
        self._check_open()
        shard = self.route(fns[0])
        with self._lock:
            worker = self._by_shard.get(shard)
            self.routed[shard] = self.routed.get(shard, 0) + 1
        if worker is None:
            return self.submit_chain(fns, args, freshen)
        try:
            return worker.submit_chain(fns, args, freshen)
        except RuntimeError:         # began draining after the lookup
            return self.submit_chain(fns, args, freshen)

    def invoke(self, fn: str, args=None, freshen_successors: bool = True):
        return self.submit(fn, args, freshen_successors).result()

    # -- freshen propagation -------------------------------------------
    def _route_freshen(self, origin: int, pred: Prediction
                       ) -> Optional[bool]:
        """``FreshenScheduler.freshen_route`` hook for shard ``origin``:
        place the prewarm where the predicted invocation will be routed.
        Returns None to keep the freshen shard-local (the target *is*
        the origin, propagation is disabled, or the function is unknown
        to the cluster), letting the origin scheduler's normal dispatch
        path — accounting gate included — run unchanged; otherwise the
        target shard's dispatch outcome (its own gate may still drop the
        prewarm, which must not count as a cross-shard freshen)."""
        if not self.cross_freshen or self._closed:
            return None
        try:
            target = self.route(pred.fn)
        except KeyError:
            return None
        if target == origin:
            with self._lock:
                self._c_local.inc()
            return None
        with self._lock:
            worker = self._by_shard.get(target)
        if worker is None:
            return None
        dispatched = worker.scheduler._dispatch_freshen(pred, _routed=True)
        if dispatched:
            with self._lock:
                self._c_cross.inc()
        return dispatched

    def prewarm(self, fn: str, provision: bool = True):
        """Externally-driven prewarm (oracle trace replay): freshen the
        shard the router would send the arrival to."""
        shard = self.route(fn)
        with self._lock:
            worker = self._by_shard.get(shard)
        if worker is None:
            return self.prewarm(fn, provision=provision)
        return worker.prewarm(fn, provision=provision)

    # -- rebalancing ----------------------------------------------------
    def rebalance(self, min_queue_depth: int = 1) -> List[tuple]:
        """Push warmth from hot shards toward idle neighbors: for every
        function queueing ``min_queue_depth``+ acquires on some shard,
        prewarm-provision it on the eligible neighbor with the most idle
        capacity.  Warmth-aware routing then diverts future arrivals to
        the neighbor, draining the hot shard without touching in-flight
        work.  Returns ``(fn, hot_shard, target_shard)`` actions."""
        actions = []
        for w in self.workers:
            for fn, pool in list(w.scheduler.pools.items()):
                if pool.waiting_count() < min_queue_depth:
                    continue
                target = self._handoff_target(fn, exclude=w.shard_id)
                if target is None or target.idle_capacity(fn) <= 0:
                    continue
                target.prewarm(fn, provision=True)
                actions.append((fn, w.shard_id, target.shard_id))
        return actions

    # -- lifecycle ------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            workers = list(self._workers)
            counters = {"policy": self.policy.name,
                        "routed": dict(self.routed),
                        "cross_freshens": self.cross_freshens,
                        "local_freshens": self.local_freshens,
                        "spills": self.spills,
                        "saturations": dict(self.saturations),
                        "num_shards": len(workers),
                        "added": self.added,
                        "removed": self.removed,
                        "departed": list(self._departed)}
        counters["shards"] = {w.shard_id: w.stats() for w in workers}
        return counters

    def platform_stats(self) -> dict:
        """Per-shard pool stats keyed ``shard<k>/<fn>`` (flat, so existing
        tooling that iterates scheduler.platform_stats() keys still
        works against a cluster)."""
        out = {}
        for w in self.workers:
            for fn, stats in w.scheduler.platform_stats().items():
                out[f"shard{w.shard_id}/{fn}"] = stats
        return out

    def metrics_snapshot(self) -> dict:
        """Unified registry dump across the fabric: router instruments
        plus every shard scheduler's (and its pools'), prefixed
        ``shard<k>.``."""
        out = dict(self.metrics.snapshot())
        for w in self.workers:
            for key, val in w.scheduler.metrics_snapshot().items():
                out[f"shard{w.shard_id}.{key}"] = val
        return out

    def shutdown(self, wait: bool = True):
        """Shut every worker down and close the router: further ``submit``
        / ``route`` / membership calls raise instead of silently routing
        to dead shards.  Idempotent.  Serialized against membership
        changes (``_admin``), so a worker being added concurrently either
        lands before the snapshot and is shut down too, or its
        ``add_worker`` call observes the closed router and raises."""
        with self._admin:
            with self._lock:
                if self._closed:
                    return
                self._closed = True
                workers = list(self._workers)
            # control-plane blocking by design: shutdown holds _admin (not
            # _lock) so a racing add_worker sees the closed router
            for w in workers:
                w.shutdown(wait=wait)            # fabriclint: allow[blocking]


def partition_devices(devices: Optional[Sequence], num_shards: int
                      ) -> List[Optional[list]]:
    """Round-robin a device list into ``num_shards`` slices (``None``
    slices when there are no devices, or fewer devices than shards —
    pinning is best-effort, never a requirement)."""
    if not devices:
        return [None] * num_shards
    slices: List[list] = [[] for _ in range(num_shards)]
    for i, d in enumerate(devices):
        slices[i % num_shards].append(d)
    return [s or None for s in slices]
