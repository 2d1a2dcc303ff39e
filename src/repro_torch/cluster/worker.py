"""ClusterWorker — one shard of the serving fabric (the port of
``repro/cluster/worker.py``).

A worker wraps one ``FreshenScheduler`` (and therefore one set of
``InstancePool``s) and gives it a shard identity: pools raise
shard-tagged ``PoolSaturated`` errors, load/warmth signals are exposed
in the shape the routing policies consume, and the worker can be pinned
to a slice of the host's ``torch.device``s so each shard's function
bodies run on distinct hardware.

Only the device half differs from the reference: a pinned shard runs
its functions under ``torch.cuda.device`` of its first CUDA device
instead of ``jax.default_device``, and a shard pinned to the CPU makes
no call at all.  The per-shard mesh (``mesh()``) is ROADMAP.md module
item 7b.

Workers never talk to each other: all cross-shard behavior (routing,
freshen propagation, queue rebalancing) lives in
``repro_torch.cluster.router.ClusterRouter``.
"""
from __future__ import annotations

import dataclasses
import functools
from concurrent.futures import Future
from typing import Any, Callable, List, Optional, Sequence

import torch

from repro_torch.core.accounting import Accountant
from repro_torch.core.freshen import FreshenPlan
from repro_torch.core.pool import InstancePool, PoolConfig
from repro_torch.core.prediction import HybridPredictor
from repro_torch.core.runtime import FunctionSpec, Runtime
from repro_torch.core.scheduler import FreshenScheduler
from repro_torch.telemetry import Tracer

MESH_ITEM = "ROADMAP.md module item 7b (partitioning, mesh, steps)"


class ClusterWorker:
    """One shard: a FreshenScheduler plus shard identity and device slice.

    ``predictor`` is usually the cluster-shared ``HybridPredictor`` —
    prediction is global knowledge (chains and periodicity do not care
    which shard an invocation landed on), so every shard's observations
    feed one model while accounting stays per-shard (each worker gets its
    own ``Accountant``, so the cluster can tell *where* latency and cold
    starts happen).
    """

    def __init__(self, shard_id: int,
                 predictor: Optional[HybridPredictor] = None,
                 accountant: Optional[Accountant] = None,
                 pool_config: Optional[PoolConfig] = None,
                 devices: Optional[Sequence] = None,
                 max_router_threads: int = 16,
                 tracer: Optional[Tracer] = None,
                 fast_path: bool = True):
        self.shard_id = shard_id
        self.devices = list(devices) if devices else None
        # set by ClusterRouter.remove_worker: a draining shard finishes
        # its in-flight work but admits nothing new
        self.draining = False
        # like the predictor, the tracer is cluster-shared: a freshen
        # dispatched on this shard and the arrival it anchored (possibly
        # routed elsewhere) must meet in one pending table.  fast_path
        # threads the single-submission admission toggle through to the
        # shard scheduler: a routed warm hit try_acquires inline on the
        # router's calling thread and pays no admission hop.
        self.scheduler = FreshenScheduler(
            predictor=predictor, accountant=accountant,
            pool_config=pool_config, max_router_threads=max_router_threads,
            tracer=tracer, fast_path=fast_path)

    # -- registration ---------------------------------------------------
    def _pinned(self, spec: FunctionSpec) -> FunctionSpec:
        """The spec with every hook that runs the function's own code —
        ``init_fn``, the plan factory, each plan entry's thunk and the
        body — wrapped in ``torch.cuda.device`` of this shard's first
        device, so an instance's weights, warm-up and invocations land on
        that card whichever pool, router or freshen thread runs them.  A
        shard pinned to the CPU runs the spec as it is."""
        device = torch.device(self.devices[0])
        if device.type != "cuda":
            return spec

        def pin(fn: Optional[Callable]) -> Optional[Callable]:
            if fn is None:
                return None

            @functools.wraps(fn)
            def run_pinned(*args, **kwargs):
                with torch.cuda.device(device):
                    return fn(*args, **kwargs)
            return run_pinned

        def plan_factory(runtime):
            plan = spec.plan_factory(runtime)
            return FreshenPlan([dataclasses.replace(e, thunk=pin(e.thunk))
                                for e in plan])

        return dataclasses.replace(
            spec, code=pin(spec.code), init_fn=pin(spec.init_fn),
            plan_factory=(pin(plan_factory) if spec.plan_factory is not None
                          else None))

    def register(self, spec: FunctionSpec,
                 config: Optional[PoolConfig] = None,
                 backend: Optional[str] = None) -> Runtime:
        """Register a function on this shard; its pool is shard-tagged so
        saturation errors name the shard.  ``backend`` selects the
        instance backend (repro_torch.core.backend: thread, subprocess,
        or snapshot — a snapshot pool's fork template lives and dies with
        this shard's pools); device pinning wraps the function's hooks in
        closures and therefore requires the in-process thread backend."""
        if self.devices:
            chosen = backend or (config.backend if config
                                 else self.scheduler.pool_config.backend)
            if chosen != "thread":
                raise ValueError(
                    f"shard {self.shard_id} pins torch devices, which "
                    f"requires the thread backend (got {chosen!r})")
            spec = self._pinned(spec)
        rt = self.scheduler.register(spec, config=config, backend=backend)
        self.scheduler.pools[spec.name].shard = self.shard_id
        return rt

    def mesh(self, axis_name: str = "model"):
        """A 1-axis device mesh over this worker's device slice, for
        tensor-parallel weights *within* the shard: not ported yet."""
        raise NotImplementedError(
            f"ClusterWorker.mesh() is not ported yet: {MESH_ITEM}")

    # -- invocation (delegated) -----------------------------------------
    def has_function(self, fn: str) -> bool:
        return fn in self.scheduler.pools

    def begin_drain(self):
        """Stop admitting new invocations; in-flight work completes.
        Called by ``ClusterRouter.remove_worker`` after the shard left
        the routing set — a direct ``submit`` afterwards is a caller
        holding a stale shard reference, and must fail loudly rather
        than queue work on a shard about to shut down."""
        self.draining = True

    def _check_admitting(self):
        if self.draining:
            raise RuntimeError(
                f"shard {self.shard_id} is draining (removed from its "
                f"cluster): it accepts no new invocations")

    def submit(self, fn: str, args: Any = None,
               freshen_successors: bool = True,
               acquire_timeout: Optional[float] = None,
               _span=None) -> Future:
        self._check_admitting()
        return self.scheduler.submit(fn, args, freshen_successors,
                                     acquire_timeout, _span=_span)

    def submit_chain(self, fns: List[str], args: Any = None,
                     freshen: bool = True) -> Future:
        self._check_admitting()
        return self.scheduler.submit_chain(fns, args, freshen)

    def invoke(self, fn: str, args: Any = None,
               freshen_successors: bool = True):
        self._check_admitting()
        return self.scheduler.invoke(fn, args,
                                     freshen_successors=freshen_successors)

    def prewarm(self, fn: str, provision: bool = True, level=None):
        return self.scheduler.prewarm(fn, provision=provision, level=level)

    def try_acquire(self, fn: str):
        """Non-blocking fast-path probe on this shard's pool: returns
        ``(instance, cold)`` or None.  ``submit`` already runs this
        inline via the shard scheduler's fast path; the explicit
        delegate exists for callers (batchers, probes) that need the
        grab without the dispatch."""
        self._check_admitting()
        pool = self.scheduler.pools.get(fn)
        return pool.try_acquire() if pool is not None else None

    # -- routing signals ------------------------------------------------
    def pool(self, fn: str) -> Optional[InstancePool]:
        return self.scheduler.pools.get(fn)

    def warm_idle(self, fn: str) -> int:
        """Idle initialized instances of ``fn`` on this shard — the
        warmth-aware policy's primary signal."""
        pool = self.scheduler.pools.get(fn)
        return pool.warm_idle_count() if pool is not None else 0

    def warm_total(self, fn: str) -> int:
        """Initialized instances of ``fn``, idle or busy — the drain
        handoff's signal (warmth an in-flight invocation is borrowing
        still needs a new home)."""
        pool = self.scheduler.pools.get(fn)
        return pool.warm_total_count() if pool is not None else 0

    def warmth_weight(self, fn: str) -> float:
        """Level-weighted idle warmth of ``fn`` here (HOT instance = 1.0,
        PROCESS standby = 1/3): the graded routing signal — a shard
        holding a HOT instance outranks one holding only a standby, which
        still outranks a cold shard."""
        pool = self.scheduler.pools.get(fn)
        return pool.warmth_score() if pool is not None else 0.0

    def queue_depth(self, fn: Optional[str] = None) -> int:
        """Blocked acquires, for one function or the whole shard."""
        pools = self.scheduler.pools
        if fn is not None:
            pool = pools.get(fn)
            return pool.waiting_count() if pool is not None else 0
        return sum(p.waiting_count() for p in pools.values())

    def load(self, fn: Optional[str] = None) -> int:
        """Busy instances + blocked acquires — the least-loaded policy's
        signal.  Whole-shard by default: one worker's instances share the
        shard's hardware, so load on any pool slows every pool.  Each
        pool's contribution is read under one lock (``InstancePool.load``)
        — summing busy and waiting from separate lock acquisitions tears
        across a concurrent release and double-counts."""
        pools = self.scheduler.pools
        if fn is not None:
            pool = pools.get(fn)
            return pool.load() if pool is not None else 0
        return sum(p.load() for p in pools.values())

    def idle_capacity(self, fn: str) -> int:
        """Instances ``fn`` could run on here without queueing: idle ones
        plus the headroom below the pool cap.  Rebalancing drains a hot
        shard's queue toward the neighbor maximizing this.  One lock
        acquisition (``InstancePool.idle_capacity``): the former
        stats()-then-config read could tear across a reconfigure."""
        pool = self.scheduler.pools.get(fn)
        return pool.idle_capacity() if pool is not None else 0

    # -- lifecycle ------------------------------------------------------
    def stats(self) -> dict:
        out = {"shard": self.shard_id, "load": self.load(),
               "queue_depth": self.queue_depth()}
        out["pools"] = self.scheduler.platform_stats()
        return out

    def shutdown(self, wait: bool = True):
        self.scheduler.shutdown(wait=wait)
