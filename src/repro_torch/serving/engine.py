"""The port's serving engine: model endpoints as serverless functions
with first-class freshen integration (``repro/serving/engine.py``).

A ``ModelEndpoint`` is the paper's λ (Algorithm 1):

    procedure λ(tokens):
        params   := FrFetch(0, WeightStore.load(NAME))        # DataGet
        compiled := FrFetch(1, Executor.compile(score_fn))    # kernel build
        FrWarm(2, Executor.warmup(compiled, params))          # capture
        [data   := FrFetch(3, Datastore.get(CONST_KEY))]      # prefetch
        return compiled.bind(params)(tokens)                  # replay

Weights and the "executable" are separate plan entries, so a new weight
version swaps in without rebuilding anything.  On the card the warm-up
entry runs the score step once and captures it as a CUDA graph bound to
the instance's params (``serving/executor.py``); it follows the weights'
version, so a freshen after a publish captures again and the invoke
replays.  A generation endpoint's session entries capture its prefill
and decode steps against the preallocated decode cache the same way.  An endpoint keeps the
device it was asked for (``device="cuda"`` by default) and resolves it
only when an instance builds its plan, in the instance's own thread:
a shard pinned to a card runs the plan under that card's
``torch.cuda.device``, and an endpoint built in a snapshot template
leaves CUDA untouched there, so every instance forked from it starts
its own CUDA context.  ``ServingEngine`` serves from one scheduler or,
with ``deploy(shards=N>1 | elastic=True)``, across the sharded fabric
(``repro_torch.cluster``); ``deploy(backend="subprocess"|"snapshot")``
runs instances out of process, rebuilt in each worker from the
endpoint's ``spec_ref``.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.freshen import (Action, FreshenPlan, FrState,
                                      PlanEntry)
from repro_torch.core.runtime import FunctionSpec, RunContext, Runtime
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import Model, make_model
from repro_torch.serving.batching import EndpointBatcher, pad_batch
from repro_torch.serving.executor import Executor
from repro_torch.serving.weights import WeightStore
from repro_torch.specs import TensorSpec
from repro_torch.telemetry import NULL_SPAN, current_span
from repro_torch.telemetry import recorder


@dataclass
class WarmBudget:
    """Provider-side policy half of warm_cwnd: allow warming only after
    ``min_repetitions`` observed invocations of the same shape (repetitive
    invocations anticipate workload characteristics, §3.2)."""
    min_repetitions: int = 2
    observed: Dict[Any, int] = field(default_factory=dict)

    def observe(self, key):
        self.observed[key] = self.observed.get(key, 0) + 1

    def allows(self, key) -> bool:
        return self.observed.get(key, 0) >= self.min_repetitions


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host copy as float32 (numpy has no bfloat16); waits for the device."""
    return t.detach().float().cpu().numpy()


def _entry_index(runtime: Runtime, name: str) -> int:
    return [e.name for e in runtime.fr_state.plan.entries].index(name)


class _ScoreStep:
    """The warm-up entry's value: the score step bound to the instance's
    params.  The warm-up binds it ahead of the invoke; where the warm
    budget held the warm-up back, the first invoke binds it and leaves it
    here.  Either way the entry keeps it until a new weight version redoes
    the entry."""
    __slots__ = ("step",)

    def __init__(self, step=None):
        self.step = step


def _fetched(runtime: Runtime, idx: int):
    """Plan entry ``idx``'s value for a later entry that builds on it: the
    value freshen or the body already fetched (not counted as a hit), or
    fetched now (waiting for one in flight) as the body would."""
    e = runtime.fr_state.entries[idx]
    with e.cond:
        if e.state is FrState.FINISHED:
            return e.result
    return runtime.fr_state.fr_fetch(idx)


class ModelEndpoint:
    """One servable model = one serverless function."""

    def __init__(self, name: str, cfg: ModelConfig, store: WeightStore,
                 executor: Optional[Executor] = None, *,
                 batch_size: int = 4, seq_len: int = 64, app: str = "serving",
                 datastore=None, prefetch_key: Optional[str] = None,
                 prefetch_ttl: Optional[float] = None,
                 warm_budget: Optional[WarmBudget] = None,
                 device: DeviceLike = "cuda",
                 spec_ref: Optional[str] = None,
                 tracer=None):
        self.name = name
        self.cfg = cfg
        # the device as asked for: resolving it touches CUDA, so it is
        # resolved when an instance builds its plan (``device``), never
        # here, where a snapshot template may be building the endpoint
        self.requested_device = device
        # the model on the CPU touches no CUDA: it gives the parameter
        # and cache specs, and checks the block kinds at construction.
        # One Model per resolved device: instances on different shards
        # share this endpoint object
        shapes = make_model(cfg, device="cpu")
        self._shapes = shapes
        self._models: Dict[torch.device, Model] = {shapes.device: shapes}
        self._models_lock = threading.Lock()
        self.store = store
        self.executor = executor or Executor()
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.app = app
        self.datastore = datastore
        self.prefetch_key = prefetch_key
        self.prefetch_ttl = prefetch_ttl
        self.warm_budget = warm_budget or WarmBudget(min_repetitions=0)
        # "module:attr" the subprocess and snapshot backends' workers
        # import to rebuild this endpoint's FunctionSpec (endpoint state
        # does not pickle); None keeps the endpoint thread-backend-only
        self.spec_ref = spec_ref
        # None: the tracer of the engine that deploys it, else the
        # process tracer (telemetry/recorder.py)
        self._tracer = tracer

    @property
    def tracer(self):
        """Where the endpoint's work spans and decode records go."""
        return (self._tracer if self._tracer is not None
                else recorder.process_tracer())

    @property
    def device(self) -> torch.device:
        """The device an instance runs on: the requested one, resolved in
        the calling thread, under the ``torch.cuda.device`` a pinned shard
        set.  Raises on a host without CUDA unless ``device="cpu"`` was
        asked."""
        return resolve_device(self.requested_device)

    def model_for(self, device: torch.device) -> Model:
        with self._models_lock:
            model = self._models.get(device)
            if model is None:
                model = self._models[device] = make_model(self.cfg,
                                                          device=device)
            return model

    # ------------------------------------------------------------------
    def _score_fn(self, device: torch.device):
        model = self.model_for(device)

        def score(params, tokens):
            x, _ = model.forward(params, tokens)
            return model._logits(params, x[:, -1:])
        return score

    def _params_spec(self):
        return self._shapes.param_specs()

    def _tokens_spec(self, seq: int) -> TensorSpec:
        return TensorSpec((self.batch_size, seq), torch.int32)

    def _specs(self):
        return (self._params_spec(), self._tokens_spec(self.seq_len))

    def _tokens(self, tokens) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(tokens, np.int32), device=self.device)
        if tuple(t.shape) != (self.batch_size, self.seq_len):
            raise ValueError(f"{self.name}: tokens {tuple(t.shape)} != the "
                             f"endpoint's ({self.batch_size}, {self.seq_len})")
        return t

    # ------------------------------------------------------------------
    # The freshen plan: ordered resources, §3.3 fr_state indices 0..3
    def build_plan(self, runtime: Runtime) -> FreshenPlan:
        # the endpoint's first CUDA call: the instance resolves its device
        # and builds the model for it when it initializes (deploy's eager
        # init surfaces a host without CUDA), never in a snapshot
        # template.  The entries resolve it again where they run, which a
        # pinned shard wraps in its torch.cuda.device.
        self.model_for(self.device)
        version = self._weights_version
        traced = self._traced
        entries = [
            PlanEntry("weights", Action.FETCH,
                      traced("weights.load", runtime, self._load_weights),
                      version_fn=version),
            PlanEntry("compiled", Action.FETCH,
                      traced("compile", runtime, self._compile)),
            PlanEntry("warmup", Action.WARM,
                      traced("warmup", runtime,
                             lambda: self._warmup(runtime)),
                      version_fn=version),
        ]
        if self.datastore is not None and self.prefetch_key is not None:
            entries.append(PlanEntry(
                "prefetch", Action.FETCH,
                lambda: self.datastore.get(self.prefetch_key)[0],
                ttl=self.prefetch_ttl,
                version_fn=lambda: self.datastore.version(self.prefetch_key)))
        return FreshenPlan(entries)

    def _traced(self, name: str, runtime: Runtime, thunk):
        """``thunk`` recording one work span ``name`` wherever it runs: on
        the invoke's thread (inline) or on a freshen thread."""
        def run():
            rec = recorder.recorder_of(self.tracer)
            if rec is None:
                return thunk()
            with rec.work(name, fn=self.name,
                          instance=rec.instance_key(runtime)):
                return thunk()
        return run

    def _weights_version(self):
        return self.store.version(self.name)

    def _load_weights(self):
        params, real, modeled = self.store.load(self.name, device=self.device)
        return params

    def _compile(self):
        dev = self.device
        compiled, dt = self.executor.compile(
            f"{self.name}/score", self._score_fn(dev), self._specs(),
            device=dev, n_bound=1)
        return compiled

    def _warmup(self, runtime: Runtime) -> _ScoreStep:
        """Bind the score step to the instance's params (on the card: run
        it once and capture it), unless the warm budget holds it back; the
        entry keeps the bound step, so its graph lives until the entry is
        redone for a new version."""
        key = (self.name, self.batch_size, self.seq_len)
        if not self.warm_budget.allows(key):
            return _ScoreStep()
        compiled = self.executor.get(f"{self.name}/score", self._specs(),
                                     device=self.device)
        if compiled is None:
            compiled = self._compile()
        return _ScoreStep(self.executor.warmup(compiled,
                                               _fetched(runtime, 0)))

    # ------------------------------------------------------------------
    # Decode sessions: the KV cache is a freshen-preallocatable resource
    # (the paper's buffer/CWND-warming analogue for serving state).
    def _decode_fns(self, max_len: int):
        """The session's steps, bound arguments (params, cache) first."""
        model = self.model_for(self.device)

        def prefill(params, cache, tokens):
            return model.prefill(params, tokens, max_len=max_len, cache=cache)

        def decode(params, cache, token, pos):
            return model.decode_step(params, cache, token, pos)
        return prefill, decode

    def _compile_decode(self, max_len: int):
        dev = self.device
        params_spec = self._params_spec()
        cache_spec = self._shapes.cache_specs(self.batch_size, max_len)
        prefill, decode = self._decode_fns(max_len)
        c_pre, _ = self.executor.compile(
            f"{self.name}/prefill{max_len}", prefill,
            (params_spec, cache_spec, self._tokens_spec(self.seq_len)),
            device=dev, n_bound=2)
        c_dec, _ = self.executor.compile(
            f"{self.name}/decode{max_len}", decode,
            (params_spec, cache_spec, self._tokens_spec(1),
             TensorSpec((self.batch_size,), torch.int32)),
            device=dev, n_bound=2)
        return c_pre, c_dec

    def _prealloc_session(self, max_len: int):
        """Allocate (for real) the decode cache buffers ahead of time."""
        dev = self.device
        cache = self.model_for(dev).init_cache(self.batch_size, max_len)
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
        return cache

    def _capture_session(self, runtime: Runtime, offset: int):
        """Bind prefill and decode to the instance's params and its
        session cache (on the card: capture both).  The capture's warm
        runs write into the cache; every session's prefill seeds all a
        decode step reads again."""
        c_pre, c_dec = _fetched(runtime, offset)
        bound = (_fetched(runtime, 0), _fetched(runtime, offset + 1))
        return (self.executor.warmup(c_pre, *bound),
                self.executor.warmup(c_dec, *bound))

    def session_plan_entries(self, max_len: int, runtime: Runtime):
        """Extra freshen resources for generation endpoints, to end the
        plan of the instance ``runtime``: the session steps, the
        preallocated cache, and the steps captured against both."""
        traced = self._traced
        return [
            PlanEntry("decode_executables", Action.FETCH,
                      traced("decode_executables", runtime,
                             lambda: self._compile_decode(max_len))),
            PlanEntry("session_cache", Action.FETCH,
                      traced("session_cache", runtime,
                             lambda: self._prealloc_session(max_len))),
            PlanEntry("session_graphs", Action.WARM,
                      traced("session_graphs", runtime,
                             lambda: self._capture_session(
                                 runtime, _entry_index(
                                     runtime, "decode_executables"))),
                      version_fn=self._weights_version),
        ]

    def generate(self, ctx: RunContext, tokens, n_steps: int, max_len: int,
                 plan_offset: int):
        """Greedy autoregressive generation using the freshened
        executables and cache; returns row 0's tokens.  ``plan_offset`` =
        fr_state index of 'decode_executables' (``session_plan_entries``).
        Each decode step is recorded (``telemetry/recorder.py``), and for
        a model with experts each replay's expert rows too."""
        ctx.fr_fetch(0)
        ctx.fr_fetch(plan_offset)
        # the preallocated session cache: prefill seeds it in place and
        # every decode step writes its token's K/V into it in place
        ctx.fr_fetch(plan_offset + 1)
        # the steps bound to the params and that cache
        ctx.fr_warm(plan_offset + 2)
        prefill, decode = _fetched(ctx.runtime, plan_offset + 2)
        rec = recorder.recorder_of(self.tracer)
        if rec is not None:
            instance = rec.instance_key(ctx.runtime)
            (current_span() or NULL_SPAN).annotate(instance=instance)
        # a step's expert rows are fixed at its capture: recorded per replay
        rows = rec is not None and decode.moe_rows[1] > 0
        toks = self._tokens(tokens)
        t_pre = rec.clock() if rows else 0.0
        logits, _ = prefill(toks)
        B, S = toks.shape
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        timer = None
        if rec is not None:
            # made once the prefill is enqueued: it marks the prefill's end
            timer = rec.decode_timer(self.name, instance, self.device,
                                     decode.started)
        if rows:
            rec.step_rows("prefill", timer.gen, self.name, instance, t_pre,
                          prefill.moe_rows)
        out = [int(tok[0, 0])]
        pos = torch.full((B,), S, dtype=torch.int32, device=self.device)
        for i in range(n_steps - 1):
            if timer is not None:
                timer.begin()
            t_dec = rec.clock() if rows else 0.0
            # copied into the decode graph's static token and pos
            logits, _ = decode(tok, pos)
            tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
            pos = pos + 1
            if rows:                 # while the device runs the step
                rec.step_rows("decode", timer.gen, self.name, instance,
                              t_dec, decode.moe_rows)
            if timer is not None:
                timer.stepped()
            out.append(int(tok[0, 0]))
            if timer is not None:
                timer.end(S + i)
        if timer is not None:
            timer.close()
        return out

    def code(self, ctx: RunContext, args):
        """The run-hook body (Algorithm 3: annotated λ).  Its segments
        are the result's ``timing`` and phases of the invocation span on
        this thread (``plan.*`` and ``execute``), on that span's clock."""
        span = current_span() or NULL_SPAN
        # the span's tracer clock: the host monotonic clock unless a test
        # injected one
        clock = span.tracer.clock if span else time.monotonic
        rec = recorder.recorder_of(self.tracer)
        if rec is not None:
            span.annotate(instance=rec.instance_key(ctx.runtime))
        t0 = clock()
        tokens = self._tokens(args["tokens"])
        params = ctx.fr_fetch(0)                  # FrFetch(0, DataGet(...))
        span.phase_from("plan.weights", t0)
        t_w = clock()
        compiled = ctx.fr_fetch(1)                # FrFetch(1, compile)
        span.phase_from("plan.compile", t_w)
        t_c = clock()
        ctx.fr_warm(2)                            # FrWarm(2, warmup)
        held = _fetched(ctx.runtime, 2)
        span.phase_from("plan.warmup", t_c)
        t_u = clock()
        # the step the warm-up bound to these params; bound here only if
        # the warm budget held the warm-up back (timed on its own, never
        # as execute), and then kept by the entry for the next invoke
        step, captured = compiled.bind(params)
        if isinstance(held, _ScoreStep):     # an inferred plan may hold none
            held.step = step
        if captured:
            span.phase_from("plan.capture", t_u)
        t_x = clock() if captured else t_u
        extra = ctx.fr_fetch(3) if len(ctx.runtime.fr_state.plan) > 3 else None
        logits = _to_numpy(step(tokens))          # waits for the device
        span.phase_from("execute", t_x)
        t1 = clock()
        self.warm_budget.observe((self.name, self.batch_size, self.seq_len))
        timing = {"total": t1 - t0, "weights": t_w - t0,
                  "compile": t_c - t_w, "warmup": t_u - t_c,
                  "execute": t1 - t_x}
        if captured:
            timing["capture"] = t_x - t_u
        return {"logits": logits, "timing": timing, "extra": extra}

    def spec(self) -> FunctionSpec:
        return FunctionSpec(self.name, self.code,
                            plan_factory=self.build_plan, app=self.app,
                            ref=self.spec_ref)


class ServingEngine:
    """Model endpoints behind a FreshenScheduler — the 'serverless
    platform' of the evaluation.

    Each deployed endpoint is backed by an ``InstancePool``: concurrent
    requests admitted via ``submit`` fan out across warm instances, scale
    the pool up under queue pressure, and are prewarmed by
    predicted-successor freshen dispatch; given no scheduler, the engine
    builds a ``LeadScheduler`` (``serving/lead.py``), which holds the warm
    instance until a predicted arrival that outlasts keep-alive.  ``deploy``
    eagerly initializes the primary instance (the seed-era warm
    container); additional instances cold-start on demand."""

    def __init__(self, scheduler=None, router_policy: str = "warmth-aware",
                 spill_timeout: Optional[float] = None,
                 tracer=None):
        from repro_torch.serving.lead import LeadScheduler
        # one tracer for the whole engine: the base scheduler and (if a
        # fabric is built) every shard share it, so exported traces show
        # the full request path regardless of placement
        if scheduler is None and tracer is None:
            tracer = recorder.process_tracer()
        self.scheduler = scheduler or LeadScheduler(tracer=tracer)
        if tracer is not None and not self.scheduler.tracer.enabled:
            self.scheduler.tracer = tracer
        self.tracer = self.scheduler.tracer
        self.endpoints: Dict[str, ModelEndpoint] = {}
        # pool-aware request batchers, one per endpoint deployed with
        # ``batch_size=``: single requests admitted via submit_request are
        # formed into batches and run as ONE pooled invocation each
        self.batchers: Dict[str, EndpointBatcher] = {}
        # the sharded fabric (repro_torch.cluster), created lazily by the
        # first deploy(..., shards=N>1); single-scheduler deploys are
        # untouched
        self.cluster = None
        self.router_policy = router_policy
        self.spill_timeout = spill_timeout
        self._clustered: set = set()          # endpoint names on the fabric

    def _default_pool_config(self):
        # model endpoints hold weight loads and kernel builds: a generic
        # 30s keep-alive would reap them between pipeline stages, so
        # serving defaults to a long retention on top of the
        # scheduler-wide pool policy
        return dataclasses.replace(self.scheduler.pool_config,
                                   keep_alive=600.0)

    def _ensure_cluster(self, shards: int, elastic: bool = False):
        if self.cluster is None:
            from repro_torch.cluster import ClusterRouter
            # the fabric shares the engine scheduler's predictor:
            # prediction (chains, periodicity) is global knowledge, so
            # chain() and trace priming keep working unchanged
            self.cluster = ClusterRouter.build(
                shards, policy=self.router_policy,
                pool_config=self.scheduler.pool_config,
                predictor=self.scheduler.predictor,
                spill_timeout=self.spill_timeout,
                tracer=self.tracer if self.tracer.enabled else None)
        elif shards > self.cluster.num_shards:
            if not elastic:
                raise ValueError(
                    f"cluster already built with {self.cluster.num_shards} "
                    f"shards; deploy the widest endpoint first (asked for "
                    f"{shards}) or pass elastic=True to grow the fleet")
            while self.cluster.num_shards < shards:
                self.cluster.add_worker()
        return self.cluster

    def scale_shards(self, n: int, drain: bool = True) -> int:
        """Resize the sharded fabric to ``n`` shards at runtime.

        Growing replays every *elastic* endpoint's registration onto the
        new shards (``ClusterRouter.add_worker``); fixed-width deploys
        (``elastic=False``) keep their width.  Shrinking drains the
        newest shards first — warm endpoints are prewarm-provisioned onto
        survivors and in-flight requests complete before each shard shuts
        down.  Builds the fabric on first use so ``scale_shards`` can
        precede the first sharded ``deploy``.  Returns the live shard
        count."""
        if n < 1:
            raise ValueError(f"a fabric needs at least one shard (got {n})")
        if self.cluster is None:
            if n == 1:
                return 1              # the base scheduler is the one shard
            self._ensure_cluster(n)
            return self.cluster.num_shards
        while self.cluster.num_shards < n:
            self.cluster.add_worker()
        while self.cluster.num_shards > n:
            victim = max(w.shard_id for w in self.cluster.workers)
            self.cluster.remove_worker(victim, drain=drain)
        return self.cluster.num_shards

    def deploy(self, ep: ModelEndpoint, pool_config=None,
               shards: Optional[int] = None,
               backend: Optional[str] = None,
               elastic: bool = False,
               graded_warmth: Optional[bool] = None,
               batch_size: Optional[int] = None,
               batch_max_wait: float = 0.01) -> Runtime:
        """Register an endpoint; with ``shards=N`` (N>1) it joins the
        sharded fabric: one ``InstancePool`` per shard behind the
        ``ClusterRouter`` (lazily built at the first sharded deploy),
        warmth-aware routing and cross-shard freshen included.  Only the
        shard-0 primary is eagerly initialized — the other shards warm up
        on demand or by prewarm, which is the point of the fabric.

        ``backend`` selects the instance backend
        (repro_torch.core.backend): ``"subprocess"`` runs each instance
        in its own worker process, so a cold start is measured
        interpreter, ``import torch``, CUDA context, weights and kernel
        library; ``"snapshot"`` forks instances from a pre-warmed
        per-pool template process (interpreter and imports done, CUDA
        untouched), so a cold start is fork plus the rest.  A
        ``ModelEndpoint``'s spec closes over live endpoint state, so
        out-of-process deploys need ``spec_ref`` (``"module:attr"``, a
        factory the worker imports and calls to rebuild the spec);
        without it the pool raises ``BackendError`` naming
        ``FunctionSpec.ref``.

        ``elastic=True`` makes the deploy fleet-elastic: asking for more
        shards than the fabric currently has grows it (instead of
        raising), and the endpoint registers cluster-wide — every shard
        the fleet ever grows to (``add_worker`` / ``scale_shards``)
        serves it too.  With ``shards`` omitted an elastic deploy joins
        the fabric at its current size (building a 1-shard fabric when
        none exists yet) rather than silently staying on the base
        scheduler.

        ``graded_warmth=True`` turns on the SPES-style warmth ladder for
        the endpoint's pools: keep-alive expiry demotes instances one
        warmth rung at a time (HOT -> INITIALIZED -> PROCESS) instead of
        reaping outright, and prewarm depth follows prediction
        confidence.  ``None`` (default) keeps the pool config's own
        setting.

        ``batch_size=N`` installs a pool-aware ``EndpointBatcher`` in
        front of the endpoint: single token rows admitted through
        ``submit_request`` are formed into adaptively-sized batches
        (never larger than N, the queue depth, or the fabric's current
        idle capacity) and each batch runs as ONE pooled invocation.
        N is clamped to the endpoint's compiled batch shape (padding
        covers partial fills; slicing beyond it cannot)."""
        self.endpoints[ep.name] = ep
        if isinstance(ep, ModelEndpoint) and ep._tracer is None:
            # an endpoint given no tracer records where its engine does
            ep._tracer = self.tracer
        if pool_config is None:
            pool_config = self._default_pool_config()
        if backend is not None:
            pool_config = dataclasses.replace(pool_config, backend=backend)
        if graded_warmth is not None:
            pool_config = dataclasses.replace(pool_config,
                                              graded_warmth=graded_warmth)
        if elastic or (shards is not None and shards > 1):
            cluster = self._ensure_cluster(max(shards or 1, 1),
                                           elastic=elastic)
            # elastic churn leaves live shard ids non-contiguous (ids are
            # never reused), so a fixed-width deploy takes the N lowest
            # live ids, not range(N)
            runtimes = cluster.register(
                ep.spec(), config=pool_config,
                # None = cluster-wide: elastic endpoints follow the fleet
                shards=None if elastic else sorted(
                    w.shard_id for w in cluster.workers)[:shards])
            self._clustered.add(ep.name)
            rt = min(runtimes.items())[1]
        else:
            rt = self.scheduler.register(ep.spec(), config=pool_config)
        rt.init()
        if batch_size is not None:
            self._install_batcher(ep, batch_size, batch_max_wait)
        return rt

    # -- pool-aware batching --------------------------------------------
    def _idle_capacity(self, name: str) -> int:
        """The fabric signal the endpoint batcher sizes against: idle
        instances plus cap headroom, summed across shards when the
        endpoint lives on the cluster."""
        if self.cluster is not None and name in self._clustered:
            return sum(w.idle_capacity(name) for w in self.cluster.workers)
        pool = self.scheduler.pools.get(name)
        return pool.idle_capacity() if pool is not None else 0

    def _install_batcher(self, ep: ModelEndpoint, batch_size: int,
                         max_wait: float):
        fill_cap = max(1, min(batch_size, ep.batch_size))

        def run_batch(payloads: List[Any]) -> Future:
            # one pooled invocation for the whole batch: pad the rows to
            # the endpoint's compiled shape, slice per-request logits
            # rows back out when it resolves
            fill = len(payloads)
            tokens = pad_batch([np.asarray(p, np.int32) for p in payloads],
                               ep.batch_size)
            target = self._target(ep.name)
            if target is self.scheduler:
                span = self.tracer.invocation(ep.name, app=ep.app,
                                              batch=True, fill=fill)
                inner = self.scheduler.submit(ep.name, {"tokens": tokens},
                                              _span=span)
            else:                        # cluster routing opens its own span
                inner = target.submit(ep.name, {"tokens": tokens})
            out: Future = Future()

            def _done(f: Future):
                try:
                    res = f.result()
                    logits = res["logits"]
                    out.set_result([logits[i] for i in range(fill)])
                except BaseException as e:           # noqa: BLE001
                    out.set_exception(e)

            inner.add_done_callback(_done)
            return out

        self.batchers[ep.name] = EndpointBatcher(
            ep.name, run_batch, batch_size=fill_cap, max_wait=max_wait,
            capacity=lambda: self._idle_capacity(ep.name))

    def submit_request(self, name: str, tokens_row) -> Future:
        """Admit ONE request (a single token row of the endpoint's
        ``seq_len``) through the endpoint's pool-aware batcher; resolves
        to that request's logits row.  Requires the endpoint to have been
        deployed with ``batch_size=``."""
        batcher = self.batchers.get(name)
        if batcher is None:
            raise KeyError(
                f"endpoint {name!r} has no batcher: deploy it with "
                f"batch_size= to enable single-request admission")
        return batcher.submit(tokens_row)

    def _target(self, name: str):
        if self.cluster is not None and name in self._clustered:
            return self.cluster
        return self.scheduler

    def invoke(self, name: str, tokens, freshen_successors: bool = True):
        return self._target(name).invoke(
            name, {"tokens": tokens}, freshen_successors=freshen_successors)

    def submit(self, name: str, tokens, freshen_successors: bool = True):
        """Concurrent admission through the scheduler's router (or the
        cluster router for sharded endpoints); returns a Future for the
        endpoint result."""
        return self._target(name).submit(
            name, {"tokens": tokens}, freshen_successors=freshen_successors)

    def chain(self, names: List[str], delay: float = 0.06):
        self.scheduler.predictor.graph.add_chain(names, delay=delay)

    def adopt_trace_policy(self, policy, time_scale: float = 1.0
                           ) -> Dict[str, object]:
        """Apply a trace-learned ``repro_torch.workloads.HistoryPolicy``
        to the deployed endpoints: each pool whose endpoint name appears
        in the policy's history is live-reconfigured (keep-alive from the
        observed idle-time distribution, max_instances from Little's
        law), on the base scheduler and on every shard, and the policy's
        inter-arrival histograms seed recurrence prediction so periodic
        endpoints self-prewarm.  Each pool's *measured* cold start is
        passed through as the keep-alive floor, so a pool on a measured
        backend (subprocess spawn, snapshot restore) is never retuned to
        reap faster than it can boot.  Returns ``{name: PoolConfig}`` for
        the pools that were retuned."""
        applied = {}
        schedulers = [self.scheduler]
        if self.cluster is not None:
            schedulers += [w.scheduler for w in self.cluster.workers]
        for name in policy.functions:
            for sched in schedulers:
                pool = sched.pools.get(name)
                if pool is None:
                    continue
                cfg = policy.pool_config(
                    name, base=pool.config, time_scale=time_scale,
                    measured_cold_start=pool.measured_cold_start())
                sched.apply_pool_config(name, cfg)
                applied[name] = cfg
        # one prime covers everything: cluster workers share this predictor
        policy.prime(self.scheduler.predictor, time_scale=time_scale)
        return applied

    def latency_summary(self, app: str) -> dict:
        """Merged latency view across the base scheduler and every cluster
        shard (raw-sample merge — percentiles do not compose).  Shards
        drained by an elastic shrink keep counting: their retained
        ledgers are merged in, so the view never loses history."""
        from repro_torch.cluster import ClusterAccountant
        accts = [self.scheduler.accountant]
        if self.cluster is not None:
            accts += [w.scheduler.accountant for w in self.cluster.workers]
            accts += list(self.cluster.accountant.retired)
        return ClusterAccountant(accts).latency_summary(app)

    def close(self, wait: bool = True):
        """Shut the scheduler's router and the fabric down (idempotent);
        call it in a finally block so worker threads and out-of-process
        instances never leak.  Batchers close first: their drains
        dispatch through the scheduler, which must still be alive to run
        them."""
        for batcher in self.batchers.values():
            batcher.close()
        self.scheduler.shutdown(wait=wait)
        if self.cluster is not None:
            self.cluster.shutdown(wait=wait)

    def platform_stats(self) -> Dict[str, dict]:
        stats = dict(self.scheduler.platform_stats())
        if self.cluster is not None:
            stats.update(self.cluster.platform_stats())
        return stats

    def metrics_snapshot(self) -> Dict[str, object]:
        """Unified typed-metrics dump: the base scheduler's registry plus
        (when a fabric exists) every shard's, under ``cluster.``."""
        out = dict(self.scheduler.metrics_snapshot())
        if self.cluster is not None:
            for key, val in self.cluster.metrics_snapshot().items():
                out[f"cluster.{key}"] = val
        for batcher in self.batchers.values():
            out.update(batcher.metrics_snapshot())
        return out
