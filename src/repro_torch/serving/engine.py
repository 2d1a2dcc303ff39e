"""The port's serving engine: model endpoints as serverless functions
with first-class freshen integration (``repro/serving/engine.py``).

A ``ModelEndpoint`` is the paper's λ (Algorithm 1):

    procedure λ(tokens):
        params   := FrFetch(0, WeightStore.load(NAME))        # DataGet
        compiled := FrFetch(1, Executor.compile(score_fn))    # kernel build
        FrWarm(2, compiled.warmup())                          # CWND warming
        [data   := FrFetch(3, Datastore.get(CONST_KEY))]      # prefetch
        return compiled(params, tokens)

Weights and the "executable" are separate plan entries, so a new weight
version swaps in without rebuilding anything.  Endpoints run on the
device they were built for (``device="cuda"`` by default) and on the
scheduler's thread backend: CUDA state does not survive the snapshot
backend's ``fork``, so out-of-process endpoints and multi-shard
placement raise ``NotImplementedError`` naming their ROADMAP.md items.
"""
from __future__ import annotations

import dataclasses
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.freshen import Action, FreshenPlan, PlanEntry
from repro_torch.core.runtime import FunctionSpec, RunContext, Runtime
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import make_model
from repro_torch.serving.batching import EndpointBatcher, pad_batch
from repro_torch.serving.executor import Executor
from repro_torch.serving.weights import WeightStore
from repro_torch.specs import TensorSpec

PLACEMENT_ITEM = "ROADMAP.md module item 7 (placement: cluster router/worker)"
OUT_OF_PROCESS_ITEM = ("ROADMAP.md module item 10 (out-of-process model "
                       "endpoints)")


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


class ModelEndpoint:
    """One servable model = one serverless function."""

    def __init__(self, name: str, cfg: ModelConfig, store: WeightStore,
                 executor: Optional[Executor] = None, *,
                 batch_size: int = 4, seq_len: int = 64, app: str = "serving",
                 datastore=None, prefetch_key: Optional[str] = None,
                 prefetch_ttl: Optional[float] = None,
                 warm_budget: Optional[WarmBudget] = None,
                 device: DeviceLike = "cuda"):
        self.name = name
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = make_model(cfg, device=self.device)
        self.store = store
        self.executor = executor or Executor()
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.app = app
        self.datastore = datastore
        self.prefetch_key = prefetch_key
        self.prefetch_ttl = prefetch_ttl
        self.warm_budget = warm_budget or WarmBudget(min_repetitions=0)
        self.timings: List[dict] = []

    # ------------------------------------------------------------------
    def _score_fn(self):
        model = self.model

        def score(params, tokens):
            x, _ = model.forward(params, tokens)
            return model._logits(params, x[:, -1:])
        return score

    def _params_spec(self):
        return self.model.param_specs()

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
        entries = [
            PlanEntry("weights", Action.FETCH, self._load_weights,
                      version_fn=lambda: self.store.version(self.name)),
            PlanEntry("compiled", Action.FETCH, self._compile),
            PlanEntry("warmup", Action.WARM, self._warmup),
        ]
        if self.datastore is not None and self.prefetch_key is not None:
            entries.append(PlanEntry(
                "prefetch", Action.FETCH,
                lambda: self.datastore.get(self.prefetch_key)[0],
                ttl=self.prefetch_ttl,
                version_fn=lambda: self.datastore.version(self.prefetch_key)))
        return FreshenPlan(entries)

    def _load_weights(self):
        params, real, modeled = self.store.load(self.name, device=self.device)
        return params

    def _compile(self):
        compiled, dt = self.executor.compile(
            f"{self.name}/score", self._score_fn(), self._specs(),
            device=self.device)
        return compiled

    def _warmup(self):
        key = (self.name, self.batch_size, self.seq_len)
        if not self.warm_budget.allows(key):
            return 0.0
        compiled = self.executor.get(f"{self.name}/score", self._specs())
        if compiled is None:
            compiled = self._compile()
        return self.executor.warmup(compiled, self._specs())

    # ------------------------------------------------------------------
    # Decode sessions: the KV cache is a freshen-preallocatable resource
    # (the paper's buffer/CWND-warming analogue for serving state).
    def _decode_fns(self, max_len: int):
        model = self.model

        def prefill(params, tokens, cache):
            return model.prefill(params, tokens, max_len=max_len, cache=cache)

        def decode(params, cache, token, pos):
            return model.decode_step(params, cache, token, pos)
        return prefill, decode

    def _compile_decode(self, max_len: int):
        params_spec = self._params_spec()
        cache_spec = self.model.cache_specs(self.batch_size, max_len)
        prefill, decode = self._decode_fns(max_len)
        c_pre, _ = self.executor.compile(
            f"{self.name}/prefill{max_len}", prefill,
            (params_spec, self._tokens_spec(self.seq_len), cache_spec),
            device=self.device)
        c_dec, _ = self.executor.compile(
            f"{self.name}/decode{max_len}", decode,
            (params_spec, cache_spec, self._tokens_spec(1),
             TensorSpec((self.batch_size,), torch.int32)),
            device=self.device)
        return c_pre, c_dec

    def _prealloc_session(self, max_len: int):
        """Allocate (for real) the decode cache buffers ahead of time."""
        cache = self.model.init_cache(self.batch_size, max_len)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return cache

    def session_plan_entries(self, max_len: int):
        """Extra freshen resources for generation endpoints."""
        return [
            PlanEntry("decode_executables", Action.FETCH,
                      lambda: self._compile_decode(max_len)),
            PlanEntry("session_cache", Action.FETCH,
                      lambda: self._prealloc_session(max_len)),
        ]

    def generate(self, ctx: RunContext, tokens, n_steps: int, max_len: int,
                 plan_offset: int):
        """Greedy autoregressive generation using the freshened
        executables and cache; returns row 0's tokens.  ``plan_offset`` =
        fr_state index of 'decode_executables'."""
        params = ctx.fr_fetch(0)
        c_pre, c_dec = ctx.fr_fetch(plan_offset)
        # the preallocated session cache: prefill seeds it in place and
        # every decode step writes its token's K/V into it in place
        cache = ctx.fr_fetch(plan_offset + 1)
        toks = self._tokens(tokens)
        logits, cache = c_pre(params, toks, cache)
        B, S = toks.shape
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        out = [int(tok[0, 0])]
        pos = torch.full((B,), S, dtype=torch.int32, device=self.device)
        for _ in range(n_steps - 1):
            logits, cache = c_dec(params, cache, tok, pos)
            tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
            pos = pos + 1
            out.append(int(tok[0, 0]))
        return out

    def code(self, ctx: RunContext, args):
        """The run-hook body (Algorithm 3: annotated λ)."""
        # fabriclint: allow[clock] -- measured run-phase timing is a wall-clock contract
        t0 = time.monotonic()
        tokens = self._tokens(args["tokens"])
        params = ctx.fr_fetch(0)                  # FrFetch(0, DataGet(...))
        # fabriclint: allow[clock] -- measured run-phase timing is a wall-clock contract
        t_w = time.monotonic()
        compiled = ctx.fr_fetch(1)                # FrFetch(1, compile)
        # fabriclint: allow[clock] -- measured run-phase timing is a wall-clock contract
        t_c = time.monotonic()
        ctx.fr_warm(2)                            # FrWarm(2, warmup)
        # fabriclint: allow[clock] -- measured run-phase timing is a wall-clock contract
        t_u = time.monotonic()
        extra = ctx.fr_fetch(3) if len(ctx.runtime.fr_state.plan) > 3 else None
        logits = _to_numpy(compiled(params, tokens))   # waits for the device
        # fabriclint: allow[clock] -- measured run-phase timing is a wall-clock contract
        t1 = time.monotonic()
        self.warm_budget.observe((self.name, self.batch_size, self.seq_len))
        timing = {"total": t1 - t0, "weights": t_w - t0,
                  "compile": t_c - t_w, "warmup": t_u - t_c,
                  "execute": t1 - t_u}
        self.timings.append(timing)
        return {"logits": logits, "timing": timing, "extra": extra}

    def spec(self) -> FunctionSpec:
        return FunctionSpec(self.name, self.code,
                            plan_factory=self.build_plan, app=self.app)


class ServingEngine:
    """Model endpoints behind a FreshenScheduler — the 'serverless
    platform' of the evaluation.

    Each deployed endpoint is backed by an ``InstancePool``: concurrent
    requests admitted via ``submit`` fan out across warm instances, scale
    the pool up under queue pressure, and are prewarmed by
    predicted-successor freshen dispatch.  ``deploy`` eagerly initializes
    the primary instance; additional instances cold-start on demand.
    This slice serves from one scheduler (one shard, thread backend)."""

    def __init__(self, scheduler=None, tracer=None):
        from repro_torch.core.scheduler import FreshenScheduler
        self.scheduler = scheduler or FreshenScheduler(tracer=tracer)
        if tracer is not None and not self.scheduler.tracer.enabled:
            self.scheduler.tracer = tracer
        self.tracer = self.scheduler.tracer
        self.endpoints: Dict[str, ModelEndpoint] = {}
        # pool-aware request batchers, one per endpoint deployed with
        # ``batch_size=``: single requests admitted via submit_request are
        # formed into batches and run as ONE pooled invocation each
        self.batchers: Dict[str, EndpointBatcher] = {}

    def _default_pool_config(self):
        # model endpoints hold weight loads and kernel builds: a generic
        # 30s keep-alive would reap them between pipeline stages, so
        # serving defaults to a long retention on top of the
        # scheduler-wide pool policy
        return dataclasses.replace(self.scheduler.pool_config,
                                   keep_alive=600.0)

    def scale_shards(self, n: int, drain: bool = True) -> int:
        """The live shard count; this slice has exactly one."""
        if n < 1:
            raise ValueError(f"a fabric needs at least one shard (got {n})")
        if n > 1:
            raise NotImplementedError(
                f"multi-shard serving is not ported yet: {PLACEMENT_ITEM}")
        return 1

    def deploy(self, ep: ModelEndpoint, pool_config=None,
               shards: Optional[int] = None,
               backend: Optional[str] = None,
               elastic: bool = False,
               graded_warmth: Optional[bool] = None,
               batch_size: Optional[int] = None,
               batch_max_wait: float = 0.01) -> Runtime:
        """Register an endpoint on the scheduler and initialize its
        primary instance.  ``graded_warmth`` and ``batch_size`` behave as
        in the reference; ``shards > 1``, ``elastic`` and out-of-process
        ``backend``s raise ``NotImplementedError``."""
        if elastic or (shards is not None and shards > 1):
            raise NotImplementedError(
                f"sharded/elastic deploys are not ported yet: {PLACEMENT_ITEM}")
        if backend not in (None, "thread"):
            raise NotImplementedError(
                f"backend {backend!r}: model endpoints run on the thread "
                f"backend in this slice; {OUT_OF_PROCESS_ITEM}")
        self.endpoints[ep.name] = ep
        if pool_config is None:
            pool_config = self._default_pool_config()
        if pool_config.backend != "thread":
            raise NotImplementedError(
                f"pool backend {pool_config.backend!r}: {OUT_OF_PROCESS_ITEM}")
        if graded_warmth is not None:
            pool_config = dataclasses.replace(pool_config,
                                              graded_warmth=graded_warmth)
        rt = self.scheduler.register(ep.spec(), config=pool_config)
        rt.init()
        if batch_size is not None:
            self._install_batcher(ep, batch_size, batch_max_wait)
        return rt

    # -- pool-aware batching --------------------------------------------
    def _idle_capacity(self, name: str) -> int:
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
            span = self.tracer.invocation(ep.name, app=ep.app,
                                          batch=True, fill=fill)
            inner = self.scheduler.submit(ep.name, {"tokens": tokens},
                                          _span=span)
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

    def invoke(self, name: str, tokens, freshen_successors: bool = True):
        return self.scheduler.invoke(
            name, {"tokens": tokens}, freshen_successors=freshen_successors)

    def submit(self, name: str, tokens, freshen_successors: bool = True):
        """Concurrent admission through the scheduler's router; returns a
        Future for the endpoint result."""
        return self.scheduler.submit(
            name, {"tokens": tokens}, freshen_successors=freshen_successors)

    def chain(self, names: List[str], delay: float = 0.06):
        self.scheduler.predictor.graph.add_chain(names, delay=delay)

    def latency_summary(self, app: str) -> dict:
        from repro_torch.cluster import ClusterAccountant
        return ClusterAccountant([self.scheduler.accountant]).latency_summary(
            app)

    def close(self, wait: bool = True):
        """Shut the scheduler's router down (idempotent); call it in a
        finally block so worker threads never leak.  Batchers close
        first: their drains dispatch through the scheduler."""
        for batcher in self.batchers.values():
            batcher.close()
        self.scheduler.shutdown(wait=wait)

    def platform_stats(self) -> Dict[str, dict]:
        return dict(self.scheduler.platform_stats())

    def metrics_snapshot(self) -> Dict[str, object]:
        out = dict(self.scheduler.metrics_snapshot())
        for batcher in self.batchers.values():
            out.update(batcher.metrics_snapshot())
        return out
