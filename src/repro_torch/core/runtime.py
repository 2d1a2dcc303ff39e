"""The language-runtime / container model (§2 "Serverless runtime reuse").

Mirrors OpenWhisk's lifecycle: a container is created (cold), its ``init``
hook loads the function code and starts the persistent runtime, and each
``run`` hook executes the function.  We add the paper's third hook:
``freshen``, which executes the function's FreshenPlan in a separate thread
(§3.1 — non-blocking; the run hook's logic and timing are unmodified).

Runtime-scoped state (``Runtime.scope``) survives across invocations within
the container, exactly like runtime-scoped variables in the paper; the
``FreshenState`` and ``FreshenCache`` live there.

Warmth is a *ladder*, not a bool (SPES, arXiv 2403.17574): the freshen
plan is already a list of steps, and the provisioning cost decomposes the
same way —

    COLD -> PROCESS       (sandbox/interpreter up, function un-inited)
         -> INITIALIZED   (init_fn ran, plan built; servable)
         -> HOT           (fr_fetch/fr_warm caches populated)

``Runtime.warmth`` tracks the current rung; ``warm_to(level)`` promotes
through the rungs paying only the remaining cost, and ``demote_to(level)``
releases the upper rungs (cache invalidation, runtime teardown) while
keeping the cheaper ones resident.  ``initialized`` survives as a compat
property meaning ``warmth >= INITIALIZED``.

A Runtime is one *instance*; multi-instance pooling (warm-container
keep-alive, scale-to-zero, prewarm dispatch) lives in
``repro_torch.core.pool.InstancePool``.  Because pooled instances are touched
concurrently (an invocation on the run hook while a prewarm freshen runs
in its own thread), promotion is idempotent and guarded by a lock, and the
non-blocking freshen hook performs initialization inside its background
thread so a prewarm-provisioned cold start never blocks the dispatcher.

*Where* the hooks execute is delegated to an ``InstanceBackend``
(repro_torch.core.backend): the default ``ThreadBackend`` runs them in-process
(cold start = the simulated ``cold_start_cost`` sleep), while the
``SubprocessBackend`` runs them in a persistent worker process so
``init_seconds`` is the *measured* interpreter-spawn + import + init_fn
time.  The Runtime keeps the lifecycle bookkeeping — init lock, freshen
threads, counters — identical across backends.
"""
from __future__ import annotations

import enum
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

from repro_torch.core.cache import FreshenCache
from repro_torch.core.freshen import FreshenPlan, FreshenState


class WarmthLevel(enum.IntEnum):
    """The warmth ladder.  Ordered: comparisons and ``max`` work, and a
    level's int value doubles as its rung index (COLD=0 … HOT=3)."""

    COLD = 0          # nothing provisioned
    PROCESS = 1       # sandbox/interpreter booted, function un-inited
    INITIALIZED = 2   # init_fn ran, freshen plan built — servable
    HOT = 3           # fr_fetch/fr_warm caches populated

    @property
    def label(self) -> str:
        return self.name.lower()


@dataclass
class FunctionSpec:
    """Developer-provided function: code + (optional) freshen plan factory.

    ``code(ctx, args)`` receives a RunContext (runtime scope + fr wrappers)
    and the invocation arguments.  ``plan_factory(runtime)`` builds the
    ordered FreshenPlan; it may be developer-written (§3.3 "simplest
    implementation") or inferred (repro_torch.core.infer).
    """
    name: str
    code: Callable[["RunContext", Any], Any]
    plan_factory: Optional[Callable[["Runtime"], FreshenPlan]] = None
    app: str = "default"
    init_fn: Optional[Callable[["Runtime"], None]] = None
    # subprocess-backend escape hatch: "module:attr" resolving — in the
    # worker process — to this spec or to a zero-arg factory returning
    # it, for specs whose callables are closures and cannot pickle
    ref: Optional[str] = None


class RunContext:
    """What the function sees: runtime scope + FrFetch/FrWarm wrappers."""

    def __init__(self, runtime: "Runtime"):
        self.runtime = runtime
        self.scope = runtime.scope                 # runtime-scoped variables

    def fr_fetch(self, idx: int, code: Optional[Callable[[], Any]] = None):
        return self.runtime.fr_state.fr_fetch(idx, code)

    def fr_warm(self, idx: int, warm: Optional[Callable[[], Any]] = None):
        return self.runtime.fr_state.fr_warm(idx, warm)


class Runtime:
    """One warm container + persistent language runtime for one function."""

    def __init__(self, spec: FunctionSpec,
                 cold_start_cost: float = 0.0,
                 clock: Callable[[], float] = time.monotonic,
                 backend: Optional["InstanceBackend"] = None,
                 process_boot_fraction: float = 0.8):
        self.spec = spec
        self.clock = clock
        self.scope: Dict[str, Any] = {}            # runtime-scoped variables
        self.cache = FreshenCache()
        self.warmth = WarmthLevel.COLD
        self.cold_start_cost = cold_start_cost
        # thread backend only: what share of the simulated cold start is
        # sandbox boot (PROCESS) vs init_fn/plan (INITIALIZED)
        self.process_boot_fraction = process_boot_fraction
        self.fr_state: Optional[FreshenState] = None
        if backend is None:
            from repro_torch.core.backend import ThreadBackend
            backend = ThreadBackend()
        self.backend = backend
        self._freshen_threads: list[threading.Thread] = []
        self._threads_lock = threading.Lock()
        self._init_lock = threading.Lock()
        self.init_seconds = 0.0           # full COLD->INITIALIZED cost
        self.process_seconds = 0.0        # COLD->PROCESS share
        self.init_step_seconds = 0.0      # PROCESS->INITIALIZED share
        self.run_count = 0
        self.freshen_count = 0

    # ------------------------------------------------------------------
    @property
    def initialized(self) -> bool:
        """Compat view of the warmth ladder: servable (init_fn ran)."""
        return self.warmth >= WarmthLevel.INITIALIZED

    @initialized.setter
    def initialized(self, value: bool) -> None:
        if value:
            if self.warmth < WarmthLevel.INITIALIZED:
                self.warmth = WarmthLevel.INITIALIZED
        else:
            self.warmth = WarmthLevel.COLD

    # ------------------------------------------------------------------
    def init(self):
        """The init hook: start runtime, load code, build the freshen plan.
        Idempotent and thread-safe — a pooled instance may be initialized
        by whichever of run/freshen reaches it first.  Equivalent to
        ``warm_to(INITIALIZED)``: an instance already at PROCESS pays only
        the remaining init_fn/plan share."""
        with self._init_lock:
            self._promote_locked(WarmthLevel.INITIALIZED)

    def warm_to(self, level: WarmthLevel) -> None:
        """Promote this instance to *at least* ``level``, paying only the
        cost of the rungs still missing.  PROCESS/INITIALIZED promotion
        runs under the init lock; HOT promotion (cache population) runs
        through the blocking freshen hook outside it, so invocations and
        concurrent promotions serialize on the same locks they always
        did."""
        level = WarmthLevel(level)
        if self.warmth >= level:
            return
        from repro_torch.telemetry import NULL_SPAN, current_span
        span = current_span() or NULL_SPAN
        with span.phase("warm_to", target=level.label):
            with self._init_lock:
                self._promote_locked(min(level, WarmthLevel.INITIALIZED))
            if level >= WarmthLevel.HOT and self.warmth < WarmthLevel.HOT:
                self.freshen(blocking=True)

    def warm_async(self, level: WarmthLevel) -> Optional[threading.Thread]:
        """Non-blocking ``warm_to``: promotion runs in a background thread
        registered alongside freshen threads, so ``freshen_in_flight()``
        covers in-progress partial warms and the pool's reap/demote sweeps
        leave them alone."""
        level = WarmthLevel(level)
        if level >= WarmthLevel.HOT:
            return self.freshen(blocking=False)
        th = threading.Thread(target=lambda: self.warm_to(level),
                              name=f"warm-{self.spec.name}-{level.label}",
                              daemon=True)
        th.start()
        with self._threads_lock:
            self._freshen_threads.append(th)
        return th

    def demote_to(self, level: WarmthLevel) -> None:
        """Release the warmth rungs above ``level`` (keep-alive expiry
        demotes one rung at a time instead of reaping outright).  The
        backend drops what the rung held — HOT->INITIALIZED invalidates
        the fr caches, ->PROCESS tears down the inited runtime but keeps
        the sandbox resident.  No-op unless strictly downward."""
        level = WarmthLevel(level)
        with self._init_lock:
            if level >= self.warmth:
                return
            # _init_lock exists to serialize warmth transitions; the
            # backend demote (possibly a pipe round-trip) IS the
            # transition.  Callers must not hold pool/scheduler locks
            # here — the runtime sanitizer enforces that order.
            self.backend.demote(self, level)     # fabriclint: allow[blocking]
            self.warmth = level

    def _promote_locked(self, target: WarmthLevel) -> None:
        if self.warmth >= target:
            return
        # boot shares are attached to the invocation that triggered them:
        # current_span() resolves the thread-locally active span (run
        # path); background prewarm threads see the no-op null span
        from repro_torch.telemetry import NULL_SPAN, current_span
        span = current_span() or NULL_SPAN
        try:
            if self.warmth < WarmthLevel.PROCESS:
                t0 = self.clock()
                with span.phase("boot_process", backend=type(self.backend)
                                .__name__):
                    # _init_lock serializes boot; blocking here is its
                    # contract (never held with pool/scheduler locks)
                    self.backend.boot_process(self)  # fabriclint: allow[blocking]
                self.process_seconds = self.clock() - t0
                self.warmth = WarmthLevel.PROCESS
            if target >= WarmthLevel.INITIALIZED \
                    and self.warmth < WarmthLevel.INITIALIZED:
                t0 = self.clock()
                with span.phase("boot_init"):
                    self.backend.boot_init(self)     # fabriclint: allow[blocking]
                self.init_step_seconds = self.clock() - t0
                self.warmth = WarmthLevel.INITIALIZED
                self.init_seconds = (self.process_seconds
                                     + self.init_step_seconds)
        except BaseException:
            # a partial rung whose substrate died is not resumable: reset
            # to COLD so the retry pays a clean full boot (thread-backend
            # failures keep the PROCESS rung — the sleep was already paid)
            if self.warmth > WarmthLevel.COLD \
                    and not self.backend.alive(self):
                self.warmth = WarmthLevel.COLD
            raise

    def _set_warmth_at_least(self, level: WarmthLevel) -> None:
        with self._init_lock:
            if self.warmth < level:
                self.warmth = level

    def _ensure_init(self):
        if not self.initialized:
            self.init()

    # ------------------------------------------------------------------
    def freshen(self, blocking: bool = False) -> Optional[threading.Thread]:
        """The freshen hook (§3.1): run Algorithm 2 in a separate thread.
        Receives no function arguments (abuse rule, §3.3).  In the
        non-blocking case any pending cold start happens inside the
        background thread, keeping prewarm dispatch off the critical path.
        A completed freshen leaves the fr caches populated — the HOT rung."""
        self.freshen_count += 1

        def _run():
            self._ensure_init()
            self.backend.freshen(self)
            self._set_warmth_at_least(WarmthLevel.HOT)

        if blocking:
            _run()
            return None
        th = threading.Thread(target=_run, name=f"freshen-{self.spec.name}",
                              daemon=True)
        th.start()
        with self._threads_lock:
            self._freshen_threads.append(th)
        return th

    def run(self, args: Any = None) -> Any:
        """The run hook: execute the function (timing unmodified).  The
        function body's inline fr_fetch/fr_warm calls populate the caches,
        so a completed run leaves the instance HOT."""
        self._ensure_init()
        self.run_count += 1
        result = self.backend.run(self, args)
        self._set_warmth_at_least(WarmthLevel.HOT)
        return result

    def freshen_stats(self) -> Optional[dict]:
        """This instance's fr_state counters (freshened/inline/waits/hits),
        wherever they live — in-process for the thread backend, round-
        tripped from the worker for the subprocess backend.  None before
        the instance ever booted."""
        return self.backend.freshen_stats(self)

    def healthy(self) -> bool:
        """Whether the execution substrate can still serve (a subprocess
        worker or snapshot fork that died makes this False).  The pool
        evicts unhealthy instances instead of re-idling them, so the next
        acquire provisions fresh rather than re-failing on a corpse."""
        return self.backend.alive(self)

    def close(self):
        """Release the execution substrate (terminates a subprocess
        backend's worker).  Thread backend: no-op.  Idempotent."""
        self.backend.close()

    def freshen_in_flight(self) -> bool:
        """True while a non-blocking freshen/partial-warm is still running."""
        with self._threads_lock:
            self._freshen_threads = [t for t in self._freshen_threads
                                     if t.is_alive()]
            return bool(self._freshen_threads)

    def join_freshen(self, timeout: Optional[float] = None):
        with self._threads_lock:
            threads = list(self._freshen_threads)
        for th in threads:
            th.join(timeout)
        with self._threads_lock:
            self._freshen_threads = [t for t in self._freshen_threads
                                     if t.is_alive()]
