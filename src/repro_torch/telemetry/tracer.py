"""Per-invocation span tracing for the serving fabric.

The platform's existing accounting answers *how slow* (p50/p95/p99 after
the fact); this module answers *where the time went* for a single
request.  Every admitted invocation produces one ``InvocationSpan`` with
phase children drawn from a fixed taxonomy —

    route         placement / prediction+freshen-dispatch overhead
    queue         admission-to-start hop (router executor queueing)
    acquire       InstancePool.acquire (includes pool queue wait)
    boot_process  sandbox/interpreter boot share of a cold start
    boot_init     init_fn/plan share of a cold start
    warm_to       explicit warmth promotion on the critical path
    run           the run hook proper
    release       InstancePool.release

— and every predictor-driven prewarm produces one ``FreshenSpan`` whose
lifecycle mirrors the paper's misprediction accounting: created at
prediction time, anchored at the *predicted* arrival
(``predicted_for = start + expected_delay``), then terminal as
``landed`` (an arrival of the function resolved it — the span is linked
to that invocation, nearest-anchor-within-horizon, the same rule
``Accountant._resolve_pending_locked`` bills by), ``expired`` (no
arrival within the horizon), or ``gated`` (the accounting gate refused
the dispatch).

Design constraints, in order:

* **Zero overhead when disabled.**  A disabled tracer returns the
  ``NULL_SPAN`` singleton from every constructor; all of its methods are
  no-ops and its ``phase``/``active`` context managers are a shared
  constant.  The per-request cost of tracing-off is a handful of
  attribute checks — no allocation, no locking, no clock reads.
* **Lock-cheap when enabled.**  A span is mutated only by the thread
  driving its invocation; the tracer's lock is taken once per span
  *completion* (ring-buffer append + freshen matching), never per
  phase.
* **Bounded.**  Completed spans live in ``deque(maxlen=capacity)`` ring
  buffers — a long-running platform traces forever without growing.
* **Deterministic under test.**  ``clock`` is injectable
  (``tests/conftest.FakeClock`` drops straight in), and nothing reads
  wall time behind the caller's back.

Thread-locally *activating* a span (``span.active()``) lets layers that
do not hold a span reference — ``Runtime``'s boot path, deep inside a
cold start — attach phases to the invocation that caused them via
``current_span()``.
"""
from __future__ import annotations

import itertools
import json
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

#: the fixed phase taxonomy (docs/architecture.md "Observability")
PHASES = ("route", "queue", "acquire", "boot_process", "boot_init",
          "warm_to", "run", "release")

_tls = threading.local()


def current_span() -> Optional["InvocationSpan"]:
    """The invocation span active on this thread, or None.  Layers with
    no span reference (Runtime boot hooks) attach cold-start phases to
    whatever invocation is driving them; background threads (freshen,
    daemon sweeps) see None and skip."""
    return getattr(_tls, "span", None)


class _NullCtx:
    """Shared no-op context manager (the disabled-tracing fast path)."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    # phase-context compat: attribute writes on the null phase are dropped
    def annotate(self, **attrs):
        return self


_NULL_CTX = _NullCtx()


class _NullSpan:
    """No-op stand-in returned by a disabled tracer.  Every method is a
    no-op returning a constant, so call sites need no ``if enabled``
    guards and pay no allocation."""
    __slots__ = ()
    enabled = False

    def phase(self, name: str, **attrs):
        return _NULL_CTX

    def phase_from(self, name: str, start: float, **attrs):
        return None

    def active(self):
        return _NULL_CTX

    def annotate(self, **attrs):
        return self

    def mark_submitted(self):
        return self

    def finish(self, error: Optional[str] = None):
        return self

    # freshen-span compat
    def dispatched(self, reason: str = "dispatched"):
        return self

    def gated(self, reason: str = "gated"):
        return self

    def dispatch_done(self):
        return self

    def __bool__(self):
        return False


NULL_SPAN = _NullSpan()


class PhaseSpan:
    """One phase child of an invocation span.  Mutated only by the
    owning thread; published with its parent at span completion."""
    __slots__ = ("name", "start", "end", "attrs")

    def __init__(self, name: str, start: float,
                 attrs: Optional[dict] = None):
        self.name = name
        self.start = start
        self.end: Optional[float] = None
        self.attrs: Dict[str, Any] = attrs or {}

    @property
    def duration(self) -> float:
        return (self.end - self.start) if self.end is not None else 0.0

    def annotate(self, **attrs):
        self.attrs.update(attrs)
        return self

    def to_dict(self) -> dict:
        return {"name": self.name, "start": self.start, "end": self.end,
                "duration": self.duration, "attrs": dict(self.attrs)}


class _PhaseCtx:
    """Context manager closing one phase (records end on exit, even on
    error — a raising run hook still yields a complete span tree)."""
    __slots__ = ("_span", "_phase")

    def __init__(self, span: "InvocationSpan", phase: PhaseSpan):
        self._span = span
        self._phase = phase

    def __enter__(self):
        return self._phase

    def __exit__(self, exc_type, exc, tb):
        self._phase.end = self._span.tracer.clock()
        if exc_type is not None:
            self._phase.attrs["error"] = exc_type.__name__
        return False


class _ActiveCtx:
    """Thread-local activation: ``current_span()`` resolves to this span
    inside the block.  Restores the previous span on exit so nested
    invocations (chains) unwind correctly."""
    __slots__ = ("_span", "_prev")

    def __init__(self, span: "InvocationSpan"):
        self._span = span
        self._prev = None

    def __enter__(self):
        self._prev = getattr(_tls, "span", None)
        _tls.span = self._span
        return self._span

    def __exit__(self, *exc):
        _tls.span = self._prev
        return False


class InvocationSpan:
    """One invocation's span tree: the end-to-end envelope plus ordered
    phase children.  Single-writer: only the thread driving the
    invocation mutates it; the tracer publishes it once on finish."""
    __slots__ = ("tracer", "span_id", "fn", "app", "start", "end",
                 "submitted_at", "attrs", "phases", "thread_id",
                 "linked_freshens", "_finished")
    enabled = True

    def __init__(self, tracer: "Tracer", span_id: int, fn: str,
                 app: str = "default", **attrs):
        self.tracer = tracer
        self.span_id = span_id
        self.fn = fn
        self.app = app
        self.start = tracer.clock()
        self.end: Optional[float] = None
        self.submitted_at: Optional[float] = None
        self.attrs: Dict[str, Any] = dict(attrs)
        self.phases: List[PhaseSpan] = []
        self.thread_id = threading.get_ident()
        self.linked_freshens: List[int] = []     # FreshenSpan ids
        self._finished = False

    # -- recording -----------------------------------------------------
    def phase(self, name: str, **attrs) -> _PhaseCtx:
        """Open one phase child; close it by exiting the context."""
        ph = PhaseSpan(name, self.tracer.clock(), attrs or None)
        self.phases.append(ph)
        return _PhaseCtx(self, ph)

    def phase_from(self, name: str, start: float, **attrs
                   ) -> PhaseSpan:
        """Record an already-elapsed phase retroactively (e.g. the
        ``queue`` hop between submit and invoke start)."""
        ph = PhaseSpan(name, start, attrs or None)
        ph.end = self.tracer.clock()
        self.phases.append(ph)
        return ph

    def active(self) -> _ActiveCtx:
        """Make this span the thread's ``current_span()`` for a block —
        the run hook's cold-start boot phases attach through this."""
        return _ActiveCtx(self)

    def annotate(self, **attrs) -> "InvocationSpan":
        self.attrs.update(attrs)
        return self

    def mark_submitted(self) -> "InvocationSpan":
        """Stamp admission time; invoke's ``queue`` phase starts here."""
        self.submitted_at = self.tracer.clock()
        return self

    def finish(self, error: Optional[str] = None) -> "InvocationSpan":
        """Close the envelope and publish to the tracer ring buffer
        (idempotent).  Publication is where freshen->arrival linking
        happens."""
        if self._finished:
            return self
        self._finished = True
        self.end = self.tracer.clock()
        if error is not None:
            self.attrs["error"] = error
        self.tracer._finish_invocation(self)
        return self

    # -- views ---------------------------------------------------------
    @property
    def duration(self) -> float:
        return (self.end - self.start) if self.end is not None else 0.0

    def phase_seconds(self) -> Dict[str, float]:
        """Summed duration per phase name (a phase may repeat)."""
        out: Dict[str, float] = {}
        for ph in self.phases:
            out[ph.name] = out.get(ph.name, 0.0) + ph.duration
        return out

    def complete(self) -> bool:
        """A complete span tree: the envelope is closed and every phase
        child closed within it (no orphaned phases)."""
        if self.end is None:
            return False
        return all(ph.end is not None
                   and ph.start >= self.start - 1e-9
                   and ph.end <= self.end + 1e-9
                   for ph in self.phases)

    def to_dict(self) -> dict:
        return {"kind": "invocation", "id": self.span_id, "fn": self.fn,
                "app": self.app, "start": self.start, "end": self.end,
                "duration": self.duration, "thread": self.thread_id,
                "attrs": dict(self.attrs),
                "linked_freshens": list(self.linked_freshens),
                "phases": [ph.to_dict() for ph in self.phases]}


class FreshenSpan:
    """One prewarm's lifecycle: predicted at ``start``, anchored at
    ``predicted_for``, terminal as landed / expired / gated."""
    __slots__ = ("tracer", "span_id", "fn", "start", "end",
                 "predicted_for", "confidence", "level", "reason",
                 "outcome", "dispatch_end", "linked_invocation")
    enabled = True

    def __init__(self, tracer: "Tracer", span_id: int, fn: str,
                 confidence: float = 0.0, level: str = "hot",
                 expected_delay: float = 0.0):
        self.tracer = tracer
        self.span_id = span_id
        self.fn = fn
        self.start = tracer.clock()
        self.end: Optional[float] = None
        self.predicted_for = self.start + expected_delay
        self.confidence = confidence
        self.level = level
        self.reason = ""
        self.outcome = "pending"
        self.dispatch_end: Optional[float] = None  # warm work completed
        self.linked_invocation: Optional[int] = None

    def dispatched(self, reason: str = "dispatched") -> "FreshenSpan":
        """The prewarm was actually dispatched: track it pending until an
        arrival lands on it or the horizon expires."""
        self.reason = reason
        self.tracer._track_freshen(self)
        return self

    def gated(self, reason: str = "gated") -> "FreshenSpan":
        """Terminal without dispatch (accounting gate, no target)."""
        self.reason = reason
        self.outcome = "gated"
        self.end = self.tracer.clock()
        self.tracer._finish_freshen(self)
        return self

    def dispatch_done(self) -> "FreshenSpan":
        """The warm work itself finished (joined freshen threads)."""
        self.dispatch_end = self.tracer.clock()
        return self

    def _land(self, inv: InvocationSpan, now: float):
        self.outcome = "landed"
        self.end = now
        self.linked_invocation = inv.span_id
        inv.linked_freshens.append(self.span_id)

    def _expire(self, now: float):
        self.outcome = "expired"
        self.end = now

    def to_dict(self) -> dict:
        return {"kind": "freshen", "id": self.span_id, "fn": self.fn,
                "start": self.start, "end": self.end,
                "predicted_for": self.predicted_for,
                "confidence": self.confidence, "level": self.level,
                "reason": self.reason, "outcome": self.outcome,
                "dispatch_end": self.dispatch_end,
                "linked_invocation": self.linked_invocation}


class Tracer:
    """The span source and sink: hands out spans, matches freshens to
    the arrivals they anchored, and keeps the last ``capacity`` of each
    in ring buffers.

    One tracer spans the whole fabric: the cluster router and every
    shard scheduler share it, so a cross-shard freshen and the arrival
    it lands on meet in the same pending table no matter which shard
    dispatched which."""

    def __init__(self, capacity: int = 4096,
                 clock: Callable[[], float] = time.monotonic,
                 enabled: bool = True, horizon: float = 5.0):
        self.enabled = enabled
        self.clock = clock
        self.capacity = capacity
        self.horizon = horizon
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._spans: deque = deque(maxlen=capacity)       # InvocationSpan
        self._freshens: deque = deque(maxlen=capacity)    # terminal FreshenSpan
        self._pending_freshen: Dict[str, List[FreshenSpan]] = {}
        self.dropped = 0          # completed spans evicted by the ring

    # -- span construction ---------------------------------------------
    def invocation(self, fn: str, app: str = "default", **attrs):
        """Open one invocation span (``NULL_SPAN`` when disabled)."""
        if not self.enabled:
            return NULL_SPAN
        with self._lock:
            span_id = next(self._ids)
        return InvocationSpan(self, span_id, fn, app=app, **attrs)

    def freshen(self, fn: str, confidence: float = 0.0,
                level: str = "hot", expected_delay: float = 0.0):
        """Open one freshen-lifecycle span (``NULL_SPAN`` when
        disabled).  Call ``.dispatched()`` or ``.gated()`` on it."""
        if not self.enabled:
            return NULL_SPAN
        with self._lock:
            span_id = next(self._ids)
        return FreshenSpan(self, span_id, fn, confidence=confidence,
                           level=level, expected_delay=expected_delay)

    # -- lifecycle plumbing (called by spans) ---------------------------
    def _track_freshen(self, span: FreshenSpan):
        with self._lock:
            self._pending_freshen.setdefault(span.fn, []).append(span)

    def _finish_freshen(self, span: FreshenSpan):
        with self._lock:
            if len(self._freshens) == self._freshens.maxlen:
                self.dropped += 1
            self._freshens.append(span)

    def _finish_invocation(self, span: InvocationSpan):
        """Publish a completed invocation and resolve at most one pending
        freshen for its function — the anchor nearest the arrival within
        the horizon (the rule the Accountant bills by), so the exported
        trace links each prewarm to the arrival that consumed it."""
        now = span.end if span.end is not None else self.clock()
        landed: Optional[FreshenSpan] = None
        expired: List[FreshenSpan] = []
        with self._lock:
            pend = self._pending_freshen.get(span.fn)
            if pend:
                keep: List[FreshenSpan] = []
                for fs in pend:
                    if now - fs.predicted_for > self.horizon:
                        expired.append(fs)
                    else:
                        keep.append(fs)
                best_i, best_d = -1, None
                for i, fs in enumerate(keep):
                    d = abs(now - fs.predicted_for)
                    if d <= self.horizon and (best_d is None or d < best_d):
                        best_i, best_d = i, d
                if best_i >= 0:
                    landed = keep.pop(best_i)
                if keep:
                    self._pending_freshen[span.fn] = keep
                else:
                    self._pending_freshen.pop(span.fn, None)
            if landed is not None:
                landed._land(span, now)
                if len(self._freshens) == self._freshens.maxlen:
                    self.dropped += 1
                self._freshens.append(landed)
            if len(self._spans) == self._spans.maxlen:
                self.dropped += 1
            self._spans.append(span)
            for fs in expired:
                fs._expire(now)
                if len(self._freshens) == self._freshens.maxlen:
                    self.dropped += 1
                self._freshens.append(fs)

    def sweep_expired(self, now: Optional[float] = None) -> int:
        """Expire pending freshens whose horizon has passed with no
        arrival; returns how many expired.  Called lazily by exports and
        by whoever owns a periodic tick (the AdaptDaemon pass)."""
        now = self.clock() if now is None else now
        expired: List[FreshenSpan] = []
        with self._lock:
            for fn, pend in list(self._pending_freshen.items()):
                keep = []
                for fs in pend:
                    if now - fs.predicted_for > self.horizon:
                        expired.append(fs)
                    else:
                        keep.append(fs)
                if keep:
                    self._pending_freshen[fn] = keep
                else:
                    self._pending_freshen.pop(fn, None)
            for fs in expired:
                fs._expire(now)
                if len(self._freshens) == self._freshens.maxlen:
                    self.dropped += 1
                self._freshens.append(fs)
        return len(expired)

    # -- views ----------------------------------------------------------
    def spans(self) -> List[InvocationSpan]:
        """Completed invocation spans, oldest first (ring snapshot)."""
        with self._lock:
            return list(self._spans)

    def freshen_spans(self, include_pending: bool = False
                      ) -> List[FreshenSpan]:
        """Terminal freshen spans (+ pending ones on request)."""
        with self._lock:
            out = list(self._freshens)
            if include_pending:
                for pend in self._pending_freshen.values():
                    out.extend(pend)
        return out

    def pending_freshens(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._pending_freshen.values())

    def clear(self):
        with self._lock:
            self._spans.clear()
            self._freshens.clear()
            self._pending_freshen.clear()
            self.dropped = 0

    def snapshot(self) -> dict:
        """Plain-dict dump for benchmarks: every completed span tree plus
        per-phase aggregate seconds (sum/count per phase name)."""
        spans = self.spans()
        freshens = self.freshen_spans()
        agg: Dict[str, List[float]] = {}
        for sp in spans:
            for name, secs in sp.phase_seconds().items():
                agg.setdefault(name, []).append(secs)
        tally = {"landed": 0, "expired": 0, "gated": 0}
        for fs in freshens:
            tally[fs.outcome] = tally.get(fs.outcome, 0) + 1
        return {
            "invocations": [sp.to_dict() for sp in spans],
            "freshens": [fs.to_dict() for fs in freshens],
            "phase_totals": {name: {"seconds": sum(v), "count": len(v),
                                    "mean": sum(v) / len(v)}
                             for name, v in agg.items()},
            "freshen_tally": tally,
            "dropped": self.dropped,
        }

    def export_chrome(self, path: str) -> int:
        """Write the ring buffers as Chrome trace-event JSON (loadable in
        ``chrome://tracing`` / Perfetto); returns the event count.  See
        ``repro_torch.telemetry.export`` for the event mapping."""
        from repro_torch.telemetry.export import chrome_trace_events
        events = chrome_trace_events(self.spans(), self.freshen_spans())
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
        return len(events)


#: shared disabled tracer — the default everywhere a tracer is optional,
#: so tracing-off call sites all hit the same null fast path
NULL_TRACER = Tracer(capacity=0, enabled=False)
