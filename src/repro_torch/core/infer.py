"""Freshen inference (§3.3): generating a function's freshen plan
automatically from dynamic traces, instead of requiring the developer to
write it.

The paper's observations, implemented:
* identical code runs many times → trace ≥2 invocations and compare;
* only resources accessed through the provider's libraries are inferred
  (``TracedResourceLib`` — our DataGet/DataPut analogues record themselves);
* only accesses whose arguments are invocation-constant are freshenable
  (creds/ids that changed between traces are excluded);
* failure to infer is not fatal — an empty plan means the function runs
  unmodified.

The generated plan orders resources by first-access index, exactly the
``fr_state`` indexing of Algorithm 2, and the annotated function (Algorithm
3) is produced by wrapping accesses in FrFetch/FrWarm via the RunContext.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.freshen import Action, FreshenPlan, PlanEntry


@dataclass
class TraceRecord:
    op: str                   # "get" | "put" | "connect"
    resource: str
    args_key: Tuple           # hashable argument fingerprint
    order: int


class TraceCollector:
    """Thread-local dynamic trace of resource-library calls."""

    def __init__(self):
        self._tls = threading.local()

    def begin(self):
        self._tls.records = []
        self._tls.counter = 0

    def record(self, op: str, resource: str, args_key: Tuple):
        recs = getattr(self._tls, "records", None)
        if recs is None:
            return
        recs.append(TraceRecord(op, resource, args_key, self._tls.counter))
        self._tls.counter += 1

    def end(self) -> List[TraceRecord]:
        recs = getattr(self._tls, "records", [])
        self._tls.records = None
        return recs


@dataclass
class InferredResource:
    resource: str
    op: str
    action: Action
    first_index: int
    constant: bool


def analyze_traces(traces: Sequence[List[TraceRecord]]) -> List[InferredResource]:
    """Compare ≥1 traces; resources whose args changed across invocations are
    non-constant and excluded from the plan (§3.2: constant args only)."""
    if not traces:
        return []
    by_key: Dict[Tuple[str, str], List[TraceRecord]] = {}
    for tr in traces:
        seen = set()
        for rec in tr:
            key = (rec.op, rec.resource)
            if key in seen:
                continue             # first access per invocation defines order
            seen.add(key)
            by_key.setdefault(key, []).append(rec)
    out = []
    n = len(traces)
    for (op, resource), recs in by_key.items():
        if len(recs) < n:
            continue                 # not accessed on every invocation
        constant = len({r.args_key for r in recs}) == 1
        action = Action.FETCH if op == "get" else Action.WARM
        out.append(InferredResource(resource, op, action,
                                    min(r.order for r in recs), constant))
    out.sort(key=lambda r: r.first_index)
    return out


def build_plan(inferred: Sequence[InferredResource],
               thunks: Dict[str, Callable[[], Any]],
               ttls: Optional[Dict[str, float]] = None) -> FreshenPlan:
    """Materialize a FreshenPlan: index order = first-access order
    (Algorithm 2's fr_state indices)."""
    ttls = ttls or {}
    entries = []
    for r in inferred:
        if not r.constant:
            continue                 # freshen requires constant arguments
        thunk = thunks.get(r.resource)
        if thunk is None:
            continue                 # unknown library — failure to infer is OK
        entries.append(PlanEntry(r.resource, r.action, thunk,
                                 ttl=ttls.get(r.resource)))
    return FreshenPlan(entries)


def infer_plan(fn: Callable, sample_args: Sequence[Any],
               collector: TraceCollector,
               thunks: Dict[str, Callable[[], Any]],
               ttls: Optional[Dict[str, float]] = None) -> FreshenPlan:
    """End-to-end §3.3 pipeline: trace fn over sample invocations, analyze,
    and build the plan.  ``fn(args)`` must route resource accesses through a
    TracedResourceLib bound to ``collector``."""
    traces = []
    for args in sample_args:
        collector.begin()
        fn(args)
        traces.append(collector.end())
    return build_plan(analyze_traces(traces), thunks, ttls)
