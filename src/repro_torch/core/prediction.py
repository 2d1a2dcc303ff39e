"""Prediction of impending function invocations (§2, "Regaining efficiency
via prediction").

Three predictors, matching the paper's sources of opportunity:

* ``ChainGraph``    — explicit chains from orchestration frameworks
                      (AWS Step Functions-style DAGs with edge probabilities).
* ``MarkovPredictor`` — chains *derived* from observed traces ("can be
                      derived via tracing or service mesh techniques [6]"),
                      a first-order Markov model with Laplace smoothing and
                      count-based confidence.
* ``RecurrencePredictor`` — a function's *own* next invocation, from its
                      inter-arrival history (the timer-trigger periodicity
                      that dominates real serverless traces; cf. the
                      histogram keep-alive policies of Serverless-in-the-
                      Wild-style systems).  Confidence comes from
                      regularity: tight inter-arrival distributions predict
                      strongly, erratic ones barely at all.

All answer: given that ``fn`` was just invoked (or is starting), which
functions will run next, with what probability, and how much time do we have
(the trigger-service delay window, Table 1)?
"""
from __future__ import annotations

import threading
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class Prediction:
    fn: str
    probability: float
    expected_delay: float          # seconds until the successor starts


class ChainGraph:
    """Explicit serverless function chain (orchestration DAG)."""

    def __init__(self):
        self._edges: Dict[str, List[Tuple[str, float, float]]] = defaultdict(list)

    def add_edge(self, src: str, dst: str, probability: float = 1.0,
                 delay: float = 0.06):
        self._edges[src].append((dst, probability, delay))
        return self

    def add_chain(self, fns: Sequence[str], delay: float = 0.06):
        for a, b in zip(fns, fns[1:]):
            self.add_edge(a, b, 1.0, delay)
        return self

    def successors(self, fn: str) -> List[Prediction]:
        return [Prediction(dst, p, d) for dst, p, d in self._edges.get(fn, [])]

    def functions(self) -> set:
        fns = set(self._edges)
        for outs in self._edges.values():
            fns |= {dst for dst, _, _ in outs}
        return fns

    def linear_depth_from(self, fn: str) -> int:
        """Longest chain below fn — bounds the prediction horizon (§2:
        'opportunities ... as high as ~5.6s in the extreme linear case')."""
        seen = set()

        def depth(f):
            if f in seen:
                return 0
            seen.add(f)
            outs = self._edges.get(f, [])
            d = 1 + max((depth(dst) for dst, _, _ in outs), default=0) \
                if outs else 1
            seen.discard(f)
            return d

        return depth(fn) - 1


class MarkovPredictor:
    """First-order successor model learned from invocation traces."""

    def __init__(self, smoothing: float = 0.5, min_count: int = 3):
        self.smoothing = smoothing
        self.min_count = min_count
        self._counts: Dict[str, Dict[str, int]] = defaultdict(lambda: defaultdict(int))
        self._delays: Dict[Tuple[str, str], List[float]] = defaultdict(list)
        self._last: Optional[Tuple[str, float]] = None
        self._lock = threading.Lock()

    def observe(self, fn: str, timestamp: float, *, horizon: float = 30.0):
        with self._lock:
            if self._last is not None:
                prev, t_prev = self._last
                dt = timestamp - t_prev
                if 0 <= dt <= horizon:
                    self._counts[prev][fn] += 1
                    self._delays[(prev, fn)].append(dt)
            self._last = (fn, timestamp)

    def reset_session(self):
        with self._lock:
            self._last = None

    def successors(self, fn: str, top_k: int = 3) -> List[Prediction]:
        with self._lock:
            succ = self._counts.get(fn)
            if not succ:
                return []
            total = sum(succ.values())
            if total < self.min_count:
                return []
            n_types = len(succ)
            preds = []
            for dst, c in succ.items():
                p = (c + self.smoothing) / (total + self.smoothing * n_types)
                ds = self._delays[(fn, dst)]
                delay = sorted(ds)[len(ds) // 2] if ds else 0.06
                preds.append(Prediction(dst, p, delay))
            preds.sort(key=lambda x: -x.probability)
            return preds[:top_k]


class RecurrencePredictor:
    """Predicts a function's own next invocation from inter-arrival history.

    Where ``MarkovPredictor`` learns *which other* function follows,
    this learns *when the same* function recurs — the signal behind
    history-adaptive keep-alive and self-prewarm timing.  Probability is a
    regularity score ``1 / (1 + cv)`` (cv = coefficient of variation of the
    inter-arrival gaps): a strict timer scores ~1.0, Poisson traffic ~0.5,
    and heavy-tailed arrivals near 0.  No prediction is emitted until
    ``min_samples`` gaps are seen, or when the median gap exceeds
    ``horizon`` (a prewarm that far ahead would only be reaped again).
    """

    def __init__(self, min_samples: int = 3, max_samples: int = 512,
                 horizon: float = 300.0):
        self.min_samples = min_samples
        self.max_samples = max_samples
        self.horizon = horizon
        self._gaps: Dict[str, deque] = {}
        self._last: Dict[str, float] = {}
        self._lock = threading.Lock()

    def observe(self, fn: str, timestamp: float):
        with self._lock:
            last = self._last.get(fn)
            if last is not None and timestamp >= last:
                self._gaps.setdefault(
                    fn, deque(maxlen=self.max_samples)).append(
                        timestamp - last)
            self._last[fn] = timestamp

    def seed(self, fn: str, interarrivals: Sequence[float]):
        """Bulk-load gaps from an offline trace (HistoryPolicy's path)."""
        with self._lock:
            gaps = self._gaps.setdefault(fn, deque(maxlen=self.max_samples))
            gaps.extend(g for g in interarrivals if g >= 0)

    def interarrivals(self, fn: str) -> List[float]:
        with self._lock:
            return list(self._gaps.get(fn, ()))

    def predict(self, fn: str) -> Optional[Prediction]:
        with self._lock:
            gaps = list(self._gaps.get(fn, ()))
        if len(gaps) < self.min_samples:
            return None
        median = sorted(gaps)[len(gaps) // 2]
        if median <= 0 or median > self.horizon:
            return None
        mean = sum(gaps) / len(gaps)
        var = sum((g - mean) ** 2 for g in gaps) / len(gaps)
        cv = (var ** 0.5) / mean if mean > 0 else 0.0
        return Prediction(fn, 1.0 / (1.0 + cv), median)


class HybridPredictor:
    """Explicit chain knowledge when available, learned models otherwise.

    Chain successors come from ``graph`` (falling back to ``markov``);
    when a ``recurrence`` predictor is attached, the function's own next
    invocation is appended (unless a self-edge already predicted it) —
    so one ``successors`` call yields both chain prewarms and
    periodicity-driven self-prewarms."""

    def __init__(self, graph: Optional[ChainGraph] = None,
                 markov: Optional[MarkovPredictor] = None,
                 recurrence: Optional[RecurrencePredictor] = None):
        self.graph = graph or ChainGraph()
        self.markov = markov or MarkovPredictor()
        self.recurrence = recurrence

    def observe(self, fn: str, timestamp: float):
        self.markov.observe(fn, timestamp)
        if self.recurrence is not None:
            self.recurrence.observe(fn, timestamp)

    def successors(self, fn: str) -> List[Prediction]:
        preds = self.graph.successors(fn) or self.markov.successors(fn)
        if self.recurrence is not None:
            rec = self.recurrence.predict(fn)
            if rec is not None and all(p.fn != fn for p in preds):
                preds = preds + [rec]
        return preds
