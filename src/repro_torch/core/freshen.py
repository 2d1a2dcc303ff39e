"""The ``freshen`` primitive — faithful implementation of the paper's
Algorithms 2–5.

``FreshenState`` is the runtime-scoped ordered list ``fr_state``.  Each entry
carries ``{state, result, ttl, timestamp, version}`` (§3.3).  The wrapper
functions ``fr_fetch`` (Algorithm 4) and ``fr_warm`` (Algorithm 5) arbitrate
the three cases of Figure 3:

* freshen already FINISHED   -> use the prefetched/warmed resource,
* freshen RUNNING            -> ``FrWait`` until it finishes,
* freshen never ran / lost   -> do the work inline (correctness never
                                depends on prediction).

``freshen()`` itself is Algorithm 2: it walks the plan in resource order and
performs each fetch/warm, skipping entries the function already claimed
("Not included for brevity in Algorithm 2 are the checks to see if the
resources have already been freshened by wrapper functions invoked by λ" —
we include them).  It is invoked in a separate thread by the runtime
(§3.1: non-blocking, run-hook timing unmodified) and, per the abuse rule,
receives NO function arguments.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Callable, List, Optional, Sequence


class FrState(Enum):
    IDLE = "idle"
    RUNNING = "running"
    FINISHED = "finished"


class Action(Enum):
    FETCH = "fetch"
    WARM = "warm"


@dataclass
class PlanEntry:
    """One ordered freshen resource (index = position in fr_state)."""
    name: str
    action: Action
    # FETCH: thunk returning the value.  WARM: thunk performing the warm.
    thunk: Callable[[], Any]
    ttl: Optional[float] = None
    version_fn: Optional[Callable[[], Any]] = None   # freshness via versions


class FreshenPlan:
    """Ordered resources for one function (Algorithm 2's iteration order)."""

    def __init__(self, entries: Sequence[PlanEntry]):
        self.entries: List[PlanEntry] = list(entries)

    def __len__(self):
        return len(self.entries)

    def __iter__(self):
        return iter(self.entries)


@dataclass
class _Entry:
    state: FrState = FrState.IDLE
    result: Any = None
    timestamp: float = 0.0
    version: Any = None
    error: Optional[BaseException] = None
    freshen_count: int = 0        # times freshen (the hook) did the work
    inline_count: int = 0         # times the wrapper did the work inline
    wait_count: int = 0           # times the wrapper had to FrWait
    hit_count: int = 0            # times a FINISHED result was consumed
    cond: threading.Condition = field(default_factory=threading.Condition)


class FreshenState:
    """fr_state — runtime-scoped, thread-safe."""

    def __init__(self, plan: FreshenPlan, clock: Callable[[], float] = time.monotonic):
        self.plan = plan
        self.clock = clock
        self.entries = [_Entry() for _ in plan.entries]

    # ------------------------------------------------------------------
    def _is_stale(self, idx: int) -> bool:
        e = self.entries[idx]
        pe = self.plan.entries[idx]
        if e.state is not FrState.FINISHED:
            return False
        if pe.ttl is not None and (self.clock() - e.timestamp) > pe.ttl:
            return True
        if pe.version_fn is not None and e.version != pe.version_fn():
            return True
        return False

    def _claim(self, idx: int) -> bool:
        """Atomically IDLE->RUNNING (also reclaims stale FINISHED entries)."""
        e = self.entries[idx]
        with e.cond:
            if e.state is FrState.RUNNING:
                return False
            if e.state is FrState.FINISHED and not self._is_stale(idx):
                return False
            e.state = FrState.RUNNING
            e.error = None
            return True

    def _execute(self, idx: int, by_freshen: bool,
                 thunk: Optional[Callable[[], Any]] = None) -> Any:
        e = self.entries[idx]
        pe = self.plan.entries[idx]
        try:
            result = (thunk or pe.thunk)()
            err = None
        except BaseException as exc:        # freshen failure is never fatal
            result, err = None, exc
        with e.cond:
            if err is None:
                e.result = result
                e.timestamp = self.clock()
                e.version = pe.version_fn() if pe.version_fn else None
                e.state = FrState.FINISHED
                if by_freshen:
                    e.freshen_count += 1
                else:
                    e.inline_count += 1
            else:
                e.error = err
                e.state = FrState.IDLE       # allow inline retry
            e.cond.notify_all()
        if err is not None and not by_freshen:
            raise err
        return result

    def fr_wait(self, idx: int, timeout: Optional[float] = None):
        """Algorithm 4/5 line 6: block until the in-flight freshen finishes."""
        e = self.entries[idx]
        with e.cond:
            e.wait_count += 1
            deadline = None if timeout is None else time.monotonic() + timeout
            while e.state is FrState.RUNNING:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    break
                e.cond.wait(remaining)

    # ------------------------------------------------------------------
    # Algorithm 4
    def fr_fetch(self, idx: int, code: Optional[Callable[[], Any]] = None) -> Any:
        e = self.entries[idx]
        with e.cond:
            state = e.state
            stale = self._is_stale(idx)
        if state is FrState.FINISHED and not stale:            # line 3-4
            with e.cond:
                e.hit_count += 1
                return e.result
        if state is FrState.RUNNING:                            # line 5-7
            self.fr_wait(idx)
            with e.cond:
                if e.state is FrState.FINISHED:
                    e.hit_count += 1
                    return e.result
            # freshen failed -> fall through to inline execution
        if self._claim(idx):                                    # line 8-12
            return self._execute(idx, by_freshen=False, thunk=code)
        # lost the race: someone else claimed — wait and return theirs
        self.fr_wait(idx)
        with e.cond:
            if e.state is FrState.FINISHED:
                e.hit_count += 1
                return e.result
        # claimed executor failed; run inline unconditionally
        thunk = code if code is not None else self.plan.entries[idx].thunk
        return thunk()

    # Algorithm 5
    def fr_warm(self, idx: int, resource_warm: Optional[Callable[[], Any]] = None) -> None:
        e = self.entries[idx]
        with e.cond:
            state = e.state
            stale = self._is_stale(idx)
        if state is FrState.FINISHED and not stale:            # line 3-4
            with e.cond:
                e.hit_count += 1
            return
        if state is FrState.RUNNING:                            # line 5-7
            self.fr_wait(idx)
            return
        if self._claim(idx):                                    # line 8-12
            self._execute(idx, by_freshen=False, thunk=resource_warm)
            return
        self.fr_wait(idx)

    # ------------------------------------------------------------------
    # Algorithm 2 — run by the runtime in a separate thread.
    def freshen(self) -> dict:
        """Walk the plan; fetch/warm anything not already fresh.  Returns
        stats.  NEVER raises (failure to freshen is not fatal)."""
        done = skipped = failed = 0
        for idx in range(len(self.plan)):
            if self._claim(idx):
                self._execute(idx, by_freshen=True)
                if self.entries[idx].error is None:
                    done += 1
                else:
                    failed += 1
            else:
                skipped += 1
        return {"done": done, "skipped": skipped, "failed": failed}

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        return {
            "freshened": sum(e.freshen_count for e in self.entries),
            "inline": sum(e.inline_count for e in self.entries),
            "waits": sum(e.wait_count for e in self.entries),
            "hits": sum(e.hit_count for e in self.entries),
        }

    def invalidate(self, idx: Optional[int] = None):
        idxs = range(len(self.entries)) if idx is None else [idx]
        for i in idxs:
            e = self.entries[i]
            with e.cond:
                if e.state is not FrState.RUNNING:
                    e.state = FrState.IDLE
                    e.result = None
