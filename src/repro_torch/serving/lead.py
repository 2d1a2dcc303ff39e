"""A warm instance held until a predicted arrival that outlasts keep-alive.

The reference's ``FreshenScheduler`` prewarms the moment it predicts.  A
timer predicted 15 s ahead behind a 5 s keep-alive is warmed at once,
onto the instance serving the tick that made the prediction, and the
next tick's keep-alive sweep reaps that instance, so the tick starts
cold.  ``LeadScheduler`` keeps the copied scheduler and adds a hold:

* A prediction whose ``expected_delay`` exceeds the idle limit of the
  target pool's rung (``keep_alive``, or in graded mode the rung's own
  limit), and which the accountant's gate lets through, holds the
  pool's ``prewarm_fanout`` most recent instances against reaping and
  graded demotion until ``arrival + limit``: the predicted arrival
  (admission time plus ``expected_delay``) counts as their use, so a
  tick later than predicted still finds them.  After that the normal
  keep-alive from each instance's last use applies.  A newer prediction
  holds until its own arrival.
* The hold comes before the copied dispatch, so the prewarm's own
  keep-alive sweep spares an expired instance that is still resident
  and warms it where it is.
* Shorter predictions, and any the gate refuses, take the copied
  dispatch alone.

Pools reap lazily (only inside ``acquire`` and ``prewarm_freshen``) and a
reaped instance's device memory waits for a full garbage collection, so
an expired timer instance stays resident until its next tick either
way; the hold only stops that tick from reaping it and loading the same
plan again.  A dispatch timed to the arrival, which provisions when the
pool has truly scaled to zero, waits for eager reaping.

Counters, in the scheduler's registry: ``freshen.held`` (predictions
that placed a hold); each pool counts ``hold_skipped_reaps``.

``ServingEngine`` builds this scheduler when it is given none; the
fabric's shards keep the copied one.
"""
from __future__ import annotations

import time
from dataclasses import replace
from typing import Callable, List, Optional, Tuple

from repro_torch.core.backend import make_backend
from repro_torch.core.pool import InstancePool
from repro_torch.core.prediction import Prediction
from repro_torch.core.runtime import FunctionSpec, Runtime, WarmthLevel
from repro_torch.core.scheduler import FreshenScheduler


class HoldingPool(InstancePool):
    """An ``InstancePool`` that a hold keeps from shrinking below a count
    until a deadline: while ``hold(count, until)`` lasts, keep-alive
    neither reaps nor demotes the ``count`` live instances most recently
    put on the idle stack (busy ones count toward it).  After ``until``
    the normal keep-alive from each instance's last use applies."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._holds: List[Tuple[float, int]] = []     # (until, count)
        self._c_held = self.metrics.counter("hold_skipped_reaps")

    def idle_limit(self, level: WarmthLevel) -> float:
        """How long an idle instance warmed to ``level`` survives."""
        if self.config.graded_warmth:
            return self._keep_alive_for(level)
        return self.config.keep_alive

    def hold(self, count: int, until: float) -> None:
        with self._cond:
            self._holds.append((until, count))

    def _expired_locked(self, inst, now: float) -> bool:
        """Whether the copied sweep would reap or demote ``inst``."""
        if inst.runtime.freshen_in_flight():
            return False
        if self.config.graded_warmth:
            idle_for = now - max(inst.last_used, inst.level_since)
            return idle_for > self._keep_alive_for(inst.runtime.warmth)
        return now - inst.last_used > self.config.keep_alive

    def reap(self, now: Optional[float] = None) -> int:
        """The copied sweep, with the held instances shown to it as used
        at ``now`` and their last use restored after it (unless a release
        or a prewarm set a newer one meanwhile)."""
        now = self.clock() if now is None else now
        shielded = []
        with self._cond:
            self._holds = [h for h in self._holds if now < h[0]]
            need = max((n for _, n in self._holds), default=0) \
                - (len(self._instances) - len(self._idle))
            for inst in self._idle[-need:] if need > 0 else ():
                if self._expired_locked(inst, now):
                    shielded.append((inst, inst.last_used))
                    inst.last_used = now
            self._c_held.inc(len(shielded))
        try:
            return super().reap(now)
        finally:
            if shielded:
                with self._cond:
                    for inst, last_used in shielded:
                        if inst.last_used == now:
                            inst.last_used = last_used


class LeadScheduler(FreshenScheduler):
    """``FreshenScheduler`` whose long-range predictions hold the warm
    instance until their arrival (module docstring)."""

    def __init__(self, *args, clock: Callable[[], float] = time.monotonic,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.clock = clock
        self._m_held = self.metrics.counter("freshen.held")

    def register(self, spec: FunctionSpec, runtime: Optional[Runtime] = None,
                 scope_group: Optional[str] = None, config=None,
                 backend: Optional[str] = None) -> Runtime:
        """The copied ``register``, building a ``HoldingPool`` on the
        scheduler's clock."""
        cfg = config or replace(self.pool_config)
        if backend is not None and backend != cfg.backend:
            cfg = replace(cfg, backend=backend)
        if scope_group is not None and cfg.backend != "thread":
            raise ValueError(
                f"scope_group {scope_group!r} shares in-process state and "
                f"requires the thread backend, not {cfg.backend!r}")

        def factory() -> Runtime:
            rt = Runtime(spec, cold_start_cost=cfg.cold_start_cost,
                         backend=make_backend(cfg.backend))
            self._join_scope(rt, scope_group)
            return rt

        pool = HoldingPool(spec, cfg, runtime_factory=factory,
                           clock=self.clock)
        if runtime is not None:
            self._join_scope(runtime, scope_group)
            pool.adopt(runtime)
        else:
            pool.adopt(factory())
        with self._lock:
            self.pools[spec.name] = pool
        return pool.primary

    def on_invocation_start(self, fn: str, now: Optional[float] = None):
        now = self.clock() if now is None else now
        self.predictor.observe(fn, now)
        for pred in self.predictor.successors(fn):
            self._hold_for(pred, now)
            self._dispatch_freshen(pred)

    def _hold_for(self, pred: Prediction, now: float) -> None:
        """Hold ``pred``'s pool until its arrival when nothing idle from
        now would live to it and the accountant's gate lets it through."""
        pool = self.pools.get(pred.fn)
        if self.freshen_route is not None or pool is None:
            return
        level = (WarmthLevel.HOT if self.warmth_policy is None
                 else self.warmth_policy.target_level(pred.probability))
        limit = pool.idle_limit(level)
        if pred.expected_delay <= limit or not self.accountant.should_freshen(
                pool.spec.app, pred.probability):
            return
        pool.hold(pool.config.prewarm_fanout,
                  now + pred.expected_delay + limit)
        self._m_held.inc()
