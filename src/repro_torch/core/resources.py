"""Freshen resource library (§3.2): the kinds of things freshen can fetch or
warm.  Each resource exposes the pieces a ``PlanEntry`` needs, plus the
tracing hooks used by §3.3 inference (``repro_torch.core.infer``).

The JAX-serving analogues (DESIGN.md §2):
  ConnectionResource   <- TCP establish/keepalive/warm
  DataResource         <- proactive data fetch into the freshen cache
  WeightResource       <- "re-downloading the model" -> checkpoint load
  CompileResource      <- cold start -> XLA jit compile
  WarmupResource       <- CWND warming -> dispatch/buffer warm-up execution
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

from repro_torch.core.freshen import Action, PlanEntry
from repro_torch.core.network import Connection


class ResourceBase:
    name: str
    action: Action
    constant_args: bool = True     # freshen only applies to constant args

    def plan_entry(self) -> PlanEntry:
        raise NotImplementedError


@dataclass
class ConnectionResource(ResourceBase):
    """Establish (if needed) and warm a connection (Algorithm 2 lines 4/7)."""
    name: str
    conn: Connection
    warm_bytes: float = 4 * 1024 * 1024
    action: Action = Action.WARM

    def do_warm(self):
        if self.conn.is_alive():
            self.conn.keepalive()
        else:
            self.conn.establish()
        self.conn.warm(self.warm_bytes)

    def plan_entry(self) -> PlanEntry:
        return PlanEntry(self.name, Action.WARM, self.do_warm)


@dataclass
class DataResource(ResourceBase):
    """Proactively fetchable data with constant (creds, id) arguments."""
    name: str
    fetch_fn: Callable[[], Any]
    ttl: Optional[float] = None
    version_fn: Optional[Callable[[], Any]] = None
    action: Action = Action.FETCH

    def plan_entry(self) -> PlanEntry:
        return PlanEntry(self.name, Action.FETCH, self.fetch_fn,
                         ttl=self.ttl, version_fn=self.version_fn)


@dataclass
class WeightResource(ResourceBase):
    """Model weights from the weight store; versioned (stale-model refresh)."""
    name: str
    load_fn: Callable[[], Any]
    version_fn: Optional[Callable[[], Any]] = None
    action: Action = Action.FETCH

    def plan_entry(self) -> PlanEntry:
        return PlanEntry(self.name, Action.FETCH, self.load_fn,
                         version_fn=self.version_fn)


@dataclass
class CompileResource(ResourceBase):
    """Proactive XLA compilation — the TPU cold start."""
    name: str
    compile_fn: Callable[[], Any]
    action: Action = Action.FETCH

    def plan_entry(self) -> PlanEntry:
        return PlanEntry(self.name, Action.FETCH, self.compile_fn)


@dataclass
class WarmupResource(ResourceBase):
    """Run a dummy execution to warm dispatch paths / allocator / autotune."""
    name: str
    warm_fn: Callable[[], Any]
    action: Action = Action.WARM

    def plan_entry(self) -> PlanEntry:
        return PlanEntry(self.name, Action.WARM, self.warm_fn)
