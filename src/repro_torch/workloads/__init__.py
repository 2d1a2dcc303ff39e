"""repro_torch.workloads — trace-driven workload replay for the freshen platform.

The paper's predictive opportunities (periodicity, chains, bursts) come
from *real invocation patterns*; this package closes the loop from traces
to platform policy:

* ``trace``   — the trace data model: Azure-Functions-format CSV loading
  (per-function minute-bucketed invocation counts + duration/memory
  percentiles) and synthetic archetype generators (periodic / bursty /
  rare) for tests and benchmarks.
* ``replay``  — ``TraceReplayer``: drives ``FreshenScheduler.submit`` /
  ``submit_chain`` open-loop from trace timestamps, with time scaling and
  an oracle prewarm mode.
* ``history`` — ``HistoryPolicy``: per-function inter-arrival histograms
  feeding (a) recurrence-based next-invocation prediction (prewarm
  timing) and (b) adaptive ``PoolConfig`` (keep-alive / max_instances
  from the observed idle-time distribution and cold-start rate).
* ``adapt``   — ``AdaptDaemon``: the adaptation loop as a background
  thread — periodic ``latency_summary`` snapshots through
  ``HistoryPolicy.adapt`` into live ``apply_pool_config``, per scheduler
  (or per cluster shard).
"""
from repro_torch.workloads.adapt import AdaptDaemon, FleetPolicy  # noqa: F401
from repro_torch.workloads.history import HistoryPolicy  # noqa: F401
from repro_torch.workloads.replay import ReplayReport, TraceReplayer  # noqa: F401
from repro_torch.workloads.trace import (FunctionProfile, InvocationEvent,  # noqa: F401
                                   Trace, load_azure_durations,
                                   load_azure_invocations)
