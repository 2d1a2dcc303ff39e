"""repro_torch.cluster — the sharded multi-worker serving fabric.

One ``FreshenScheduler`` is a single scheduling domain: its pools share
one router and one accountant.  This package partitions the platform
into shards and puts the paper's freshen primitive where it matters at
scale — on the worker the router will actually pick:

* ``worker``     — ``ClusterWorker``: one shard = one FreshenScheduler +
  its pools, shard-tagged saturation errors, load/warmth signals, and
  optional pinning to a jax device slice (``mesh()`` for per-shard
  tensor parallelism via ``repro_torch.sharding.partitioning``).
* ``router``     — ``ClusterRouter`` with pluggable policies
  (``least-loaded`` / ``warmth-aware`` / ``sticky`` consistent-hash),
  cross-shard freshen propagation (prewarms land on the shard the
  routing decision selects), spill-on-saturation queue draining,
  ``rebalance()``, and elastic membership: ``add_worker`` /
  ``remove_worker(shard, drain=True)`` grow and shrink the fleet at
  runtime with warm-state draining (``DrainReport``).
* ``accounting`` — ``ClusterAccountant``: merged cluster-wide
  ``latency_summary`` (raw-sample merge, since percentiles do not
  compose) plus the per-shard decomposition; ``attach``/``retire``
  track elastic membership, folding departed shards into a retained
  ledger so summaries never lose history.
"""
from repro_torch.cluster.accounting import ClusterAccountant  # noqa: F401
from repro_torch.cluster.router import (POLICIES, ClusterRouter,  # noqa: F401
                                  DrainReport, LeastLoadedPolicy,
                                  StickyPolicy, WarmthAwarePolicy,
                                  make_policy, partition_devices)
from repro_torch.cluster.worker import ClusterWorker  # noqa: F401
