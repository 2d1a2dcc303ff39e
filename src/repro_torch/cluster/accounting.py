"""ClusterAccountant — cluster-wide aggregation over per-shard ledgers.

Each ``ClusterWorker`` keeps its own ``Accountant`` so the cluster can
localize latency and cold starts to a shard; this module provides the
merged view.  Percentiles do not compose (a max of shard p95s is not the
cluster p95), so ``latency_summary`` merges the shards' raw sample
windows and re-ranks — the summary is exactly what one global Accountant
would have reported, while ``per_shard`` keeps the decomposition the
router and benchmarks use to see *where* the tail lives.

The ledger set is elastic, matching the fabric: ``attach`` admits a new
shard's accountant when the cluster grows, and ``retire`` moves a
departing shard's accountant into a *retained* set when the cluster
shrinks — its samples and bills keep counting in every merged view, so a
drain never loses history, while live-only views (``per_shard``) stop
showing the departed shard.
"""
from __future__ import annotations

from typing import List, Sequence

from repro_torch.core.accounting import Accountant, AppBill, _percentile_sorted


class ClusterAccountant:
    """Read-side merge of several shards' ``Accountant`` ledgers."""

    def __init__(self, accountants: Sequence[Accountant]):
        if not accountants:
            raise ValueError("need at least one shard accountant")
        self.accountants: List[Accountant] = list(accountants)
        self.retired: List[Accountant] = []

    # -- elastic membership ---------------------------------------------
    def attach(self, accountant: Accountant):
        """Admit a new shard's ledger (cluster grew)."""
        if accountant not in self.accountants:
            self.accountants.append(accountant)

    def retire(self, accountant: Accountant):
        """Move a departing shard's ledger to the retained set (cluster
        shrank): its history keeps counting in merged views but it no
        longer appears in per-shard decompositions."""
        if accountant in self.accountants:
            self.accountants.remove(accountant)
            if accountant not in self.retired:
                self.retired.append(accountant)

    def _all(self) -> List[Accountant]:
        return list(self.accountants) + list(self.retired)

    def apps(self) -> List[str]:
        apps = set()
        for acct in self._all():
            apps.update(acct.apps())
        return sorted(apps)

    def bill(self, app: str) -> AppBill:
        """Cluster-wide bill: every field summed across shards — live and
        retired (bills are additive — seconds, invocation counts, cold
        starts).  Reads via ``peek_bill`` so polling an unknown app never
        plants phantom entries in every shard's ledger."""
        total = AppBill()
        for acct in self._all():
            b = acct.peek_bill(app)
            total.function_seconds += b.function_seconds
            total.freshen_seconds += b.freshen_seconds
            total.freshen_invocations += b.freshen_invocations
            total.function_invocations += b.function_invocations
            total.mispredicted_freshens += b.mispredicted_freshens
            total.useful_freshens += b.useful_freshens
            # AppBill ledger aggregation, not a registry counter view
            total.cold_starts += b.cold_starts   # fabriclint: allow[counter]
            total.queue_seconds += b.queue_seconds
        return total

    def latency_summary(self, app: str) -> dict:
        """The same shape as ``Accountant.latency_summary`` (drop-in for
        HistoryPolicy.adapt and benchmark reporting), computed over the
        union of every shard's sample window — retired shards included."""
        lats: List[float] = []
        qds: List[float] = []
        for acct in self._all():
            lats.extend(acct.latency_samples(app))
            qds.extend(acct.queue_delay_samples(app))
        lats.sort()
        b = self.bill(app)
        return {
            "count": len(lats),
            "p50": _percentile_sorted(lats, 50),
            "p95": _percentile_sorted(lats, 95),
            "p99": _percentile_sorted(lats, 99),
            "max": lats[-1] if lats else 0.0,
            "mean_queue_delay": sum(qds) / len(qds) if qds else 0.0,
            "max_queue_delay": max(qds) if qds else 0.0,
            "cold_starts": b.cold_starts,
            "cold_start_rate": (b.cold_starts / b.function_invocations
                                if b.function_invocations else 0.0),
        }

    def per_shard(self, app: str) -> List[dict]:
        """Each *live* shard's own ``latency_summary`` in shard order —
        the view that shows which shard the tail (or the cold starts)
        lives on.  Departed shards' history stays in the merged views."""
        return [acct.latency_summary(app) for acct in list(self.accountants)]
