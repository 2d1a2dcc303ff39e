"""repro_torch.cluster — this slice carries only ``ClusterAccountant``
(a verbatim copy of the reference's ``cluster/accounting.py``), which
``ServingEngine.latency_summary`` uses.  The router and workers wait for
the placement slice (ROADMAP.md module item 7)."""
from repro_torch.cluster.accounting import ClusterAccountant  # noqa: F401
