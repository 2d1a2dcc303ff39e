"""repro_torch.core — the paper's contribution: the freshen primitive and its
surrounding platform machinery (prediction, scheduling, accounting,
inference, triggers).  Model-agnostic; binds to JAX via repro_torch.serving."""
from repro_torch.core.accounting import (Accountant, AppBill, ServiceClass,  # noqa: F401
                                   percentile)
from repro_torch.core.backend import (BackendError, InstanceBackend,  # noqa: F401
                                SnapshotBackend, SubprocessBackend,
                                ThreadBackend, make_backend)
# NOTE: SnapshotTemplate is deliberately not re-exported here — the
# template process runs as ``python -m repro_torch.core.backend_template``, and
# importing the submodule from the package __init__ would double-execute
# it under runpy.  Import it from repro_torch.core.backend_template directly.
from repro_torch.core.cache import FreshenCache  # noqa: F401
from repro_torch.core.pool import (AcquireWaiter, InstancePool,  # noqa: F401
                             InstanceState, PoolConfig, PooledInstance,
                             PoolSaturated)
from repro_torch.core.freshen import (Action, FreshenPlan, FreshenState, FrState,  # noqa: F401
                                PlanEntry)
from repro_torch.core.network import TIERS, Connection, Tier  # noqa: F401
from repro_torch.core.prediction import (ChainGraph, HybridPredictor,  # noqa: F401
                                   MarkovPredictor, Prediction,
                                   RecurrencePredictor)
from repro_torch.core.runtime import (FunctionSpec, RunContext, Runtime,  # noqa: F401
                                WarmthLevel)
from repro_torch.core.scheduler import (FreshenScheduler, UnknownFunction,  # noqa: F401
                                  WarmthPolicy)
