"""Quickstart: the freshen primitive end-to-end on a single function.

Reproduces the paper's Algorithm 1 (sample λ), Algorithm 2 (its freshen
function), and Algorithm 3 (the annotated λ with FrFetch/FrWarm), then shows
the three Figure-3 timings: freshen-before, freshen-concurrent, no-freshen.

The port's counterpart of ``examples/quickstart.py``: the same λ on the
port's copies of ``core/`` and ``serving/datastore.py``.  λ sums a list,
so nothing runs on ``--device``; it is resolved as the other drivers
resolve it.  The datastore is made in ``main``, not at import.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
# fabriclint: allow-file[clock] -- λ's latencies and the modeled fetch
# delay are wall-clock by design.
import argparse
import tempfile
import time

from repro_torch.core import (Connection, FreshenPlan, FunctionSpec, PlanEntry,
                              Runtime, TIERS)
from repro_torch.core.freshen import Action
from repro_torch.device import resolve_device
from repro_torch.serving import TieredDatastore


def make_lambda(datastore, put_conn):
    """λ over the external resources it touches (constant creds/ids ->
    freshenable); returns ``fresh_runtime``, which builds and initializes
    a runtime of λ."""

    def make_plan(runtime):
        """Algorithm 2: freshen for λ — index 0 = DataGet, index 1 = DataPut."""
        def fetch_model():                       # fr_state[0]
            value, modeled = datastore.get("model-v1")
            time.sleep(min(modeled, 0.2))        # surface the modeled latency
            return value

        def warm_put():                          # fr_state[1]
            if not put_conn.is_alive():
                put_conn.establish()
            put_conn.warm()
        return FreshenPlan([
            PlanEntry("DataGet", Action.FETCH, fetch_model, ttl=30.0,
                      version_fn=lambda: datastore.version("model-v1")),
            PlanEntry("DataPut", Action.WARM, warm_put),
        ])

    def lam(ctx, args):
        """Algorithm 3: the annotated λ."""
        t0 = time.monotonic()
        data = ctx.fr_fetch(0)                   # FrFetch(0, DataGet(...))
        result = sum(data["weights"]) + (args or 0)
        ctx.fr_warm(1)                           # FrWarm(1, DataPut(...))
        t_put = put_conn.transfer(2 * 2**20)     # send result (2MB)
        return {"result": result, "latency": time.monotonic() - t0,
                "put_modeled_s": t_put}

    def fresh_runtime():
        rt = Runtime(FunctionSpec("lambda", lam, plan_factory=make_plan))
        rt.init()
        return rt
    return fresh_runtime


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    # --- the external resources λ touches (constant creds/ids -> freshenable)
    root = tempfile.mkdtemp(prefix="quickstart-")
    datastore = TieredDatastore(root, tier="remote")
    datastore.put("model-v1", {"weights": list(range(1000))})
    put_conn = Connection(TIERS["remote"])
    fresh_runtime = make_lambda(datastore, put_conn)

    print("=== no freshen (cold path: fetch + connect inline) ===")
    rt = fresh_runtime()
    out = rt.run(1)
    print(f"  result={out['result']} latency={out['latency']*1e3:.1f}ms "
          f"put={out['put_modeled_s']*1e3:.1f}ms (cold cwnd)")
    print(f"  stats={rt.fr_state.stats()}")

    print("=== freshen-before (Fig 3 left) ===")
    rt = fresh_runtime()
    rt.freshen(blocking=True)                # platform predicted us early
    out = rt.run(1)
    print(f"  result={out['result']} latency={out['latency']*1e3:.1f}ms "
          f"put={out['put_modeled_s']*1e3:.1f}ms (warmed cwnd)")
    print(f"  stats={rt.fr_state.stats()}")

    print("=== freshen-concurrent (Fig 3 right: λ waits via FrWait) ===")
    rt = fresh_runtime()
    rt.freshen(blocking=False)               # prediction arrived late
    out = rt.run(1)
    rt.join_freshen()
    print(f"  result={out['result']} latency={out['latency']*1e3:.1f}ms")
    print(f"  stats={rt.fr_state.stats()}")

    print("=== runtime reuse + TTL: second run in same runtime is free ===")
    out2 = rt.run(2)
    print(f"  latency={out2['latency']*1e3:.1f}ms (cache hit)")
    print("=== new model version published -> staleness refetch ===")
    datastore.put("model-v1", {"weights": list(range(1000, 2000))})
    out3 = rt.run(3)
    print(f"  result={out3['result']} latency={out3['latency']*1e3:.1f}ms "
          f"(version-triggered refetch)")


if __name__ == "__main__":
    main()
