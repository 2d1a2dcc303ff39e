"""The rest of the serving fabric in the port, each piece driving a torch
endpoint on ``device="cpu"`` as the reference's own test drives a JAX
one:

* a ``TieredDatastore`` prefetch entry in an endpoint's freshen plan
  (``tests/test_serving.py::test_endpoint_cold_vs_freshened``), and its
  version making the entry stale;
* freshen inference, §3.3: a plan inferred from two traces runs the
  endpoint (``tests/test_system.py::test_inferred_plan_runs_real_endpoint``);
* ``ServingEngine.adopt_trace_policy`` retuning an endpoint's pool,
  seeding recurrence prediction and keeping the measured cold-start floor
  (``tests/test_workloads.py``'s two engine-adoption tests);
* ``TraceReplayer`` replaying a periodic trace into the endpoint with an
  oracle lead, so every freshen lands before its arrival.

One JAX init, published once by the JAX ``WeightStore``, gives the
weights; the port's store reads the same directory.  On the CPU the
port's "compile" costs next to nothing, so these tests assert the
freshen accounting and the outputs, not latency orderings.
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config  # noqa: E402
from repro.models import make_model as jax_make_model  # noqa: E402
from repro.serving import WeightStore as JaxWeightStore  # noqa: E402
from repro_torch.configs import get_config as port_get_config  # noqa: E402
from repro_torch.core import FunctionSpec, Runtime  # noqa: E402
from repro_torch.core.infer import (TraceCollector, analyze_traces,  # noqa: E402
                                    build_plan)
from repro_torch.serving import (Executor, ModelEndpoint,  # noqa: E402
                                 ServingEngine, TieredDatastore, WeightStore)
from repro_torch.workloads import HistoryPolicy, Trace, TraceReplayer  # noqa: E402

NAME, SEQ = "tiny", 8


def _cfg(get):
    return dataclasses.replace(get("qwen2-0.5b").reduced(d_model=128),
                               vocab_size=256, dtype="float32")


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    root = tmp_path_factory.mktemp("fabric")
    JaxWeightStore(str(root / "w")).publish(
        NAME, jax_make_model(_cfg(get_config)).init(jax.random.PRNGKey(0)))
    return WeightStore(str(root / "w"))


def _ep(store, **kw):
    kw.setdefault("batch_size", 1)
    return ModelEndpoint(NAME, _cfg(port_get_config), store, Executor(),
                         seq_len=SEQ, device="cpu", **kw)


def _toks(batch=1):
    return np.random.default_rng(0).integers(0, 256, (batch, SEQ)).astype(
        np.int32)


def test_datastore_prefetch_entry_cold_vs_freshened(store, tmp_path):
    """Freshen-before takes weights, the build, warm-up and the datastore
    prefetch off the invocation; a new datastore version makes the
    prefetched entry stale, so the next invoke fetches it again."""
    ds = TieredDatastore(str(tmp_path / "data"), tier="local")
    ds.put("embedding-table", {"v": 1})
    toks = _toks(2)
    eng, eng2 = ServingEngine(), ServingEngine()
    try:
        rt_cold = eng.deploy(_ep(store, batch_size=2, datastore=ds,
                                 prefetch_key="embedding-table"))
        out_cold = eng.invoke(NAME, toks, freshen_successors=False)
        assert rt_cold.fr_state.stats()["inline"] == 4
        assert out_cold["extra"] == {"v": 1}

        rt = eng2.deploy(_ep(store, batch_size=2, datastore=ds,
                             prefetch_key="embedding-table"))
        rt.freshen(blocking=True)
        out = eng2.invoke(NAME, toks, freshen_successors=False)
        st = rt.fr_state.stats()
        assert st["freshened"] == 4 and st["inline"] == 0
        assert out["extra"] == {"v": 1}
        np.testing.assert_array_equal(out_cold["logits"], out["logits"])
        assert out["logits"].shape == (2, 1, 256)
        gets = ds.get_count
        ds.put("embedding-table", {"v": 2})
        again = eng2.invoke(NAME, toks, freshen_successors=False)
        assert again["extra"] == {"v": 2} and ds.get_count == gets + 1
        assert rt.fr_state.stats()["inline"] == 1
    finally:
        eng.close()
        eng2.close()


def test_inferred_plan_runs_torch_endpoint(store, tmp_path):
    """§3.3: trace the function twice, infer the plan (constant-argument
    resources only), attach it, and the endpoint runs on what freshen
    fetched."""
    ds = TieredDatastore(str(tmp_path / "d"), tier="local")
    ds.put("lookup-table", {"t": 1})
    ep = _ep(store)
    col = TraceCollector()

    def traced_fn(user):
        col.record("get", "weights", ("creds", NAME))
        col.record("get", "compiled", ("shapes", (1, SEQ)))
        col.record("get", "lookup-table", ("creds", "lookup-table"))
        col.record("put", "results", ("creds", user))     # varying arg

    traces = []
    for user in ("u1", "u2"):
        col.begin()
        traced_fn(user)
        traces.append(col.end())
    thunks = {"weights": ep._load_weights, "compiled": ep._compile,
              "lookup-table": lambda: ds.get("lookup-table")[0]}
    plan = build_plan(analyze_traces(traces), thunks)
    assert [e.name for e in plan] == ["weights", "compiled", "lookup-table"]

    rt = Runtime(FunctionSpec(NAME, ep.code, plan_factory=lambda r: plan,
                              app="serving"))
    rt.init()
    rt.freshen(blocking=True)
    assert rt.fr_state.stats()["freshened"] == 3
    out = rt.run({"tokens": _toks()})
    assert rt.fr_state.stats()["inline"] == 0
    assert out["logits"].shape == (1, 1, 256)
    assert np.isfinite(out["logits"]).all()


def test_engine_adopt_trace_policy_retunes_pools_and_seeds_recurrence(store):
    eng = ServingEngine()
    try:
        eng.deploy(_ep(store))
        policy = HistoryPolicy().fit(
            Trace.periodic(NAME, period=2.0, invocations=8))
        applied = eng.adopt_trace_policy(policy, time_scale=0.5)
        assert set(applied) == {NAME}
        assert eng.scheduler.pool(NAME).config.keep_alive == pytest.approx(
            applied[NAME].keep_alive)
        # prime attached a recurrence predictor with scaled gaps
        pred = eng.scheduler.predictor.recurrence.predict(NAME)
        assert pred is not None and pred.expected_delay == pytest.approx(1.0)
        # functions the engine does not serve are left alone
        assert eng.adopt_trace_policy(HistoryPolicy().fit(
            Trace.periodic("absent", period=1.0, invocations=4))) == {}
    finally:
        eng.close()


def test_engine_adopt_trace_policy_passes_measured_cold_start_floor(store):
    eng = ServingEngine()
    try:
        eng.deploy(_ep(store))
        pool = eng.scheduler.pool(NAME)
        pool.measured_cold_start = lambda: 5.0    # as if boots took 5 s
        applied = eng.adopt_trace_policy(HistoryPolicy().fit(
            Trace.periodic(NAME, period=0.01, invocations=10)))
        assert applied[NAME].keep_alive >= 5.0
        assert eng.scheduler.pool(NAME).config.keep_alive >= 5.0
    finally:
        eng.close()


def test_trace_replay_oracle_freshens_land_before_arrivals(store):
    """A periodic trace replayed open loop with an oracle lead of 0.9 s:
    the prewarm ahead of the first arrival loads the weights, binds the
    step and warms it up, and no arrival runs or waits on a plan entry."""
    tr = Trace.periodic(NAME, period=1.0, invocations=3, phase=1.0)
    eng = ServingEngine()
    try:
        eng.deploy(_ep(store))
        toks = _toks()
        report = TraceReplayer(eng.scheduler, tr, time_scale=1.0,
                               oracle_lead=0.9,
                               args_fn=lambda ev: {"tokens": toks}
                               ).run(freshen=False)
        assert report.requests == 3 and report.prewarms == 3
        assert report.errors == 0 and report.skipped == 0
        pool = eng.scheduler.pool(NAME)
        st = pool.freshen_stats()
        assert st["freshened"] >= 3 and st["inline"] == 0
        assert st["waits"] == 0 and st["hits"] == 3 * 3
        assert pool.stats()["prewarm_dispatches"] >= 3
        assert eng.latency_summary("serving")["count"] == 3
    finally:
        eng.close()
