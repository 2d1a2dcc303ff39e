"""The port's sharded fabric on the CPU: ``repro_torch.cluster`` (the
router is a verbatim copy, the worker a port of its device half) and
``ServingEngine``'s sharded and elastic deploys.

* The reference's routing tests (``tests/test_cluster.py``,
  ``tests/test_cluster_elastic.py``) on stub specs built from
  ``repro_torch.core``: the policies, sticky determinism and remapping,
  cross-shard freshen placement, spill, rebalance, add/remove worker
  with drain, ``partition_devices`` over ``torch.device``s and the
  engine wiring.
* A pinned worker runs every hook of a function under its shard's
  ``torch.cuda.device`` (recorded here through a stand-in), and a shard
  pinned to the CPU makes no such call.
* K1 and K3 make a CUDA runtime call before they encode a tensor map:
  the fabric runs model bodies on pool and router threads.
* A reduced float32 qwen2 endpoint on ``device="cpu"``, deployed with
  ``shards=2`` and elastically scaled 1 -> 3 -> 1: its logits equal the
  single-scheduler endpoint's bit for bit and the JAX engine's within
  1e-4.  One JAX init, published once; the port's store reads the same
  directory.

Timing constants keep every stub test well under a second of wall time.
"""
import dataclasses
import threading
import time

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config  # noqa: E402
from repro.models import make_model as jax_make_model  # noqa: E402
from repro.serving import Executor as JaxExecutor  # noqa: E402
from repro.serving import ModelEndpoint as JaxEndpoint  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro.serving import WeightStore as JaxWeightStore  # noqa: E402
from repro_torch.cluster import (POLICIES, ClusterRouter,  # noqa: E402
                                 ClusterWorker, LeastLoadedPolicy,
                                 StickyPolicy, WarmthAwarePolicy, make_policy,
                                 partition_devices)
from repro_torch.configs import get_config as port_get_config  # noqa: E402
from repro_torch.core import (FunctionSpec, PoolConfig,  # noqa: E402
                              Prediction, ServiceClass)
from repro_torch.core.freshen import Action, FreshenPlan, PlanEntry  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serving import (Executor, ModelEndpoint,  # noqa: E402
                                 ServingEngine, WeightStore)

APP = "torchcluster"


def make_spec(name, fetch_cost=0.0, compute=0.0, app=APP):
    def make_plan(rt):
        def fetch():
            if fetch_cost:
                time.sleep(fetch_cost)
            return {"resource": name}
        return FreshenPlan([PlanEntry("data", Action.FETCH, fetch)])

    def code(ctx, args):
        data = ctx.fr_fetch(0)
        if compute:
            time.sleep(compute)
        return data["resource"]

    return FunctionSpec(name, code, plan_factory=make_plan, app=app)


def _latency_sensitive(acct):
    acct.service_class[APP] = ServiceClass.LATENCY_SENSITIVE
    acct.disable_after = 10 ** 9
    return acct


def build_cluster(shards, policy, *, cross_freshen=True, spill_timeout=None,
                  **pool_kw):
    cluster = ClusterRouter.build(shards, policy=policy,
                                  pool_config=PoolConfig(**pool_kw),
                                  spill_timeout=spill_timeout,
                                  cross_freshen=cross_freshen)
    from repro_torch.core import Accountant
    cluster.accountant_factory = lambda: _latency_sensitive(Accountant())
    for w in cluster.workers:
        _latency_sensitive(w.scheduler.accountant)
    return cluster


def _wait(cond, timeout=2.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.005)
    return cond()


class _W:
    """What a policy reads of a worker."""

    def __init__(self, shard_id, load=0, warmth=0.0):
        self.shard_id, self._load, self._warmth = shard_id, load, warmth

    def load(self, fn=None):
        return self._load

    def warmth_weight(self, fn):
        return self._warmth


# ---------------------------------------------------------------------------
# routing policies
@pytest.mark.parametrize("name,cls", [("least-loaded", LeastLoadedPolicy),
                                      ("warmth-aware", WarmthAwarePolicy),
                                      ("sticky", StickyPolicy),
                                      ("random", None)])
def test_make_policy_by_name(name, cls):
    if cls is None:
        with pytest.raises(ValueError, match="unknown routing policy"):
            make_policy(name)
        return
    assert isinstance(make_policy(name), cls) and POLICIES[name] is cls
    policy = cls()
    assert make_policy(policy) is policy


def test_least_loaded_spreads_ties_and_warmth_aware_prefers_warmth():
    ll = LeastLoadedPolicy()
    assert ll.select("f", [_W(0, load=3), _W(1, load=1), _W(2, load=2)]) == 1
    # ties spread round-robin instead of funneling onto shard 0
    assert {ll.select("f", [_W(0), _W(1)]) for _ in range(4)} == {0, 1}
    wa = WarmthAwarePolicy()
    # the warmest shard wins over a less loaded cold one; among equally
    # warm shards the least loaded, then the lowest id
    assert wa.select("f", [_W(0), _W(1, load=5, warmth=1.0)]) == 1
    assert wa.select("f", [_W(0, 2, 1.0), _W(1, 1, 1.0), _W(2, 1, 0.3)]) == 1
    assert wa.select("f", [_W(3, 0, 1.0), _W(4, 0, 1.0)]) == 3
    # no warmth anywhere: least-loaded
    assert wa.select("f", [_W(0, load=2), _W(1, load=0)]) == 1


def test_sticky_routing_is_deterministic():
    cluster = build_cluster(4, "sticky")
    try:
        fns = [f"fn-{i}" for i in range(40)]
        for fn in fns:
            cluster.register(make_spec(fn))
        first = {fn: cluster.route(fn) for fn in fns}
        # stable across repeated calls and across a fresh policy instance
        assert first == {fn: cluster.route(fn) for fn in fns}
        cluster.policy = StickyPolicy()
        assert first == {fn: cluster.route(fn) for fn in fns}
        assert len(set(first.values())) >= 3
    finally:
        cluster.shutdown()


@pytest.mark.parametrize("before,after", [((0, 1, 2, 3), (0, 1, 2, 3, 4)),
                                          ((0, 1, 2, 3, 4), (0, 1, 3, 4))])
def test_sticky_remaps_only_the_changed_shards_keys(before, after):
    """Consistent hashing: growing moves only keys onto the new shard,
    shrinking only the departed shard's keys."""
    policy = StickyPolicy()
    fns = [f"endpoint-{i}" for i in range(300)]
    a = {fn: policy.select(fn, [_W(k) for k in before]) for fn in fns}
    b = {fn: policy.select(fn, [_W(k) for k in after]) for fn in fns}
    moved = [fn for fn in fns if a[fn] != b[fn]]
    assert 0 < len(moved) < len(fns) * 0.45
    (changed,) = set(before) ^ set(after)
    side = b if changed in after else a
    assert all(side[fn] == changed for fn in moved)


# ---------------------------------------------------------------------------
# cross-shard freshen placement, spill, rebalance
@pytest.mark.parametrize("cross", [True, False])
def test_freshen_lands_on_the_routed_shard(cross):
    """Shard 1 holds the warmth, so arrivals route there; a prediction
    firing on shard 0 is placed on shard 1 too, unless cross-shard
    freshen is off."""
    cluster = build_cluster(2, "warmth-aware", cross_freshen=cross,
                            max_instances=2, keep_alive=60.0,
                            prewarm_provision=True)
    try:
        cluster.register(make_spec("fn"))
        w0, w1 = cluster.worker(0), cluster.worker(1)
        for th in w1.prewarm("fn", provision=True):
            th.join()
        assert w1.warm_idle("fn") == 1 and cluster.route("fn") == 1
        before = w1.pool("fn").stats()["prewarm_dispatches"]
        w0.scheduler._dispatch_freshen(Prediction("fn", probability=1.0,
                                                  expected_delay=0.05))
        stats = cluster.stats()
        if cross:
            assert stats["cross_freshens"] == 1
            assert w1.pool("fn").stats()["prewarm_dispatches"] == before + 1
            assert w0.pool("fn").stats()["prewarm_dispatches"] == 0
            assert w0.scheduler.events[-1].reason == "routed-cross-shard"
            # the freshen and the next arrival meet on one shard
            assert cluster.route("fn") == 1
        else:
            assert stats["cross_freshens"] == 0
            assert w0.pool("fn").stats()["prewarm_dispatches"] == 1
    finally:
        cluster.shutdown()


def test_spill_drains_saturated_shard_to_neighbor():
    cluster = build_cluster(2, "sticky", spill_timeout=0.03,
                            max_instances=1, keep_alive=60.0)
    try:
        cluster.register(make_spec("slow", compute=0.08))
        hot = cluster.route("slow")
        futures = [cluster.submit("slow") for _ in range(4)]
        assert [f.result(timeout=10.0) for f in futures] == ["slow"] * 4
        stats = cluster.stats()
        assert stats["spills"] >= 1 and stats["saturations"][hot] >= 1
        neighbor = cluster.worker(1 - hot).pool("slow").stats()
        assert neighbor["cold_starts"] + neighbor["warm_acquires"] >= 1
    finally:
        cluster.shutdown()


def test_rebalance_pushes_warmth_to_idle_neighbor():
    cluster = build_cluster(2, "sticky", max_instances=1, keep_alive=60.0,
                            prewarm_provision=True)
    try:
        cluster.register(make_spec("slow", compute=0.15))
        hot = cluster.route("slow")
        cold = 1 - hot
        blocker = cluster.submit("slow")
        waiter = threading.Thread(
            target=lambda: cluster.worker(hot).invoke("slow"), daemon=True)
        waiter.start()
        assert _wait(lambda: cluster.worker(hot).queue_depth("slow") > 0)
        assert ("slow", hot, cold) in cluster.rebalance()
        assert cluster.worker(cold).pool("slow").stats()[
            "prewarm_dispatches"] >= 1
        assert _wait(lambda: cluster.worker(cold).warm_idle("slow") == 1)
        blocker.result(timeout=5.0)
        waiter.join(timeout=5.0)
    finally:
        cluster.shutdown()


# ---------------------------------------------------------------------------
# elastic membership
def test_add_worker_replays_registrations_and_routes():
    cluster = build_cluster(1, "least-loaded", max_instances=2,
                            keep_alive=60.0)
    try:
        cluster.register(make_spec("fn"))
        cluster.register(make_spec("edge"), shards=[0])
        added = cluster.add_worker()
        assert added.shard_id == 1 and added.has_function("fn")
        assert not added.has_function("edge")    # subsets stay on their subset
        assert added.scheduler.predictor is cluster.predictor
        futures = [cluster.submit("fn") for _ in range(4)]
        assert [f.result(timeout=5.0) for f in futures] == ["fn"] * 4
        assert cluster.stats()["added"] == 1
    finally:
        cluster.shutdown()


def test_remove_worker_drain_loses_no_inflight_and_hands_off_warmth():
    cluster = build_cluster(2, "sticky", max_instances=1, keep_alive=60.0,
                            prewarm_provision=True)
    try:
        cluster.register(make_spec("slow", compute=0.05))
        hot = cluster.route("slow")
        survivor = 1 - hot
        futures = [cluster.submit("slow") for _ in range(4)]
        _wait(lambda: cluster.worker(hot).load() >= 2)
        worker = cluster.worker(hot)
        report = cluster.remove_worker(hot, drain=True)
        assert [f.result(timeout=5.0) for f in futures] == ["slow"] * 4
        assert report.shard == hot and report.drained
        assert report.inflight_at_removal >= 1
        assert ("slow", survivor) in report.handoffs
        assert _wait(lambda: cluster.worker(survivor).warm_idle("slow") >= 1)
        assert cluster.route("slow") == survivor
        assert cluster.invoke("slow") == "slow"
        with pytest.raises(RuntimeError, match="draining"):
            worker.submit("slow")
        with pytest.raises(KeyError):
            cluster.worker(hot)
        # ids are never reused
        assert cluster.add_worker().shard_id == 2
    finally:
        cluster.shutdown()


# ---------------------------------------------------------------------------
# devices
def test_partition_devices_over_torch_devices():
    cards = [torch.device("cuda", i) for i in range(5)]
    assert partition_devices(None, 3) == [None, None, None]
    assert partition_devices(cards, 2) == [cards[0::2], cards[1::2]]
    # one card for two shards: one shard pinned, the other on the default
    assert partition_devices(cards[:1], 2) == [[cards[0]], None]
    cluster = ClusterRouter.build(3, devices=cards[:3])
    try:
        assert [w.devices for w in cluster.workers] == [[c] for c in cards[:3]]
    finally:
        cluster.shutdown()


class _PinRecorder:
    """Stands in for ``torch.cuda.device``: records, per thread, which
    device the code inside it was pinned to."""

    local = threading.local()

    def __init__(self, device):
        self.device = torch.device(device)

    def __enter__(self):
        self.local.stack = getattr(self.local, "stack", []) + [self.device]

    def __exit__(self, *exc):
        self.local.stack = self.local.stack[:-1]

    @classmethod
    def current(cls):
        stack = getattr(cls.local, "stack", [])
        return stack[-1] if stack else None


def _recording_spec(seen):
    cur = _PinRecorder.current

    def init_fn(rt):
        seen["init"] = cur()

    def plan(rt):
        seen["plan"] = cur()
        return FreshenPlan([PlanEntry(
            "data", Action.FETCH,
            lambda: seen.setdefault("thunks", []).append(cur()) or 7)])

    def code(ctx, args):
        seen["code"] = cur()
        return ctx.fr_fetch(0)

    return FunctionSpec("pinned", code, plan_factory=plan, app=APP,
                        init_fn=init_fn)


@pytest.mark.parametrize("device", ["cuda:1", "cpu"])
def test_pinned_worker_runs_every_hook_under_its_device(device, monkeypatch):
    """init_fn, the plan build, a freshen thread's thunk and the body
    all run under the shard's ``torch.cuda.device``; a CPU shard makes no
    call at all."""
    if device == "cpu":
        def refuse(*a, **k):
            raise AssertionError("a CPU shard called torch.cuda.device")
        monkeypatch.setattr(torch.cuda, "device", refuse)
    else:
        monkeypatch.setattr(torch.cuda, "device", _PinRecorder)
    worker = ClusterWorker(0, devices=[torch.device(device)])
    seen = {}
    try:
        rt = worker.register(_recording_spec(seen))
        rt.init()
        rt.freshen(blocking=True)
        assert worker.invoke("pinned") == 7
    finally:
        worker.shutdown()
    want = torch.device(device) if device != "cpu" else None
    assert seen["init"] == seen["plan"] == seen["code"] == want
    assert seen["thunks"] == [want]


def test_pinned_worker_needs_the_thread_backend_and_has_no_mesh():
    """A pinned shard takes only the thread backend.  Its mesh is a torch
    ``DeviceMesh``: a slice of two cards with no process group spanning
    them has none, and the error says why (one process per device); an
    unpinned shard has none either."""
    worker = ClusterWorker(3, devices=[torch.device("cuda", 0)])
    pair = ClusterWorker(4, devices=[torch.device("cuda", 0),
                                     torch.device("cuda", 1)])
    try:
        for backend in ("subprocess", "snapshot"):
            with pytest.raises(ValueError, match="thread backend"):
                worker.register(make_spec("fn"), backend=backend)
        with pytest.raises(RuntimeError, match="one process per device"):
            pair.mesh()
        with pytest.raises(ValueError, match="no pinned devices"):
            ClusterWorker(5).mesh()
    finally:
        worker.shutdown()
        pair.shutdown()


@pytest.mark.parametrize("kernel,launch", [
    ("flash_attention", "cudaError_t launch_bf16("),
    ("rglru_scan", "cudaError_t launch(")])
def test_kernel_binds_the_threads_context_before_encoding(kernel, launch):
    """A pool or router thread may reach K1 or K3 first thing, and
    ``cuTensorMapEncodeTiled`` fails in a thread with no current context:
    a runtime call comes first."""
    src = (ops.CSRC / ops.MODULES[kernel].SOURCE).read_text()
    body = src[src.index(launch):]
    assert body.index("cudaFuncSetAttribute") < body.index("encode_map(")


# ---------------------------------------------------------------------------
# ServingEngine wiring
class _StubEndpoint:
    """Duck-typed endpoint: ServingEngine only needs .name and .spec()."""

    def __init__(self, name):
        self.name = name

    def spec(self):
        return make_spec(self.name, app="serving-cluster")


def test_engine_deploy_shards_routes_through_cluster():
    eng = ServingEngine()
    try:
        eng.deploy(_StubEndpoint("sharded"), pool_config=PoolConfig(
            max_instances=2, keep_alive=60.0), shards=2)
        assert eng.cluster is not None and eng.cluster.num_shards == 2
        # cluster workers share the engine predictor: chain() keeps working
        assert eng.cluster.predictor is eng.scheduler.predictor
        assert eng.submit("sharded", tokens=None).result(timeout=5.0) == \
            "sharded"
        assert eng.latency_summary("serving-cluster")["count"] == 1
        stats = eng.platform_stats()
        assert "shard0/sharded" in stats and "shard1/sharded" in stats
        assert any(k.startswith("cluster.") for k in eng.metrics_snapshot())
        with pytest.raises(ValueError, match="widest endpoint first"):
            eng.deploy(_StubEndpoint("wider"), shards=4)
    finally:
        eng.close()


def test_engine_adopts_a_trace_policy_on_every_shard():
    from repro_torch.workloads import HistoryPolicy, Trace
    eng = ServingEngine()
    try:
        eng.deploy(_StubEndpoint("periodic"), pool_config=PoolConfig(
            max_instances=2, keep_alive=60.0), shards=2)
        policy = HistoryPolicy().fit(
            Trace.periodic("periodic", period=1.0, invocations=8))
        applied = eng.adopt_trace_policy(policy)
        want = applied["periodic"]
        for w in eng.cluster.workers:
            cfg = w.pool("periodic").config
            assert (cfg.keep_alive, cfg.max_instances) == \
                (want.keep_alive, want.max_instances)
    finally:
        eng.close()


# ---------------------------------------------------------------------------
# a reduced qwen2 endpoint on the fabric
NAME, B, SEQ, N_PROMPTS = "tiny", 2, 8, 4


def _cfg(get):
    return dataclasses.replace(get("qwen2-0.5b").reduced(d_model=128),
                               vocab_size=256, dtype="float32")


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """One JAX init, published once; the prompts' logits from the JAX
    engine and from the port's endpoint on one scheduler."""
    root = tmp_path_factory.mktemp("cluster")
    jstore = JaxWeightStore(str(root / "w"))
    jstore.publish(NAME, jax_make_model(_cfg(get_config)).init(
        jax.random.PRNGKey(0)))
    store = WeightStore(str(root / "w"))
    prompts = np.random.default_rng(0).integers(
        0, 256, (N_PROMPTS, B, SEQ)).astype(np.int32)
    jeng = JaxEngine()
    try:
        jeng.deploy(JaxEndpoint(NAME, _cfg(get_config), jstore, JaxExecutor(),
                                batch_size=B, seq_len=SEQ))
        jax_logits = [jeng.invoke(NAME, p, freshen_successors=False)["logits"]
                      for p in prompts]
    finally:
        jeng.close()
    eng = ServingEngine()
    try:
        eng.deploy(_endpoint(store))
        one = [eng.invoke(NAME, p, freshen_successors=False)["logits"]
               for p in prompts]
    finally:
        eng.close()
    return store, prompts, one, jax_logits


def _endpoint(store):
    return ModelEndpoint(NAME, _cfg(port_get_config), store, Executor(),
                         batch_size=B, seq_len=SEQ, device="cpu")


def _check_logits(results, prompts_idx, one, jax_logits):
    for res, i in zip(results, prompts_idx):
        assert np.array_equal(res["logits"], one[i]), i
        np.testing.assert_allclose(res["logits"], jax_logits[i], atol=1e-4,
                                   rtol=0)


@pytest.mark.parametrize("mode", ["shards2", "elastic_1_3_1"])
def test_sharded_endpoint_matches_one_scheduler_and_jax(served, mode):
    store, prompts, one, jax_logits = served
    eng = ServingEngine(router_policy="warmth-aware")
    pool = PoolConfig(max_instances=2, keep_alive=600.0)
    n_submitted = 0
    try:
        if mode == "shards2":
            eng.deploy(_endpoint(store), pool_config=pool, shards=2)
        else:
            eng.deploy(_endpoint(store), pool_config=pool, elastic=True)
            assert eng.cluster.num_shards == 1
            assert eng.scale_shards(3) == 3
        workers = eng.cluster.workers
        assert all(w.has_function(NAME) for w in workers)
        # every shard serves the endpoint (the grown ones included)
        for k, w in enumerate(workers):
            i = k % N_PROMPTS
            _check_logits([w.invoke(NAME, {"tokens": prompts[i]},
                                    freshen_successors=False)], [i], one,
                          jax_logits)
            n_submitted += 1
        # concurrent requests through the router
        idx = [i % N_PROMPTS for i in range(8)]
        futs = [eng.submit(NAME, prompts[i], freshen_successors=False)
                for i in idx]
        n_submitted += len(futs)
        _check_logits([f.result(timeout=60) for f in futs], idx, one,
                      jax_logits)
        if mode == "elastic_1_3_1":
            # shrink with requests in flight: none is lost
            futs = [eng.submit(NAME, prompts[i], freshen_successors=False)
                    for i in idx]
            n_submitted += len(futs)
            assert eng.scale_shards(1) == 1
            _check_logits([f.result(timeout=60) for f in futs], idx, one,
                          jax_logits)
            assert [w.shard_id for w in eng.cluster.workers] == [0]
        assert eng.latency_summary("serving")["count"] == n_submitted
    finally:
        eng.close()


def test_sharded_batcher_routes_through_the_fabric(served):
    """``submit_request`` rows form batches sized against the idle
    capacity summed over the shards, and run through the router."""
    store, prompts, one, _ = served
    eng = ServingEngine()
    try:
        eng.deploy(_endpoint(store), pool_config=PoolConfig(
            max_instances=2, keep_alive=600.0), shards=2, batch_size=B,
            batch_max_wait=0.05)
        workers = eng.cluster.workers
        assert eng._idle_capacity(NAME) == sum(
            w.idle_capacity(NAME) for w in workers) > 0
        futs = [eng.submit_request(NAME, row) for row in prompts[0]]
        got = [f.result(timeout=60) for f in futs]
        for i in range(B):
            np.testing.assert_allclose(got[i], one[0][i], atol=1e-5, rtol=0)
        assert sum(eng.cluster.stats()["routed"].values()) >= 1
        assert eng.scheduler.pools == {}
    finally:
        eng.close()
