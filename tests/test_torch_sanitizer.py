"""The port's lock-order sanitizer (``repro_torch.analysis.sanitizer``):
the reference's tests (``tests/test_sanitizer.py``) on the port's copies
of the pool, scheduler, router and worker, the locks of the ported
serving path, and the port's two-line difference from the reference.

The reference's sanitizer tracks locks made in files under ``/repro/``;
the port's, under ``/repro_torch/``.  Both patch the same ``threading``
factories, so this file's fixture installs the port's on the GENUINE
factories (whatever the suite's ``FABRIC_SANITIZE=1`` session installed
is saved), and puts the saved factories back afterwards: neither
sanitizer wraps the other's locks.
"""
import difflib
import threading
from concurrent.futures import wait
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import sanitizer  # noqa: E402
from repro_torch.analysis.sanitizer import (  # noqa: E402
    LockGraph, LockOrderError, _Tracked, _TrackedCondition, held_keys)
from repro_torch.core.runtime import FunctionSpec  # noqa: E402
from repro_torch.core.scheduler import FreshenScheduler  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture
def fresh_graph(monkeypatch):
    """A private LockGraph swapped in for the module global."""
    g = LockGraph()
    monkeypatch.setattr(sanitizer, "graph", g)
    return g


@pytest.fixture
def installed(monkeypatch):
    """The port's sanitizer installed on the genuine factories (the ones
    the reference's sanitizer saved when it was imported, before any
    patch) for the test, then the factories found before it restored."""
    from repro.analysis import sanitizer as reference
    saved = (threading.Lock, threading.RLock, threading.Condition)
    monkeypatch.setattr(sanitizer, "_REAL_LOCK", reference._REAL_LOCK)
    monkeypatch.setattr(sanitizer, "_REAL_RLOCK", reference._REAL_RLOCK)
    monkeypatch.setattr(sanitizer, "_REAL_CONDITION",
                        reference._REAL_CONDITION)
    was = sanitizer._installed
    sanitizer._installed = False
    g = sanitizer.install()
    yield g
    sanitizer.uninstall()
    sanitizer._installed = was
    threading.Lock, threading.RLock, threading.Condition = saved


def _spec(name="f", app="app"):
    return FunctionSpec(name, lambda ctx, args: args, app=app)


# ---------------------------------------------------------------------------
# the port's sanitizer is the reference's with its markers renamed


def test_differs_from_the_reference_in_its_two_markers_only():
    ref = (SRC / "repro" / "analysis" / "sanitizer.py").read_text()
    port = (SRC / "repro_torch" / "analysis" / "sanitizer.py").read_text()
    removed, added = [], []
    for line in difflib.unified_diff(ref.splitlines(), port.splitlines(),
                                     lineterm="", n=0):
        if line.startswith(("---", "+++", "@@")):
            continue
        (removed if line.startswith("-") else added).append(line[1:])
    assert [line.split("=")[0].strip() for line in removed] == \
        ["_TRACK_MARKER", "_SKIP_MARKER"]
    assert [line.split("=")[0].strip() for line in added] == \
        ["_TRACK_MARKER", "_SKIP_MARKER"]
    assert '"repro_torch"' in added[0] and '"analysis"' in added[1]
    assert sanitizer._TRACK_MARKER.endswith("repro_torch" + "/") or \
        sanitizer._TRACK_MARKER.endswith("repro_torch" + "\\")


@pytest.mark.parametrize("path,tracked", [
    ("/x/src/repro_torch/core/pool.py", True),
    ("/x/src/repro_torch/serving/engine.py", True),
    ("/x/src/repro_torch/analysis/sanitizer.py", False),
    ("/x/src/repro/core/pool.py", False),
    ("/x/tests/test_torch_sanitizer.py", False)])
def test_tracks_the_port_and_nothing_of_the_reference(path, tracked):
    assert sanitizer._should_track(path) is tracked


# ---------------------------------------------------------------------------
# graph mechanics


def test_cycle_detection():
    g = LockGraph()
    g.record({"a"}, "b")
    g.record({"b"}, "c")
    g.assert_acyclic()
    g.record({"c"}, "a")
    cycle = g.find_cycle()
    assert cycle is not None and cycle[0] == cycle[-1]
    with pytest.raises(LockOrderError, match="cycle"):
        g.assert_acyclic()


def test_reset_clears_edges_and_violations():
    g = LockGraph()
    g.record({"a"}, "b")
    g.violation("admin-under-lock", "x", ["y"])
    g.reset()
    assert g.edges() == {}
    assert g.violations == []
    g.assert_clean()


# ---------------------------------------------------------------------------
# tracked proxies


def test_tracked_lock_records_edges(fresh_graph):
    a = _Tracked(threading.Lock(), "a.py:_lock")
    b = _Tracked(threading.Lock(), "b.py:_lock")
    with a:
        assert held_keys() == ["a.py:_lock"]
        with b:
            assert held_keys() == ["a.py:_lock", "b.py:_lock"]
    assert held_keys() == []
    assert fresh_graph.edges() == {"a.py:_lock": {"b.py:_lock"}}


def test_rlock_reentry_is_not_an_edge(fresh_graph):
    r = _Tracked(threading.RLock(), "x.py:_lock")
    with r:
        with r:
            assert held_keys() == ["x.py:_lock", "x.py:_lock"]
    assert held_keys() == []
    assert fresh_graph.edges() == {}
    assert fresh_graph.violations == []


def test_condition_wait_releases_held_stack(fresh_graph):
    c = _TrackedCondition(threading.Condition(), "p.py:_cond")
    with c:
        c.wait(timeout=0.01)
        assert held_keys() == ["p.py:_cond"]
    assert held_keys() == []
    fresh_graph.assert_clean()


@pytest.mark.parametrize("held,acquiring,kind", [
    ("router.py:_lock", "router.py:_admin", "admin-under-lock"),
    ("metrics.py:_lock", "pool.py:_cond", "telemetry-leaf"),
    ("pool.py:_cond", "pool.py:_cond", "same-class-nesting")])
def test_declared_invariants(fresh_graph, held, acquiring, kind):
    outer = _Tracked(threading.RLock(), held)
    inner = _Tracked(threading.RLock(), acquiring)
    with outer:
        with inner:
            pass
    assert [v.kind for v in fresh_graph.violations] == [kind]
    with pytest.raises(LockOrderError, match=kind):
        fresh_graph.assert_clean()


def test_admin_as_outermost_is_clean(fresh_graph):
    data = _Tracked(threading.Lock(), "router.py:_lock")
    admin = _Tracked(threading.RLock(), "router.py:_admin")
    with admin:
        with data:
            pass
    fresh_graph.assert_clean()


# ---------------------------------------------------------------------------
# install(): creation-site interception


def test_install_tracks_fabric_locks_only(installed):
    from repro_torch.core.pool import InstancePool

    pool = InstancePool(_spec())
    assert isinstance(pool._cond, _TrackedCondition)
    assert pool._cond.key == "pool.py:_cond"
    plain = threading.Lock()
    assert not isinstance(plain, _Tracked)
    pool.close()


def test_install_leaves_the_reference_fabric_alone(installed):
    from repro.core.pool import InstancePool as RefPool
    pool = RefPool(FunctionSpec("f", lambda ctx, args: args, app="app"))
    assert not isinstance(pool._cond, _Tracked)
    pool.close()


def test_install_names_admin_and_data_locks_apart(installed):
    from repro_torch.cluster.router import ClusterRouter
    from repro_torch.cluster.worker import ClusterWorker

    router = ClusterRouter([ClusterWorker(0)])
    assert router._admin.key == "router.py:_admin"
    assert router._lock.key == "router.py:_lock"
    router.shutdown()


def test_install_tracks_the_ported_serving_locks(installed):
    """The locks of the ported modules: the executor's cache, an
    endpoint's per-device models, a kernel library's build and a kernel's
    launch count."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ops import FlashAttentionOp, KernelLibrary
    from repro_torch.serving import Executor, ModelEndpoint, WeightStore

    ex = Executor()
    assert ex._lock.key == "executor.py:_lock"
    lib = KernelLibrary()
    assert lib._lock.key == "ops.py:_lock"
    op = FlashAttentionOp("flash_attention", lib)
    assert op._count_lock.key == "ops.py:_count_lock"
    ep = ModelEndpoint("e", get_config("qwen2-0.5b").reduced(), None, ex,
                       device="cpu")
    assert ep._models_lock.key == "engine.py:_models_lock"


# ---------------------------------------------------------------------------
# fabric scenarios


def test_scheduler_hammer_graph_stays_acyclic(installed):
    """60 threads through the fast path + async waiters: the observed
    class-level acquisition order must be a DAG and violation-free."""
    base_violations = len(installed.violations)
    sched = FreshenScheduler()
    sched.register(_spec())
    errors = []

    def worker(i):
        try:
            for j in range(20):
                assert sched.invoke("f", (i, j)) == (i, j)
        except Exception as exc:            # noqa: BLE001
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(60)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    sched.shutdown()

    assert not errors
    edges = installed.edges()
    assert "pool.py:_cond" in edges
    assert installed.violations[base_violations:] == []
    installed.assert_acyclic()


def test_router_lifecycle_admin_is_outermost(installed):
    """Register / submit / add_worker / drain / shutdown: ``_admin`` is
    only ever a graph source, and the graph stays acyclic."""
    from repro_torch.cluster.router import ClusterRouter
    from repro_torch.cluster.worker import ClusterWorker

    base_violations = len(installed.violations)
    router = ClusterRouter([ClusterWorker(0), ClusterWorker(1)])
    router.register(_spec())
    futs = [router.submit("f", i) for i in range(50)]
    done, not_done = wait(futs, timeout=30)
    assert not not_done
    added = router.add_worker()
    router.remove_worker(added.shard_id, drain=True)
    router.shutdown()

    edges = installed.edges()
    assert "router.py:_admin" in edges
    under_admin = {dst for dsts in edges.values() for dst in dsts}
    assert "router.py:_admin" not in under_admin
    assert installed.violations[base_violations:] == []
    installed.assert_acyclic()


def test_served_endpoint_on_two_shards_is_clean(installed, tmp_path):
    """A reduced float32 qwen2 endpoint of the ported engine on two
    shards of the ported worker, the CPU standing in for the card:
    requests through the router, a third shard, a drain to one.  The
    port's fabric locks take part and the graph stays clean."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import PoolConfig
    from repro_torch.models import make_model
    from repro_torch.serving import (Executor, ModelEndpoint, ServingEngine,
                                     WeightStore)

    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                              dtype="float32")
    store = WeightStore(str(tmp_path / "w"))
    store.publish("q", make_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0)))
    base_violations = len(installed.violations)
    eng = ServingEngine(router_policy="warmth-aware")
    prompts = np.random.default_rng(0).integers(0, 256, (4, 2, 8)).astype(
        np.int32)
    try:
        eng.deploy(ModelEndpoint("q", cfg, store, Executor(), batch_size=2,
                                 seq_len=8, device="cpu"),
                   pool_config=PoolConfig(max_instances=2, keep_alive=600.0),
                   elastic=True)
        assert eng.scale_shards(2) == 2
        futs = [eng.submit("q", prompts[i % 4], freshen_successors=False)
                for i in range(8)]
        assert eng.scale_shards(3) == 3
        outs = [f.result(timeout=60) for f in futs]
        assert eng.scale_shards(1) == 1
    finally:
        eng.close()
    assert all(np.isfinite(o["logits"]).all() for o in outs)
    edges = installed.edges()
    keys = set(edges) | {d for ds in edges.values() for d in ds}
    assert {"router.py:_admin", "pool.py:_cond",
            "engine.py:_models_lock"} <= keys
    under_admin = {dst for dsts in edges.values() for dst in dsts}
    assert "router.py:_admin" not in under_admin
    assert installed.violations[base_violations:] == []
    installed.assert_acyclic()
