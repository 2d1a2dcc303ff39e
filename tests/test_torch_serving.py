"""The port's serving substrate on ``device="cpu"``: endpoints, freshen
integration, generation sessions, batching and weight versions — the
port-side mirror of ``test_serving.py`` and ``test_generation.py`` — and
one cross-package check: the same ``.npz`` and prompt give the JAX
endpoint's greedy tokens.

On the CPU the port's "compile" costs next to nothing (no XLA), so these
tests assert the freshen accounting and output invariance, not latency
orderings; the card-side latencies come from ``chip_smoke.py``.
"""
import dataclasses
import time

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config  # noqa: E402
from repro.models import make_model as jax_make_model  # noqa: E402
from repro.serving import Executor as JaxExecutor  # noqa: E402
from repro.serving import ModelEndpoint as JaxEndpoint  # noqa: E402
from repro.serving import WeightStore as JaxWeightStore  # noqa: E402
from repro_torch.checkpoint import tree_map  # noqa: E402
from repro_torch.configs import get_config as port_get_config  # noqa: E402
from repro_torch.core import FunctionSpec, Runtime  # noqa: E402
from repro_torch.serving import (Executor, ModelEndpoint,  # noqa: E402
                                 ServingEngine, TensorSpec, WarmBudget,
                                 WeightStore)

SEQ, MAX_LEN, N_STEPS = 16, 24, 6


def _cfg(get):
    return dataclasses.replace(get("qwen2-0.5b").reduced(d_model=128),
                               vocab_size=256, dtype="float32")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """One JAX init, published once by the JAX WeightStore; the port's
    store reads the same directory."""
    root = tmp_path_factory.mktemp("stores")
    cfg = _cfg(get_config)
    jstore = JaxWeightStore(str(root / "weights"))
    jstore.publish("tiny", jax_make_model(cfg).init(jax.random.PRNGKey(0)))
    store = WeightStore(str(root / "weights"))
    return _cfg(port_get_config), cfg, store, jstore, root


class _Datastore:
    """Minimal stand-in for a tiered datastore: get -> (value, seconds)."""

    def __init__(self):
        self.data, self.versions = {}, {}

    def put(self, key, value):
        self.data[key] = value
        self.versions[key] = self.versions.get(key, 0) + 1

    def get(self, key):
        return self.data[key], 0.0

    def version(self, key):
        return self.versions.get(key, 0)


def _ep(cfg, store, name="tiny", **kw):
    kw.setdefault("batch_size", 2)
    kw.setdefault("seq_len", SEQ)
    return ModelEndpoint(name, cfg, store, Executor(), device="cpu", **kw)


def test_executor_compile_cache():
    ex = Executor()

    def f(x):
        return x * 2.0

    specs = (TensorSpec((4,), torch.float32),)
    c1, dt1 = ex.compile("f", f, specs, device="cpu")
    c2, dt2 = ex.compile("f", f, specs, device="cpu")
    assert dt1 > 0 and dt2 == 0.0 and c1 is c2
    assert ex.hit_count == 1 and ex.compile_count == 1
    torch.testing.assert_close(c1(torch.ones(4)), torch.full((4,), 2.0))
    assert ex.warmup(c1, specs) >= 0.0
    assert ex.get("f", specs) is c1


def test_endpoint_cold_vs_freshened(setup):
    cfg, _, store, _, _ = setup
    ds = _Datastore()
    ds.put("embedding-table", {"v": 1})
    toks = np.zeros((2, SEQ), np.int32)
    eng, eng2 = ServingEngine(), ServingEngine()
    try:
        rt_cold = eng.deploy(_ep(cfg, store, datastore=ds,
                                 prefetch_key="embedding-table"))
        out_cold = eng.invoke("tiny", toks, freshen_successors=False)
        assert rt_cold.fr_state.stats()["inline"] >= 3
        assert out_cold["extra"] == {"v": 1}

        rt_warm = eng2.deploy(_ep(cfg, store, datastore=ds,
                                  prefetch_key="embedding-table"))
        rt_warm.freshen(blocking=True)
        out_warm = eng2.invoke("tiny", toks, freshen_successors=False)
        st = rt_warm.fr_state.stats()
        assert st["freshened"] >= 3 and st["inline"] == 0
        np.testing.assert_allclose(out_cold["logits"], out_warm["logits"],
                                   atol=1e-5)
        assert out_warm["logits"].shape == (2, 1, cfg.vocab_size)
        assert set(out_warm["timing"]) == {"total", "weights", "compile",
                                           "warmup", "execute"}
    finally:
        eng.close()
        eng2.close()


def test_chain_freshen_next_stage(setup):
    cfg, _, store, _, _ = setup
    params, _, _ = store.load("tiny", device="cpu")
    eng = ServingEngine()
    try:
        for name in ("stage1", "stage2"):
            store.publish(name, params)
            eng.deploy(_ep(cfg, store, name=name))
        eng.chain(["stage1", "stage2"])
        toks = np.zeros((2, SEQ), np.int32)
        eng.invoke("stage1", toks)               # dispatches freshen(stage2)
        eng.scheduler.runtimes["stage2"].join_freshen(timeout=30)
        out2 = eng.invoke("stage2", toks, freshen_successors=False)
        assert out2["timing"]["compile"] < 0.05, out2["timing"]
        st = eng.scheduler.runtimes["stage2"].fr_state.stats()
        assert st["freshened"] >= 2
        assert st["hits"] >= 2
        assert eng.latency_summary("serving")["count"] >= 2
        assert "stage2" in eng.platform_stats()
        assert eng.metrics_snapshot()
    finally:
        eng.close()


def test_warm_budget_gating(setup):
    cfg, _, store, _, _ = setup
    wb = WarmBudget(min_repetitions=2)
    key = ("m", 2, 16)
    assert not wb.allows(key)
    wb.observe(key)
    wb.observe(key)
    assert wb.allows(key)
    # on an endpoint: warm-up is skipped until the shape has repeated
    ep = _ep(cfg, store, warm_budget=WarmBudget(min_repetitions=2))
    eng = ServingEngine()
    try:
        eng.deploy(ep)
        toks = np.zeros((2, SEQ), np.int32)
        assert ep._warmup() == 0.0
        eng.invoke("tiny", toks, freshen_successors=False)
        eng.invoke("tiny", toks, freshen_successors=False)
        assert ep._warmup() > 0.0
    finally:
        eng.close()


def test_weight_store_version_staleness(setup, tmp_path):
    """A newly published weight version is picked up via version_fn."""
    cfg, _, store, _, _ = setup
    p1, _, _ = store.load("tiny", device="cpu")
    store2 = WeightStore(str(tmp_path / "w2"))
    store2.publish("m", p1)
    eng = ServingEngine()
    try:
        rt = eng.deploy(ModelEndpoint("m", cfg, store2, Executor(),
                                      batch_size=1, seq_len=8, device="cpu"))
        rt.freshen(blocking=True)
        toks = np.zeros((1, 8), np.int32)
        out1 = eng.invoke("m", toks, freshen_successors=False)
        store2.publish("m", tree_map(lambda t: t + 0.01, p1))
        out2 = eng.invoke("m", toks, freshen_successors=False)  # stale
        assert not np.allclose(out1["logits"], out2["logits"])
        assert store2.load_count >= 2 and store2.version("m") == 2
    finally:
        eng.close()


def test_submit_request_batches_rows(setup):
    """Single rows admitted through the pool-aware batcher come back as
    the rows a whole-batch invoke gives."""
    cfg, _, store, _, _ = setup
    rows = np.random.default_rng(1).integers(0, 256, (2, SEQ)).astype(
        np.int32)
    eng = ServingEngine()
    try:
        eng.deploy(_ep(cfg, store), batch_size=2, batch_max_wait=0.05)
        futs = [eng.submit_request("tiny", r) for r in rows]
        got = [f.result(timeout=60) for f in futs]
        want = eng.submit("tiny", rows,
                          freshen_successors=False).result(timeout=60)
        for i in range(2):
            np.testing.assert_allclose(got[i], want["logits"][i], atol=1e-5)
        with pytest.raises(KeyError):
            eng.submit_request("missing", rows[0])
    finally:
        eng.close()


def test_unported_placement_and_backends_raise(setup):
    """Placement and out-of-process endpoints are ported; what still
    raises is a shard's device mesh (ROADMAP.md module item 7b), an
    out-of-process endpoint without ``spec_ref``, and a fabric of no
    shards."""
    from repro_torch.core import BackendError
    cfg, _, store, _, _ = setup
    eng = ServingEngine()
    try:
        with pytest.raises(BackendError, match="FunctionSpec.ref"):
            eng.deploy(_ep(cfg, store), backend="snapshot")
        assert eng.scale_shards(2) == 2
        with pytest.raises(NotImplementedError, match="item 7b"):
            eng.cluster.workers[0].mesh()
        with pytest.raises(ValueError, match="at least one shard"):
            eng.scale_shards(0)
        assert eng.scale_shards(1) == 1
    finally:
        eng.close()


def test_endpoint_defaults_to_cuda_and_refuses_cpu_fallback(setup):
    cfg, _, store, _, _ = setup
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is usable")
    # building the endpoint touches no CUDA (a snapshot template builds
    # it before forking); the device resolves, and refuses, when an
    # instance builds its plan, which deploy's eager init does
    ep = ModelEndpoint("tiny", cfg, store, Executor())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ep.device
    eng = ServingEngine()
    try:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            eng.deploy(ep)
    finally:
        eng.close()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        store.load("tiny")


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "recurrentgemma-2b",
                                  "granite-moe-1b-a400m",
                                  "deepseek-v2-lite-16b", "xlstm-350m"])
def test_serve_launcher_on_cpu(arch, capsys):
    """``python -m repro_torch.launch.serve --device cpu``: each served
    architecture's reduced config through a freshened two-stage chain."""
    from repro_torch.launch import serve
    serve.main(["--device", "cpu", "--arch", arch, "--requests", "2"])
    out = capsys.readouterr().out
    assert f"arch={arch}-smoke mode=freshen requests=2" in out
    assert out.count("first=") == 2 and "bill: fn=" in out


# ---------------------------------------------------------------------------
# generation
def _gen_runtime(cfg, store, n_steps=N_STEPS):
    ep = _ep(cfg, store, batch_size=1)

    def plan_factory(rt):
        base = ep.build_plan(rt)
        base.entries.extend(ep.session_plan_entries(MAX_LEN))
        return base

    def code(ctx, args):
        t0 = time.monotonic()
        toks = ep.generate(ctx, args["tokens"], n_steps=n_steps,
                           max_len=MAX_LEN, plan_offset=3)
        return {"tokens": toks, "latency": time.monotonic() - t0}

    rt = Runtime(FunctionSpec("gen", code, plan_factory=plan_factory,
                              app="serving"))
    rt.init()
    return ep, rt


def test_generation_cold_vs_freshened(setup):
    cfg, _, store, _, _ = setup
    prompt = np.arange(SEQ, dtype=np.int32)[None, :] % 128
    _, rt_cold = _gen_runtime(cfg, store)
    out_cold = rt_cold.run({"tokens": prompt})
    assert rt_cold.fr_state.stats()["inline"] >= 3   # paid on critical path
    _, rt_warm = _gen_runtime(cfg, store)
    rt_warm.freshen(blocking=True)
    assert rt_warm.fr_state.stats()["freshened"] >= 4  # decode exes + cache
    out_warm = rt_warm.run({"tokens": prompt})
    assert out_cold["tokens"] == out_warm["tokens"]
    assert len(out_warm["tokens"]) == N_STEPS


def test_generation_is_deterministic_greedy(setup):
    """Two sessions on one freshened runtime reuse its preallocated
    cache, written in place, and decode the same tokens."""
    cfg, _, store, _, _ = setup
    prompt = (np.arange(SEQ, dtype=np.int32)[None, :] * 3) % 128
    _, rt = _gen_runtime(cfg, store)
    rt.freshen(blocking=True)
    a = rt.run({"tokens": prompt})["tokens"]
    b = rt.run({"tokens": prompt})["tokens"]
    assert a == b


def test_generation_matches_jax_endpoint(setup):
    """Cross-package: the .npz the JAX store published, the same prompt,
    the JAX endpoint's greedy tokens."""
    cfg, jcfg, store, jstore, _ = setup
    prompt = np.random.default_rng(2).integers(0, 256, (1, SEQ)).astype(
        np.int32)
    _, rt = _gen_runtime(cfg, store)
    port_tokens = rt.run({"tokens": prompt})["tokens"]

    jep = JaxEndpoint("tiny", jcfg, jstore, JaxExecutor(), batch_size=1,
                      seq_len=SEQ)

    def plan_factory(rt):
        base = jep.build_plan(rt)
        base.entries.extend(jep.session_plan_entries(MAX_LEN))
        return base

    def code(ctx, args):
        return jep.generate(ctx, args["tokens"], n_steps=N_STEPS,
                            max_len=MAX_LEN, plan_offset=3)

    from repro.core import FunctionSpec as JaxSpec
    from repro.core import Runtime as JaxRuntime
    jrt = JaxRuntime(JaxSpec("jgen", code, plan_factory=plan_factory,
                             app="serving"))
    jrt.init()
    assert port_tokens == jrt.run({"tokens": prompt})


@pytest.mark.parametrize("arch", ["gemma2-27b", "recurrentgemma-2b",
                                  "xlstm-350m"])
def test_second_session_on_a_reused_cache_matches_a_fresh_runtime(
        arch, tmp_path):
    """Sessions on one freshened runtime share its session cache.  A
    second session on another prompt gives what a fresh runtime gives:
    the same tokens and every cache leaf bit for bit.  So prefill
    overwrites each recurrent leaf (RG-LRU ``h``/``conv``; mLSTM
    ``C``/``n``/``m``/``conv``; sLSTM ``c``/``n``/``h``/``m``) and no K/V
    slot of the first session survives where the second reads (the
    16-slot ``attn_local`` ring wraps)."""
    from repro_torch.checkpoint import flatten_with_paths
    from repro_torch.models import make_model
    base = port_get_config(arch).reduced(d_model=128)
    cfg = dataclasses.replace(base, vocab_size=256, dtype="float32",
                              window_size=base.window_size and 16)
    store = WeightStore(str(tmp_path))
    store.publish("tiny", make_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(3)))

    def runtime():
        ep = _ep(cfg, store, batch_size=2)

        def plan_factory(rt):
            base = ep.build_plan(rt)
            base.entries.extend(ep.session_plan_entries(MAX_LEN))
            return base

        def code(ctx, args):
            toks = ep.generate(ctx, args["tokens"], n_steps=N_STEPS,
                               max_len=MAX_LEN, plan_offset=3)
            cache = flatten_with_paths(ctx.fr_fetch(4))
            return toks, {k: t.clone() for k, t in cache.items()}

        rt = Runtime(FunctionSpec("gen", code, plan_factory=plan_factory,
                                  app="serving"))
        rt.init()
        rt.freshen(blocking=True)
        return rt

    rng = np.random.default_rng(4)
    first, second = (rng.integers(0, 256, (2, SEQ)).astype(np.int32)
                     for _ in range(2))
    reused = runtime()
    reused.run({"tokens": first})
    got_tokens, got_cache = reused.run({"tokens": second})
    want_tokens, want_cache = runtime().run({"tokens": second})
    assert got_tokens == want_tokens
    assert got_cache.keys() == want_cache.keys()
    for k in want_cache:
        assert torch.equal(got_cache[k], want_cache[k]), k
