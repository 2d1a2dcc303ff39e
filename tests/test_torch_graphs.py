"""The port's served steps as captured graphs (``serving/executor.py``),
on the CPU.

The CPU has no ``torch.cuda.CUDAGraph``, so the executor's one seam,
``executor._graph_backend``, is replaced by a recorder: its capture
records the call and its replay runs it again on the tensors bound at
capture, writing the graph's outputs in place, so a stale binding shows
the old weights here as it would on the card.  Through it:

* the bookkeeping: fed arguments reach every replay; a new binding (a new
  params object, a new weight version, another instance's params) gets a
  graph of its own and never replays another's; a dropped binding frees
  its graph; a capture that raises propagates, with no eager fallback;
  launches count per replay, not per capture; an endpoint whose warm
  budget holds the warm-up back captures once, in its first invoke;
* tiny qwen2-0.5b and recurrentgemma-2b endpoints against the JAX
  ``ModelEndpoint`` on the weights the JAX store published: score logits
  within 1e-4 and the same greedy tokens, with every capture in the
  freshen and none inline; a published v2 served by the next invoke as a
  fresh v2 endpoint serves it, and v3 captured by a freshen.
"""
import dataclasses
import gc
import weakref

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config  # noqa: E402
from repro.core import FunctionSpec as JaxSpec  # noqa: E402
from repro.core import Runtime as JaxRuntime  # noqa: E402
from repro.models import make_model as jax_make_model  # noqa: E402
from repro.serving import Executor as JaxExecutor  # noqa: E402
from repro.serving import ModelEndpoint as JaxEndpoint  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro.serving import WeightStore as JaxWeightStore  # noqa: E402
from repro_torch.checkpoint import tree_map  # noqa: E402
from repro_torch.configs import get_config as port_get_config  # noqa: E402
from repro_torch.core import FunctionSpec, Runtime  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serving import (Executor, ModelEndpoint,  # noqa: E402
                                 ServingEngine, TensorSpec, WarmBudget,
                                 WeightStore)
from repro_torch.serving import executor as executor_mod  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

B, S, MAX_LEN, N_STEPS = 2, 12, 32, 8
ATOL = 1e-4
ARCHS = ("qwen2-0.5b", "recurrentgemma-2b")


def _cfg(get, arch):
    cfg = dataclasses.replace(get(arch).reduced(d_model=128),
                              vocab_size=256, dtype="float32")
    if arch == "recurrentgemma-2b":      # both segment shapes, a 16-slot ring
        cfg = dataclasses.replace(
            cfg, window_size=16, n_layers=8, segments=(
                (("rglru", "rglru", "attn_local"), 2),
                (("rglru", "rglru"), 1)))
    return cfg


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """One JAX init per config, published by the JAX WeightStore; the
    port's stores read the same directory."""
    root = tmp_path_factory.mktemp("graphs")
    jstore = JaxWeightStore(str(root))
    for i, arch in enumerate(ARCHS):
        jstore.publish(arch, jax_make_model(_cfg(get_config, arch)).init(
            jax.random.PRNGKey(i)))
    return root, jstore


class _Replay:
    def __init__(self, run, out):
        self.run, self.out, self.replays = run, out, 0

    def replay(self):
        self.replays += 1
        # the call's launches are the graph's: the executor counts them
        with ops.recording_launches():
            new = self.run()
        for have, got in zip(executor_mod._leaves(self.out),
                             executor_mod._leaves(new)):
            if have is not got:
                have.copy_(got)


# ops that move data between the host and the device (a pageable copy
# onto the card, a read back to the host) or whose output's shape
# depends on the data: on the card each synchronises, which a capture
# may not, or bakes one request's shape into the graph
HOST_TRAFFIC = {"aten::lift_fresh", "aten::_local_scalar_dense",
                "aten::nonzero", "aten::masked_select", "aten::_unique2",
                "aten::unique_consecutive", "aten::unique_dim"}


class _HostTraffic(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func._schema.name in HOST_TRAFFIC:
            self.seen.append(func._schema.name)
        return func(*args, **(kwargs or {}))


class Recorder:
    """Stands in for the card's graphs (``executor._graph_backend``); it
    notes every host-traffic op a captured call makes."""

    def __init__(self):
        self.warms = self.captures = 0
        self.graphs = []
        self.fail = None
        self.host_traffic = []

    def warm(self, run):
        self.warms += 1
        run()

    def capture(self, run):
        self.gc_enabled = gc.isenabled()
        if self.fail is not None:
            raise self.fail
        self.captures += 1
        with _HostTraffic() as mode:
            out = run()
        self.host_traffic += mode.seen
        graph = _Replay(run, out)
        self.graphs.append(weakref.ref(graph))
        return graph, out


@pytest.fixture
def recorder(monkeypatch):
    rec = Recorder()
    monkeypatch.setattr(executor_mod, "_graph_backend", lambda device: rec)
    return rec


def _matmul_step(ex=None):
    ex = ex or Executor()
    specs = (TensorSpec((4, 3), torch.float32),
             TensorSpec((2, 4), torch.float32))
    compiled, _ = ex.compile("mm", lambda w, x: x @ w, specs, device="cpu",
                             n_bound=1)
    return compiled


def _rand(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


# ---------------------------------------------------------------------------
# the bookkeeping
def test_fed_arguments_reach_every_replay(recorder):
    compiled = _matmul_step()
    w = _rand(4, 3)
    step, spent = compiled.bind(w)
    assert spent > 0.0 and recorder.captures == 1 and recorder.warms == 1
    x1, x2 = _rand(2, 4, seed=1), _rand(2, 4, seed=2)
    y1 = step(x1)
    y2 = step(x2)
    torch.testing.assert_close(y1, x1 @ w, rtol=0, atol=0)
    torch.testing.assert_close(y2, x2 @ w, rtol=0, atol=0)
    assert not torch.equal(y1, y2)          # the first output was a copy
    assert step.static[0] is not x2 and torch.equal(step.static[0], x2)
    assert compiled.bind(w) == (step, 0.0) and recorder.captures == 1


def test_a_new_binding_gets_its_own_graph(recorder):
    compiled = _matmul_step()
    w1, w2 = _rand(4, 3, seed=1), _rand(4, 3, seed=2)
    x = _rand(2, 4, seed=3)
    s1, _ = compiled.bind(w1)
    s2, _ = compiled.bind(w2)
    assert s1 is not s2 and recorder.captures == 2
    torch.testing.assert_close(s2(x), x @ w2, rtol=0, atol=0)
    torch.testing.assert_close(s1(x), x @ w1, rtol=0, atol=0)
    # a new tensor with w1's values is a new binding too
    s3, _ = compiled.bind(w1.clone())
    assert s3 is not s1 and recorder.captures == 3
    # a graph reads its binding by address: an in-place update shows
    w1.mul_(2.0)
    torch.testing.assert_close(s1(x), x @ w1, rtol=0, atol=0)
    assert len(compiled.capture_seconds) == 3


def test_no_garbage_collection_while_a_graph_is_captured(recorder):
    """A collection during a capture could free a dead step's graph,
    which invalidates the capture on the card: the executor holds the
    collector off while it captures, and after a failed capture too."""
    assert gc.isenabled()
    compiled = _matmul_step()
    compiled.bind(_rand(4, 3))
    assert recorder.gc_enabled is False and gc.isenabled()
    recorder.fail = RuntimeError("capture failed")
    with pytest.raises(RuntimeError):
        compiled.bind(_rand(4, 3))
    assert recorder.gc_enabled is False and gc.isenabled()


def test_a_dropped_binding_frees_its_graph(recorder):
    compiled = _matmul_step()
    w = _rand(4, 3)
    step, _ = compiled.bind(w)
    refs = (weakref.ref(step), weakref.ref(w), recorder.graphs[0])
    del step, w
    gc.collect()
    assert all(r() is None for r in refs)
    assert len(compiled._steps) == 0
    # the next binding captures anew
    compiled.bind(_rand(4, 3))
    assert recorder.captures == 2


def test_a_failing_capture_raises(recorder, stores):
    recorder.fail = RuntimeError("capture failed: operation not permitted")
    compiled = _matmul_step()
    with pytest.raises(RuntimeError, match="capture failed"):
        compiled.bind(_rand(4, 3))
    assert len(compiled._steps) == 0
    # through an endpoint: the freshen swallows it, the invoke raises it
    # and returns no logits from an eager step
    root, _ = stores
    eng = ServingEngine()
    try:
        rt = eng.deploy(_endpoint(root, "qwen2-0.5b"))
        rt.freshen(blocking=True)
        assert rt.fr_state.entries[2].error is not None
        with pytest.raises(RuntimeError, match="capture failed"):
            eng.invoke("qwen2-0.5b", _tokens(0), freshen_successors=False)
    finally:
        eng.close()


def test_launches_count_per_replay_not_per_capture(recorder):
    def step_fn(w, x):                # two K1 and one K2 "launches"
        ops.flash_attention._counted()
        ops.flash_attention._counted()
        ops.decode_attention._counted()
        return x @ w

    ex = Executor()
    compiled, _ = ex.compile("counted", step_fn, (
        TensorSpec((4, 3), torch.float32), TensorSpec((2, 4), torch.float32)),
        device="cpu", n_bound=1)
    ops.reset_launches()
    step, _ = compiled.bind(_rand(4, 3))
    # the warm run ran; the capture ran nothing
    assert (ops.flash_attention.launches, ops.decode_attention.launches) \
        == (2, 1)
    assert step.launches == {"flash_attention": 2, "decode_attention": 1}
    for n in (1, 2, 3):
        step(_rand(2, 4))
        assert (ops.flash_attention.launches,
                ops.decode_attention.launches) == (2 + 2 * n, 1 + n)
    ops.reset_launches()


# ---------------------------------------------------------------------------
# endpoints against the JAX endpoint
def _endpoint(root, arch, store=None, batch=B, **kw):
    return ModelEndpoint(arch, _cfg(port_get_config, arch),
                         store or WeightStore(str(root)), Executor(),
                         batch_size=batch, seq_len=S, device="cpu", **kw)


def _tokens(seed, batch=B):
    return np.random.default_rng(seed).integers(0, 256, (batch, S)).astype(
        np.int32)


def _gen_runtime(ep, *, port=True):
    def plan_factory(rt):
        base = ep.build_plan(rt)
        mine = (rt,) if port else ()
        base.entries.extend(ep.session_plan_entries(MAX_LEN, *mine))
        return base

    def code(ctx, args):
        return ep.generate(ctx, args["tokens"], n_steps=N_STEPS,
                           max_len=MAX_LEN, plan_offset=3)
    spec, runtime = (FunctionSpec, Runtime) if port else (JaxSpec,
                                                           JaxRuntime)
    rt = runtime(spec(f"{ep.name}/gen", code, plan_factory=plan_factory,
                      app="serving"))
    rt.init()
    return rt


@pytest.mark.parametrize("arch", ARCHS)
def test_replayed_endpoint_matches_the_jax_endpoint(arch, recorder, stores):
    root, jstore = stores
    toks = _tokens(1)
    ep = _endpoint(root, arch)
    eng = ServingEngine()
    jeng = JaxEngine()
    try:
        rt = eng.deploy(ep)
        rt.freshen(blocking=True)
        captures = recorder.captures
        assert captures >= 1
        got = eng.invoke(arch, toks, freshen_successors=False)
        assert recorder.captures == captures        # nothing inline
        assert "capture" not in got["timing"]
        assert rt.fr_state.stats()["inline"] == 0
        jeng.deploy(JaxEndpoint(arch, _cfg(get_config, arch), jstore,
                                JaxExecutor(), batch_size=B, seq_len=S))
        want = jeng.invoke(arch, toks, freshen_successors=False)["logits"]
        np.testing.assert_allclose(got["logits"], np.asarray(want),
                                   atol=ATOL, rtol=0)
    finally:
        eng.close()
        jeng.close()

    gen = _gen_runtime(_endpoint(root, arch))
    gen.freshen(blocking=True)
    captures = recorder.captures
    port_tokens = gen.run({"tokens": toks})
    assert recorder.captures == captures
    assert gen.fr_state.stats()["inline"] == 0
    jep = JaxEndpoint(arch, _cfg(get_config, arch), jstore, JaxExecutor(),
                      batch_size=B, seq_len=S)
    jax_tokens = _gen_runtime(jep, port=False).run({"tokens": toks})
    assert len(port_tokens) == N_STEPS and port_tokens == jax_tokens
    # a second session replays the same graphs on the cache it reseeds
    assert gen.run({"tokens": toks}) == port_tokens
    assert recorder.captures == captures


def test_a_gated_endpoint_captures_once(recorder, stores):
    """Where the warm budget holds the warm-up back, the first invoke
    binds the step inline (booked as its capture, never as execute) and
    the warm-up entry keeps it: the next invoke replays that graph."""
    root, _ = stores
    arch = "qwen2-0.5b"
    eng = ServingEngine()
    try:
        rt = eng.deploy(_endpoint(
            root, arch, warm_budget=WarmBudget(min_repetitions=2)))
        rt.freshen(blocking=True)
        assert recorder.captures == 0
        assert rt.fr_state.entries[2].result.step is None
        toks = _tokens(6)
        first = eng.invoke(arch, toks, freshen_successors=False)
        assert recorder.captures == 1 and first["timing"]["capture"] > 0.0
        second = eng.invoke(arch, toks, freshen_successors=False)
        assert recorder.captures == 1 and "capture" not in second["timing"]
        np.testing.assert_array_equal(first["logits"], second["logits"])
        step = rt.fr_state.entries[2].result.step
        assert step.graph.replays == 2
        assert rt.fr_state.stats()["inline"] == 0
    finally:
        eng.close()


def test_another_instances_params_get_their_own_graph(recorder, stores):
    """Two instances of one endpoint share its executor: each replays
    the graph bound to its own params."""
    root, _ = stores
    arch = "qwen2-0.5b"
    ep = _endpoint(root, arch)
    a, b = (Runtime(ep.spec()) for _ in range(2))
    for rt in (a, b):
        rt.init()
        rt.freshen(blocking=True)
    compiled = ep.executor.get(f"{arch}/score", ep._specs(), device="cpu")
    assert len(compiled._steps) == 2 and recorder.captures == 2
    toks = _tokens(2)
    la = a.run({"tokens": toks})["logits"]
    np.testing.assert_array_equal(la, b.run({"tokens": toks})["logits"])
    scale = a.fr_state.entries[0].result["final_norm"]["scale"]
    scale.mul_(2.0)                   # instance a's tensors only
    assert not np.array_equal(a.run({"tokens": toks})["logits"], la)
    np.testing.assert_array_equal(b.run({"tokens": toks})["logits"], la)
    assert recorder.captures == 2


def test_a_new_weight_version_is_captured_and_served(recorder, stores,
                                                     tmp_path):
    """v2 published: the next invoke refetches the weights and binds the
    step to them inline, serving a fresh v2 endpoint's logits, and v1's
    graph and params are freed; v3 published and freshened: the capture
    runs in the freshen and the invoke replays it."""
    root, _ = stores
    arch = "qwen2-0.5b"
    v1, _, _ = WeightStore(str(root)).load(arch, device="cpu")
    store = WeightStore(str(tmp_path / "served"))
    store.publish(arch, v1)
    toks = _tokens(3)

    def version(params, k):
        return tree_map(lambda t: t * (1.0 + 0.1 * k), params)

    def fresh_logits(params, tag):
        only = WeightStore(str(tmp_path / tag))
        only.publish(arch, params)
        eng = ServingEngine()
        try:
            eng.deploy(_endpoint(root, arch, store=only))
            return eng.invoke(arch, toks, freshen_successors=False)["logits"]
        finally:
            eng.close()

    eng = ServingEngine()
    try:
        rt = eng.deploy(_endpoint(root, arch, store=store))
        rt.freshen(blocking=True)
        got1 = eng.invoke(arch, toks, freshen_successors=False)["logits"]
        old = weakref.ref(rt.fr_state.entries[0].result["embed"])
        old_step = weakref.ref(rt.fr_state.entries[2].result.step)
        store.publish(arch, version(v1, 2))
        got2 = eng.invoke(arch, toks, freshen_successors=False)
        assert [e.inline_count for e in rt.fr_state.entries] == [1, 0, 1]
        assert "capture" not in got2["timing"]   # booked under warmup
        gc.collect()
        assert old() is None and old_step() is None
        assert not np.array_equal(got1, got2["logits"])
        np.testing.assert_array_equal(got2["logits"],
                                      fresh_logits(version(v1, 2), "v2"))

        store.publish(arch, version(v1, 3))
        captures = recorder.captures
        rt.freshen(blocking=True)
        assert recorder.captures == captures + 1
        got3 = eng.invoke(arch, toks, freshen_successors=False)
        assert recorder.captures == captures + 1
        assert [e.inline_count for e in rt.fr_state.entries] == [1, 0, 1]
        np.testing.assert_array_equal(got3["logits"],
                                      fresh_logits(version(v1, 3), "v3"))
    finally:
        eng.close()


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "recurrentgemma-2b",
                                  "granite-moe-1b-a400m",
                                  "deepseek-v2-lite-16b", "xlstm-350m",
                                  "gemma2-27b", "phi3-medium-14b",
                                  "nemotron-4-15b", "pixtral-12b",
                                  "musicgen-medium"])
def test_captured_steps_move_no_host_data(arch, recorder):
    """Every config's score, prefill and decode step, as the executor
    captures them after their warm run: no tensor made from host data,
    no read back to the host, no data-dependent shape (a capture on the
    card fails on the first two)."""
    from repro_torch.models import make_model
    cfg = dataclasses.replace(port_get_config(arch).reduced(d_model=64),
                              vocab_size=128)
    ep = ModelEndpoint(arch, cfg, None, Executor(), batch_size=B, seq_len=S,
                       device="cpu")
    params = make_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    score = ep.executor.warmup(ep._compile(), params)
    c_pre, c_dec = ep._compile_decode(MAX_LEN)
    cache = ep._prealloc_session(MAX_LEN)
    pre = ep.executor.warmup(c_pre, params, cache)
    dec = ep.executor.warmup(c_dec, params, cache)
    assert recorder.captures == 3 and recorder.host_traffic == []
    toks = torch.as_tensor(_tokens(5) % cfg.vocab_size)
    with torch.no_grad():
        want = ep._score_fn(ep.device)(params, toks)
    torch.testing.assert_close(score(toks), want, rtol=0, atol=0)
    logits, _ = pre(toks)
    tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)
    logits, _ = dec(tok, torch.full((B,), S, dtype=torch.int32))
    assert torch.isfinite(logits).all()


def test_the_cpu_runs_the_steps_eagerly(stores):
    """Without the recorder the CPU binds nothing to a graph: the step
    runs eagerly and no invoke reports a capture."""
    root, _ = stores
    eng = ServingEngine()
    try:
        rt = eng.deploy(_endpoint(root, "qwen2-0.5b"))
        out = eng.invoke("qwen2-0.5b", _tokens(4), freshen_successors=False)
        assert "capture" not in out["timing"]
        step = rt.fr_state.entries[2].result.step
        assert step.graph is None and step.warm_seconds > 0.0
        assert not step.compiled.capture_seconds
    finally:
        eng.close()
