"""The port's process tracer (``repro_torch.telemetry.recorder``) on the
CPU: the plan phases a cold invoke's span gains and the work spans under
them, entries freshen ran marked as such, decode-step records, bounded
rings, which tracer an engine and an endpoint record into, the Chrome
export, the shared clock, the lock sanitizer's telemetry rule, and the
benchmark's four readers of it on tiny runs of the bench's test cells."""
import dataclasses
import json
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import sanitizer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import FunctionSpec, Runtime  # noqa: E402
from repro_torch.models import make_model  # noqa: E402
from repro_torch.serving import (Executor, ModelEndpoint,  # noqa: E402
                                 ServingEngine, WeightStore)
from repro_torch.telemetry import NULL_TRACER, Tracer  # noqa: E402
from repro_torch.telemetry import recorder  # noqa: E402
from repro_torch.telemetry.recorder import (DecodeTimer,  # noqa: E402
                                            Recorder, between,
                                            process_tracer)

ROOT = Path(__file__).resolve().parents[1]
SEQ, MAX_LEN, N_STEPS = 16, 24, 6
PLAN = ("plan.weights", "plan.compile", "plan.warmup")


class TickClock:
    """An injected clock that moves 1 ms at every read."""

    def __init__(self):
        self.now = 100.0

    def __call__(self) -> float:
        self.now += 1e-3
        return self.now


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(d_model=128),
                              vocab_size=256, dtype="float32")
    st = WeightStore(str(tmp_path_factory.mktemp("weights")))
    params = make_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    st.publish("tiny", params)
    return cfg, st


def _ep(store, **kw):
    cfg, st = store
    return ModelEndpoint("tiny", cfg, st, Executor(), batch_size=2,
                         seq_len=SEQ, device="cpu", **kw)


TOKENS = np.zeros((2, SEQ), np.int32)


def _work(rec, instance=None):
    return [w for w in rec.work_spans()
            if instance is None or w.instance == instance]


def test_cold_invoke_splits_run_into_plan_phases_and_load_spans(store):
    rec = Recorder(clock=TickClock())
    eng = ServingEngine(tracer=rec)
    try:
        eng.deploy(_ep(store))
        out = eng.invoke("tiny", TOKENS, freshen_successors=False)
    finally:
        eng.close()
    span = rec.spans()[-1]
    assert span.complete()
    names = [ph.name for ph in span.phases]
    assert [n for n in names if n in PLAN + ("execute",)] == \
        list(PLAN) + ["execute"]
    run = next(ph for ph in span.phases if ph.name == "run")
    for ph in span.phases:
        if ph.name in PLAN + ("execute",):
            assert run.start <= ph.start <= ph.end <= run.end
    weights = next(ph for ph in span.phases if ph.name == "plan.weights")
    assert weights.duration > 0 and out["timing"]["weights"] > 0
    load = next(w for w in rec.work_spans() if w.name == "weights.load")
    assert load.via == span.span_id and load.thread == span.thread_id
    assert load.fn == "tiny" and load.instance == span.attrs["instance"]
    assert weights.start <= load.start <= load.end <= weights.end
    parts = {w.name: w for w in rec.work_spans() if w.parent == load.span_id}
    assert set(parts) == {"weights.read", "weights.copy"}
    for w in parts.values():
        assert w.thread == span.thread_id and w.via == span.span_id
        assert load.start <= w.start <= w.end <= load.end
        assert w.nbytes > 0 and w.instance == load.instance
    assert parts["weights.read"].nbytes == store[1].nbytes("tiny")
    assert {w.name for w in rec.work_spans()} >= {"compile", "warmup"}


def test_freshened_invoke_runs_no_entry_inline(store):
    rec = Recorder()
    eng = ServingEngine(tracer=rec)
    try:
        rt = eng.deploy(_ep(store))
        rt.freshen(blocking=True)
        eng.invoke("tiny", TOKENS, freshen_successors=False)
    finally:
        eng.close()
    assert rt.fr_state.stats()["inline"] == 0
    span = rec.spans()[-1]
    mine = _work(rec, span.attrs["instance"])
    assert {w.name for w in mine if w.parent is None} == \
        {"weights.load", "compile", "warmup"}
    assert all(w.via == "freshen" for w in mine)
    assert not [w for w in rec.work_spans() if w.via == span.span_id]
    assert set(span.phase_seconds()) >= set(PLAN) | {"execute"}


def _gen_runtime(store, rec):
    ep = _ep(store, tracer=rec)

    def plan_factory(rt):
        base = ep.build_plan(rt)
        base.entries.extend(ep.session_plan_entries(MAX_LEN, rt))
        return base

    def code(ctx, args):
        return ep.generate(ctx, args["tokens"], n_steps=N_STEPS,
                           max_len=MAX_LEN, plan_offset=3)

    rt = Runtime(FunctionSpec("gen", code, plan_factory=plan_factory,
                              app="serving"))
    rt.init()
    return ep, rt


def test_generation_records_each_decode_position(store):
    rec = Recorder()
    _, rt = _gen_runtime(store, rec)
    rt.freshen(blocking=True)
    assert {w.name for w in rec.work_spans()} >= {
        "decode_executables", "session_cache", "session_graphs"}
    prompt = np.arange(2 * SEQ, dtype=np.int32).reshape(2, SEQ) % 128
    for _ in range(2):
        toks = rt.run({"tokens": prompt})
        assert len(toks) == N_STEPS
    steps = rec.decode_steps()
    assert len(steps) == 2 * (N_STEPS - 1)
    gens = sorted({d.gen for d in steps})
    assert len(gens) == 2
    for g in gens:
        mine = [d for d in steps if d.gen == g]
        assert [d.pos for d in mine] == list(range(SEQ, SEQ + N_STEPS - 1))
        assert all(d.device_ms is None and d.start < d.end for d in mine)
        assert all(a.end <= b.start for a, b in zip(mine, mine[1:]))
        assert all(d.thread == threading.get_ident() for d in mine)


def test_rings_stay_bounded():
    rec = Recorder(work_capacity=4, decode_capacity=3)
    for i in range(10):
        with rec.work("compile", fn="f", instance=1):
            pass
    timer = DecodeTimer(rec, "f", 1, torch.device("cpu"))
    for pos in range(10):
        timer.begin()
        timer.stepped()
        timer.end(pos)
    assert [d.pos for d in rec.decode_steps()] == [6, 7, 8]
    timer.close()                            # the last step's record
    assert len(rec.work_spans()) == 4 and len(rec.decode_steps()) == 3
    assert [d.pos for d in rec.decode_steps()] == [7, 8, 9]
    assert rec.dropped_records == 13


class _FakeEvent:
    """A CUDA event on a log: ``record`` notes the time it was recorded,
    ``elapsed_time`` the milliseconds between two records."""

    def __init__(self, log, name, clock):
        self.log, self.name, self.clock, self.at = log, name, clock, None

    def record(self, stream=None):
        self.at = self.clock()
        self.log.append(("record", self.name))

    def synchronize(self):
        self.log.append(("sync", self.name))

    def elapsed_time(self, other):
        self.log.append(("elapsed", self.name, other.name))
        return (other.at - self.at) * 1e3


def test_decode_timer_times_the_graph_start_to_the_argmax(monkeypatch):
    """On a card a step's device ms run from the event its graph records
    as the replay starts to the event recorded after its argmax.  Every
    event is read in ``stepped``, while the device runs the step just
    launched: nothing between a token's read and the next launch."""
    now = [0.0]
    log = []
    names = iter(["end0", "end1"])
    monkeypatch.setattr(torch.cuda, "Event", lambda enable_timing=False:
                        _FakeEvent(log, next(names), lambda: now[0]))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: "s")
    rec = Recorder(clock=lambda: now[0])
    started = _FakeEvent(log, "started", lambda: now[0])
    timer = rec.decode_timer("f", 1, torch.device("cuda"), started)
    assert log == [("record", "end0")]       # the prefill's end
    for pos in range(3):
        timer.begin()
        now[0] += 0.001                       # the host's copy-in, launch
        started.record()                      # the replay starts
        n = len(log)
        now[0] += 0.004 + pos * 0.001         # the graph and the argmax
        timer.stepped()
        prev, end = ("end0", "end1") if pos % 2 == 0 else ("end1", "end0")
        finish = [] if pos == 0 else [("elapsed", end, prev)]
        assert log[n:] == finish + [("record", end), ("sync", "started"),
                                    ("elapsed", prev, "started")]
        now[0] += 0.0002                      # the token's read
        n = len(log)
        timer.end(pos)
        assert len(log) == n
    timer.close()
    steps = rec.decode_steps()
    assert [d.pos for d in steps] == [0, 1, 2]
    assert [d.device_ms for d in steps] == pytest.approx([4.0, 5.0, 6.0])
    assert [d.end - d.start for d in steps] == pytest.approx(
        [0.0052, 0.0062, 0.0072])


def test_pending_freshens_of_silent_functions_expire():
    """A process tracer lives on: freshens dispatched for functions that
    never arrive again are expired once ``capacity`` more are tracked."""
    clock = TickClock()
    rec = Recorder(capacity=8, clock=clock, horizon=0.5)
    for i in range(40):
        rec.freshen(f"fn{i}").dispatched()
        clock.now += 1.0
    assert rec.pending_freshens() <= 8
    done = rec.freshen_spans()
    assert len(done) == 8 and rec.dropped >= 24
    assert all(fs.outcome == "expired" for fs in done)


def test_null_tracer_engine_records_nothing(store):
    proc = process_tracer()
    state = lambda: (len(proc.spans()), len(proc.work_spans()),  # noqa: E731
                     len(proc.decode_steps()), proc.dropped,
                     proc.dropped_records)
    before = state()
    eng = ServingEngine(tracer=NULL_TRACER)
    try:
        ep = _ep(store)
        eng.deploy(ep)
        eng.invoke("tiny", TOKENS, freshen_successors=False)
        assert eng.tracer is NULL_TRACER and ep.tracer is NULL_TRACER
    finally:
        eng.close()
    assert state() == before


def test_explicit_tracer_wins_over_the_process_tracer(store):
    eng = ServingEngine()
    assert eng.tracer is process_tracer()
    mine = Recorder()
    ep = _ep(store, tracer=mine)
    try:
        eng.deploy(ep)
        eng.invoke("tiny", TOKENS, freshen_successors=False)
    finally:
        eng.close()
    assert ep.tracer is mine
    assert {w.name for w in mine.work_spans()} >= {
        "weights.load", "weights.read", "weights.copy"}
    assert not mine.spans()                  # the engine's tracer has it
    plain = Tracer()
    ep2 = _ep(store, tracer=plain)
    eng2 = ServingEngine(tracer=plain)
    try:
        eng2.deploy(ep2)
        eng2.invoke("tiny", TOKENS, freshen_successors=False)
    finally:
        eng2.close()
    # a plain Tracer keeps the invocation and its phases, no work spans
    assert set(plain.spans()[-1].phase_seconds()) >= set(PLAN)


def test_endpoint_keeps_no_timings_list(store):
    assert not hasattr(_ep(store), "timings")


def test_export_chrome_holds_work_and_decode_events(store, tmp_path):
    rec = Recorder()
    eng = ServingEngine(tracer=rec)
    try:
        eng.deploy(_ep(store))
        eng.invoke("tiny", TOKENS, freshen_successors=False)
    finally:
        eng.close()
    timer = rec.decode_timer("tiny", 1, torch.device("cpu"))
    timer.begin()
    timer.stepped()
    timer.end(SEQ)
    timer.close()
    n = rec.export_chrome(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert len(events) == n
    by_cat = {}
    for ev in events:
        by_cat.setdefault(ev.get("cat"), []).append(ev)
    assert {"invocation", "phase", "work", "decode"} <= set(by_cat)
    assert {e["name"] for e in by_cat["work"]} >= {
        "weights.load", "weights.read", "weights.copy"}
    assert by_cat["decode"][0]["args"]["pos"] == SEQ
    for cat in ("invocation", "phase", "work", "decode"):
        for ev in by_cat[cat]:
            assert isinstance(ev["args"]["dev_ns"], int) and ev["ts"] >= 0
    inv = by_cat["invocation"][0]
    span = rec.spans()[0]
    assert abs(inv["args"]["dev_ns"] - recorder.dev_ns(
        span.start, span.attrs["offset_ns"])) < 2_000


def test_offset_puts_host_times_on_the_real_time_clock():
    rec = Recorder()
    want = time.time_ns() - time.monotonic_ns()
    assert abs(rec.offset_ns() - want) < 1_000_000
    t = time.monotonic()
    assert abs(recorder.dev_ns(t, rec.offset_ns()) - time.time_ns()) < 5e6


def test_spans_begun_under_a_profiler_are_marked_and_left_out():
    rec = Recorder()
    with rec.work("compile"):
        pass
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        with rec.work("warmup"):
            pass
        span = rec.invocation("f")
        span.finish()
    plain, profiled = rec.work_spans()
    assert not plain.profiled and profiled.profiled
    assert span.attrs["profiled"]
    assert between(rec.work_spans(), 0.0, time.monotonic()) == [plain]
    assert between(rec.spans(), 0.0, time.monotonic()) == []


def test_weight_load_outside_an_entry_records_nothing(store):
    proc = process_tracer()
    n = len(proc.work_spans()), proc.dropped_records
    store[1].load("tiny", device="cpu")
    assert (len(proc.work_spans()), proc.dropped_records) == n


def _installed_sanitizer(monkeypatch):
    from repro.analysis import sanitizer as reference
    monkeypatch.setattr(sanitizer, "_REAL_LOCK", reference._REAL_LOCK)
    monkeypatch.setattr(sanitizer, "_REAL_RLOCK", reference._REAL_RLOCK)
    monkeypatch.setattr(sanitizer, "_REAL_CONDITION",
                        reference._REAL_CONDITION)
    monkeypatch.setattr(sanitizer, "graph", sanitizer.LockGraph())
    was = sanitizer._installed
    sanitizer._installed = False
    return sanitizer.install(), was


def test_recorder_locks_are_telemetry_leaves(monkeypatch):
    saved = (threading.Lock, threading.RLock, threading.Condition)
    graph, was = _installed_sanitizer(monkeypatch)
    try:
        rec = Recorder()
        assert rec._ring_lock.key == "recorder.py:_ring_lock"
        assert sanitizer._is_telemetry(rec._ring_lock.key)
        with rec.work("compile", fn="f", instance=1):
            pass
        graph.assert_clean()
        from repro_torch.core.pool import InstancePool
        pool = InstancePool(FunctionSpec("f", lambda ctx, a: a, app="a"))
        # the order the telemetry-leaf rule refuses, taken on purpose
        leaf, data = rec._ring_lock, pool._cond
        with leaf:
            with data:
                pass
        assert [v.kind for v in graph.violations] == ["telemetry-leaf"]
        pool.close()
    finally:
        sanitizer.uninstall()
        sanitizer._installed = was
        threading.Lock, threading.RLock, threading.Condition = saved


# ----------------------------------------------------------------------
# the benchmark's readers, on tiny CPU runs of the bench's test cells
@pytest.fixture(scope="module")
def bench_runs():
    import sys
    sys.path.insert(0, str(ROOT))
    from bench.harness import cells, spec
    data = ROOT / "bench" / "tests" / "data"
    out = {}
    for name in ("tiny-fresh", "tiny-gen"):
        cell = spec.load(name, data, data)
        w, prog = cells.DRIVERS[cell.mix["entry"]](
            cell, 2 ** 31 + 91, 2.0, False, torch.device("cpu"))
        prog.close()
        out[name] = dict(config=cell.config, mix=cell.mix, window=w,
                         trace=w.trace, counters=w.counters)
    return out


READERS = [("tiny-fresh", "fresh.timer_plan_ms"),
           ("tiny-fresh", "fresh.load_read_gbps"),
           ("tiny-fresh", "fresh.load_copy_gbps"),
           ("tiny-gen", "gen.step_idle_share")]


@pytest.mark.parametrize("cell,metric", READERS)
def test_reader_on_a_tiny_run(bench_runs, cell, metric):
    from bench.harness import spec
    v = spec.reader(metric)(bench_runs[cell])
    if metric == "gen.step_idle_share":
        assert v is None                     # no device time on the CPU
        steps = between(process_tracer().decode_steps(),
                        bench_runs[cell]["window"].t0, time.monotonic())
        assert steps and all(d.device_ms is None for d in steps)
    else:
        assert isinstance(v, float) and v > 0


def test_timer_plan_ms_reads_the_timers_spans(bench_runs):
    from bench.harness import spec
    run = bench_runs["tiny-fresh"]
    w = run["window"]
    spans = [s for s in between(process_tracer().spans(), w.t0,
                                w.t0 + w.seconds)
             if s.fn in run["counters"]["timers"]]
    assert len(spans) == run["counters"]["timer_invokes"]
    mean = np.mean([sum(v for k, v in s.phase_seconds().items()
                        if k.startswith("plan.")) for s in spans])
    assert spec.reader("fresh.timer_plan_ms")(run) == \
        pytest.approx(1e3 * mean)


@pytest.mark.parametrize("cell,metric", READERS)
def test_reader_finds_nothing_outside_its_window(bench_runs, cell, metric):
    from bench.harness import spec
    run = dict(bench_runs[cell])
    run["window"] = dataclasses.replace(run["window"],
                                        t0=time.monotonic() + 1e6)
    assert spec.reader(metric)(run) is None
