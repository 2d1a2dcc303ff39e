"""The drivers of one run: set-up, the measured window, the drain.

A mix file names its ``entry``, the program's call that the window drives:

* ``functions``: several serverless functions, each one endpoint on the
  same weights, under open-loop arrivals; every arrival is one
  ``ServingEngine.submit`` of a full endpoint batch;
* ``generate``: closed-loop clients, each sending its next generation
  when the last returns, through a function composed from
  ``ModelEndpoint.build_plan`` and ``session_plan_entries``.

Each driver returns a ``Window``: the latencies and answers the end-to-end
metrics and the check use, and the counters the per-layer readers use.
Nothing is compiled or captured inside the window that set-up could
have done: set-up runs every shape the window uses.
"""
from __future__ import annotations

import dataclasses
import gc
import os
import shutil
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List

import numpy as np
import torch
from repro_torch.serving import WeightStore

from bench.harness import traffic
from bench.harness.devtrace import profile_slice, reduce
from bench.harness.weights import check_layout, make_weights


@dataclass
class Window:
    t0: float
    seconds: float
    attempted: int = 0
    failed: int = 0
    late: List[float] = field(default_factory=list)        # sender lateness
    tokens: int = 0                  # generated tokens completed
    last_done: float = 0.0           # host monotonic
    answers: Dict[int, Any] = field(default_factory=dict)  # sampled outputs
    inputs: Dict[int, Any] = field(default_factory=dict)   # their inputs
    counters: Dict[str, Any] = field(default_factory=dict)
    trace: Any = None
    memory_peak: int = 0
    errors: List[str] = field(default_factory=list)   # the first few
    completions: List[float] = field(default_factory=list)  # host monotonic
    last_done_ns: int = 0            # the last answer, on the events' clock

    def error(self, exc: BaseException) -> None:
        if len(self.errors) < 5:
            self.errors.append(f"{type(exc).__name__}: {exc}")


def _mem(device: torch.device) -> int:
    return torch.cuda.memory_allocated(device) if device.type == "cuda" else 0


class TimedWeightStore(WeightStore):
    """A ``WeightStore`` whose every ``load`` is timed from the caller's
    side: the program's ``_load_weights`` drops the seconds ``load``
    returns, so the harness keeps them here."""

    def __init__(self, root: str):
        super().__init__(root)
        self.loads: List[tuple] = []
        self._load_lock = threading.Lock()

    def load(self, name, conn=None, device="cuda"):
        t0 = time.monotonic()
        out = super().load(name, conn, device)
        with self._load_lock:
            self.loads.append((t0, time.monotonic(), self.nbytes(name),
                               out[1]))
        return out


class Sampler:
    """Samples the device's allocated bytes and the pools' live instances
    every ``period`` seconds over the window, from its own thread."""

    def __init__(self, device, pools, baseline: int, period: float = 0.05):
        self.device, self.pools, self.baseline = device, pools, baseline
        self.period = period
        self.samples: List[tuple] = []
        self._stop = threading.Event()
        self._th = threading.Thread(target=self._run, name="bench-sampler",
                                    daemon=True)

    def _run(self):
        while not self._stop.is_set():
            self.samples.append((time.monotonic(),
                                 _mem(self.device) - self.baseline,
                                 sum(p.size() for p in self.pools)))
            self._stop.wait(self.period)

    def start(self):
        self._th.start()
        return self

    def stop(self):
        self._stop.set()
        self._th.join(5.0)

    def integrals(self, t0: float, t1: float):
        """(byte-seconds, mean live instances) over [t0, t1]."""
        pts = [s for s in self.samples if t0 <= s[0] <= t1]
        if len(pts) < 2:
            return 0.0, float(pts[0][2]) if pts else 0.0
        area = inst = 0.0
        for (ta, ma, ia), (tb, mb, ib) in zip(pts, pts[1:]):
            area += 0.5 * (ma + mb) * (tb - ta)
            inst += 0.5 * (ia + ib) * (tb - ta)
        return area, inst / (pts[-1][0] - pts[0][0])


class Program:
    """The system under test, set up from the seed: the program's
    ``ModelConfig`` from the configuration (``spec.model_config``), the
    weights made on the device in its reference's layout, checked against
    the program's layout, published once to a
    ``WeightStore`` under a temporary directory and linked under every
    function name, then freed before anything is deployed."""

    def __init__(self, cell, seed: int, device: torch.device,
                 names: List[str]):
        from repro_torch.checkpoint.io import (flatten_with_paths,
                                               unflatten_paths)
        from repro_torch.models import make_model
        from bench.harness.spec import model_config
        self.cell, self.device = cell, device
        self.marks: List[tuple] = [("imports", time.monotonic())]
        conf = cell.config
        self.m = conf["model"]
        self.dtype = getattr(torch, conf["dtype"])
        self.pcfg = model_config(conf)
        self.B, self.S = conf["endpoint"]["batch"], conf["endpoint"]["seq"]
        W = make_weights(cell.reference, self.m, self.dtype, seed, device)
        check_layout(W, flatten_with_paths(
            make_model(self.pcfg, device="cpu").param_specs()))
        self.mark("weights")
        self.root = tempfile.mkdtemp(prefix="bench-weights-")
        self.store = TimedWeightStore(self.root)
        self.store.publish(names[0], unflatten_paths(W))
        # the file on disk before the window: its write-back would
        # otherwise contend with the window's loads
        with open(self.store._path(names[0]), "rb") as f:
            os.fsync(f.fileno())
        for name in names[1:]:
            os.link(self.store._path(names[0]), self.store._path(name))
        del W
        gc.collect()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
        self.baseline = _mem(device)
        self.engine = None
        self.mark("publish")

    def mark(self, stage: str) -> None:
        """The end of a set-up stage, for the run's set-up split."""
        self.marks.append((stage, time.monotonic()))

    def endpoint(self, name: str):
        from repro_torch.serving import Executor, ModelEndpoint
        return ModelEndpoint(name, self.pcfg, self.store, Executor(),
                             batch_size=self.B, seq_len=self.S,
                             device=str(self.device))

    def pool_config(self, mix: dict):
        return dataclasses.replace(self.engine.scheduler.pool_config,
                                   **mix["pool"])

    def close(self):
        """Shut the engine down and free the program's device memory."""
        if self.engine is not None:
            self.engine.close()
            self.engine = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
        shutil.rmtree(self.root, ignore_errors=True)


def _wait(futs, deadline: float):
    for f in futs:
        try:
            f.result(timeout=max(0.0, deadline - time.monotonic()))
        except Exception:           # noqa: BLE001 - counted by the callback
            pass


def _window_end(w: Window):
    delay = w.t0 + w.seconds - time.monotonic()
    if delay > 0:
        time.sleep(delay)


def _settle() -> None:
    """Collect set-up's garbage before the window, so the window does not
    pay for it."""
    gc.collect()


def _drive(w: Window, mix: dict, trace: bool, body, start=None) -> None:
    """Run ``body`` (the traffic: a sender or the clients) in its own
    thread over the window; with ``trace`` the profiler slice runs in this
    thread, the one that imported torch, and is reduced once the traffic
    is done.  The slice opens at the mix's ``trace_slice.at`` share of the
    window, or at ``start()`` called then; it lasts ``seconds``, or with
    ``to_end`` until the traffic ends, closing at its last answer."""
    th = threading.Thread(target=body, name="bench-traffic", daemon=True)
    th.start()
    raw = None
    if trace:
        sl = mix["trace_slice"]
        at = w.t0 + sl["at"] * w.seconds
        time.sleep(max(0.0, at - time.monotonic()))
        raw = profile_slice(start() if start is not None else at,
                            sl.get("seconds"),
                            th.join if sl.get("to_end") else None)
    th.join()
    if raw is not None:
        prof, a, b = raw
        if b is None:
            b = w.last_done_ns
        w.trace = reduce(prof.profiler.kineto_results.events(), a, b)


def _before_next_completion(w: Window, lock, lead: float):
    """A slice start ``lead`` seconds before the next request is due to
    finish (or now, if that is sooner), predicted from the spacing of the
    window's completions so far, so that the slice holds the prefill of
    the request that follows."""
    def start() -> float:
        with lock:
            done = sorted(w.completions)
        now = time.monotonic()
        if len(done) < 2:
            return now
        gaps = sorted(b - a for a, b in zip(done, done[1:]))
        return max(now, done[-1] + gaps[len(gaps) // 2] - lead)
    return start


# ----------------------------------------------------------------------
# entry "functions": scale-to-zero functions under open-loop arrivals
def run_functions(cell, seed: int, seconds: float, trace: bool,
                  device: torch.device, drain: float = 60.0):
    from repro_torch.serving import ServingEngine
    from repro_torch.workloads.history import HistoryPolicy
    mix = cell.mix
    fns = mix["functions"]
    names = [f["name"] for f in fns]
    prog = Program(cell, seed, device, names)
    try:
        eng = prog.engine = ServingEngine()
        cfg = prog.pool_config(mix)
        eps = {n: prog.endpoint(n) for n in names}
        rts = {n: eng.deploy(eps[n], pool_config=cfg) for n in names}
        policy = HistoryPolicy()
        r = traffic.rng(seed, traffic.HISTORY)
        for f in fns:
            for t in traffic.history(f["arrivals"], f.get("prime_ticks", 0), r):
                policy.observe(f["name"], t)
        policy.prime(eng.scheduler.predictor)
        pools = [eng.scheduler.pools[n] for n in names]
        for f, pool in zip(fns, pools):
            if not f.get("warm"):
                pool.reap(now=time.monotonic() + 1e6)   # scaled to zero
        plan = traffic.schedule(fns, seconds, seed)
        V = prog.m["vocab_size"]
        prompts = traffic.prompts(len(plan) + 1, (prog.B, prog.S), V, seed)
        sr = traffic.rng(seed, traffic.SAMPLE)
        sampled = {a.index for a in plan if a.fn in mix["check"]["always"]}
        rest = [a.index for a in plan if a.index not in sampled]
        k = min(len(rest), mix["check"]["sample"])
        sampled |= {int(i) for i in sr.choice(rest, size=k, replace=False)}
        warm = prompts[-1]
        prog.mark("deploy")
        for f in fns:
            if f.get("warm"):
                rts[f["name"]].freshen(blocking=True)
                prog.mark("freshen")
                for _ in range(mix.get("warmup_invokes", 3)):
                    eng.submit(f["name"], warm).result()
                prog.mark("warm-up")
        before = eng.metrics_snapshot()
        cap_before = {(n, k): len(v) for n, ep in eps.items()
                      for k, v in ep.executor.capture_seconds.items()}
        timers = {f["name"] for f in fns if not f.get("warm")}
        loads_before = len(prog.store.loads)
        sampler = Sampler(device, pools, prog.baseline).start()

        _settle()
        w = Window(t0=time.monotonic(), seconds=seconds)
        lock = threading.Lock()
        lat = {}
        futs = []
        n_timer = sum(1 for a in plan if a.fn in timers)

        paid = {}                         # timer invoke -> entries it paid

        def send(a):
            pool = eng.scheduler.pools[a.fn]
            st0 = pool.freshen_stats() if a.fn in timers else None
            fut = eng.submit(a.fn, prompts[a.index])

            def done(f, a=a, pool=pool, st0=st0):
                t = time.monotonic()
                if st0 is not None:
                    # a timer's ticks never overlap: what its pool's
                    # invokes ran inline or waited for since this send is
                    # this invoke's (freshen counts apart, as freshened)
                    st1 = pool.freshen_stats()
                    with lock:
                        paid[a.index] = (st1["inline"] - st0["inline"]
                                         + st1["waits"] - st0["waits"])
                with lock:
                    if f.exception() is not None:
                        w.error(f.exception())
                        return
                    lat[a.index] = t - (w.t0 + a.due)
                    w.last_done = max(w.last_done, t)
                    w.last_done_ns = max(w.last_done_ns, time.time_ns())
                    if a.index in sampled:
                        w.answers[a.index] = f.result()["logits"]
                        w.inputs[a.index] = prompts[a.index]
            fut.add_done_callback(done)
            futs.append(fut)

        def sender():
            w.late = traffic.pace(plan, w.t0, send)
            _window_end(w)
        _drive(w, mix, trace, sender)
        w.attempted = len(plan)
        _wait(futs, w.t0 + seconds + drain)
        sampler.stop()
        with lock:
            by_fn = {n: [lat[a.index] for a in plan
                         if a.fn == n and a.index in lat] for n in names}
            w.failed = len(plan) - len(lat)
        area, inst = sampler.integrals(w.t0, w.t0 + seconds)
        after = eng.metrics_snapshot()
        plan_len = len(rts[names[0]].fr_state.plan)
        caps = [c for n, ep in eps.items()
                for k, v in ep.executor.capture_seconds.items()
                for c in v[cap_before.get((n, k), 0):]]
        loads = [(nb, real) for (ta, tb, nb, real)
                 in prog.store.loads[loads_before:]]
        w.counters = dict(
            invokes=len(plan), timer_invokes=n_timer,
            timer_freshened=sum(1 for v in paid.values() if v == 0),
            plan_len=plan_len,
            cold_starts=sum(after[f"pool.{n}.cold_starts"]
                            - before[f"pool.{n}.cold_starts"] for n in names),
            live_instances=inst, device_byte_s=area,
            loads=loads, captures=caps, timers=sorted(timers),
            latency_by_fn=by_fn)
        w.memory_peak = (torch.cuda.max_memory_allocated(device)
                         if device.type == "cuda" else 0)
        return w, prog
    except BaseException:
        prog.close()
        raise


# ----------------------------------------------------------------------
# entry "generate": closed-loop clients of a generation function
def generation_spec(ep, name: str, n_tok: int, max_len: int):
    """A generation function on ``ep``'s plan plus its session entries
    (the session's steps captured against its cache among them); its body
    is the endpoint's ``generate``."""
    from repro_torch.core import FunctionSpec

    def plan_factory(rt):
        base = ep.build_plan(rt)
        base.entries.extend(ep.session_plan_entries(max_len, rt))
        return base

    def code(ctx, args):
        return ep.generate(ctx, args["tokens"], n_steps=n_tok,
                           max_len=max_len, plan_offset=3)
    return FunctionSpec(name, code, plan_factory=plan_factory, app="serving")


def run_generate(cell, seed: int, seconds: float, trace: bool,
                 device: torch.device, drain: float = 60.0):
    from repro_torch.serving import ServingEngine
    mix = cell.mix
    name = mix["function"]
    n_tok, max_len = mix["new_tokens"], mix["cache"]
    prog = Program(cell, seed, device, [name])
    try:
        eng = prog.engine = ServingEngine()
        ep = prog.endpoint(name)
        rt = eng.scheduler.register(generation_spec(ep, name, n_tok, max_len),
                                    config=prog.pool_config(mix))
        rt.init()
        prog.mark("deploy")
        rt.freshen(blocking=True)
        prog.mark("freshen")
        V = prog.m["vocab_size"]
        prompts = traffic.prompts(mix["prompts"], (prog.B, prog.S), V, seed)
        eng.submit(name, prompts[-1]).result()       # one whole generation
        prog.mark("warm-up")
        _settle()
        w = Window(t0=time.monotonic(), seconds=seconds)
        lock = threading.Lock()
        counter = iter(range(10 ** 9))
        stop_at = w.t0 + seconds

        def client():
            while time.monotonic() < stop_at:
                with lock:
                    i = next(counter)
                    w.attempted += 1
                prompt = prompts[i % (len(prompts) - 1)]
                try:
                    out = eng.submit(name, prompt).result(
                        timeout=stop_at + drain - time.monotonic())
                except Exception as exc:  # noqa: BLE001 - counted as failed
                    with lock:
                        w.failed += 1
                        w.error(exc)
                    continue
                t = time.monotonic()
                with lock:
                    # the tokens the entry returned: ``generate`` returns
                    # row 0's, though the step decodes every row
                    w.tokens += int(np.asarray(out).size)
                    w.last_done = max(w.last_done, t)
                    w.last_done_ns = max(w.last_done_ns, time.time_ns())
                    w.completions.append(t)
                    w.answers[i] = np.asarray(out, np.int64)
                    w.inputs[i] = prompt
        def clients():
            ths = [threading.Thread(target=client, name=f"bench-client-{c}",
                                    daemon=True)
                   for c in range(mix["clients"])]
            for th in ths:
                th.start()
            for th in ths:
                th.join(seconds + drain + 30.0)
            if any(th.is_alive() for th in ths):
                w.failed += 1           # a client stuck past the drain
        _drive(w, mix, trace, clients,
               _before_next_completion(w, lock, mix["trace_slice"]["lead"]))
        w.counters = dict(invokes=w.attempted, n_tok=n_tok,
                          prompt_len=prog.S)
        w.memory_peak = (torch.cuda.max_memory_allocated(device)
                         if device.type == "cuda" else 0)
        return w, prog
    except BaseException:
        prog.close()
        raise


DRIVERS = {"functions": run_functions, "generate": run_generate}
