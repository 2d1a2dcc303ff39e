"""``LeadScheduler`` and ``HoldingPool`` (``serving/lead.py``): a
prediction that outlasts keep-alive holds the warm instance until its
arrival, so the arrival's keep-alive sweep does not reap it.

The unit cases run on the thread backend and a fake clock: a plan entry
that moves the clock by ``COLD`` stands for a cold path, so nothing
sleeps.  The last case drives a tiny endpoint through ``ServingEngine()``
on the real clock.
"""
import dataclasses
import time

import numpy as np
import pytest

from repro_torch.core import (Accountant, FunctionSpec, HybridPredictor,
                              MarkovPredictor, PoolConfig,
                              RecurrencePredictor, WarmthLevel)
from repro_torch.core.freshen import Action, FreshenPlan, PlanEntry
from repro_torch.core.scheduler import FreshenScheduler
from repro_torch.serving.lead import HoldingPool, LeadScheduler

COLD, KEEP = 7.0, 5.0
GAPS = [14.5, 15.0, 15.5] * 7          # a 15 s timer with jitter


def _spec(clock, runs):
    def plan(rt):
        def load():
            runs.append(clock())
            clock.advance(COLD)                # the cold path's seconds
            return "weights"
        return FreshenPlan([PlanEntry("weights", Action.FETCH, load)])

    return FunctionSpec("t", lambda ctx, args: ctx.fr_fetch(0),
                        plan_factory=plan, app="app")


def _predictor(gaps=GAPS):
    rec = RecurrencePredictor()
    rec.seed("t", gaps)
    # no Markov successors: the recurrence alone predicts the timer
    return HybridPredictor(markov=MarkovPredictor(min_count=10 ** 9),
                           recurrence=rec)


def _empty(pool, clock):
    """Scale to zero (a graded pool walks down one rung a sweep)."""
    far = clock()
    while pool.size():
        far += 1e6
        pool.reap(now=far)


def _sched(clock, runs, gaps=GAPS, cls=LeadScheduler, empty=True, **pool):
    kw = dict(clock=clock) if cls is LeadScheduler else {}
    sched = cls(predictor=_predictor(gaps), accountant=Accountant(clock=clock),
                pool_config=PoolConfig(max_instances=1, keep_alive=KEEP,
                                       **pool), **kw)
    sched.register(_spec(clock, runs))
    pool = sched.pool("t")
    pool.clock = clock                  # the copied register builds on none
    if empty:
        _empty(pool, clock)
    return sched, pool


def _delay(sched):
    (pred,) = sched.predictor.successors("t")
    return pred.expected_delay


def _held(sched):
    return sched.metrics_snapshot().get("scheduler.freshen.held", 0)


def _skipped(pool):
    return pool.metrics.snapshot()["pool.t.hold_skipped_reaps"]


def _tick(sched, clock, at):
    """An arrival at ``at``: its prediction, then its invocation."""
    clock.set(at)
    sched.on_invocation_start("t", at)
    sched.submit("t", None, freshen_successors=False).result(timeout=10)


def test_short_prediction_dispatches_at_once(fake_clock):
    """(a) A prediction within keep-alive takes the copied dispatch alone:
    the prewarm goes out at once and nothing is held."""
    runs = []
    sched, pool = _sched(fake_clock, runs, gaps=[2.0] * 9, empty=False)
    ref, ref_pool = _sched(fake_clock, [], gaps=[2.0] * 9, empty=False,
                           cls=FreshenScheduler)
    try:
        for s in (sched, ref):
            s.on_invocation_start("t", 0.0)
        assert pool.prewarm_dispatches == ref_pool.prewarm_dispatches == 1
        assert [e.reason for e in sched.events] == \
            [e.reason for e in ref.events] == ["dispatched"]
        assert _held(sched) == 0 and pool._holds == []
    finally:
        sched.shutdown()
        ref.shutdown()


@pytest.mark.parametrize("cls", [LeadScheduler, FreshenScheduler])
def test_long_prediction_holds_the_instance_for_its_arrival(fake_clock, cls):
    """(b) A 15 s prediction behind a 5 s keep-alive holds the tick's
    instance: the next tick, long past keep-alive, acquires it warm with
    no entry run inline or waited for.  The copied scheduler reaps it and
    the tick starts cold."""
    runs = []
    sched, pool = _sched(fake_clock, runs, cls=cls)
    delay = _delay(sched)
    try:
        _tick(sched, fake_clock, 1.0)
        assert pool.cold_starts == 1 and len(runs) == 1
        before = pool.freshen_stats()
        _tick(sched, fake_clock, 1.0 + delay)
        after = pool.freshen_stats()
        if cls is FreshenScheduler:
            assert pool.cold_starts == 2 and len(runs) == 2
            return
        assert after["inline"] == before["inline"]
        assert after["waits"] == before["waits"]
        assert after["hits"] == before["hits"] + 1
        assert pool.cold_starts == 1 and len(runs) == 1
        assert _skipped(pool) >= 1 and _held(sched) == 2
    finally:
        sched.shutdown()


@pytest.mark.parametrize("graded", [False, True])
def test_hold_outlives_keep_alive_until_arrival_plus_limit(fake_clock,
                                                           graded):
    """(c) The held instance survives keep-alive until the predicted
    arrival plus the idle limit (a late tick still finds it); then the
    normal keep-alive from its last use applies: reaped (binary) or
    demoted a rung (graded)."""
    runs = []
    sched, pool = _sched(fake_clock, runs, graded_warmth=graded)
    delay = _delay(sched)
    try:
        _tick(sched, fake_clock, 1.0)
        demotions = pool.demotions
        until = 1.0 + delay + KEEP              # the arrival counts as a use
        for t in (1.0 + COLD + KEEP + 0.5, 1.0 + delay, until - 1e-3):
            assert pool.reap(now=t) == 0
            assert pool.size() == 1 and pool.demotions == demotions
        rt = pool.primary
        assert rt.warmth == WarmthLevel.HOT
        assert _skipped(pool) == 3
        gone = pool.reap(now=until + 1e-3)
        if graded:
            assert gone == 0 and pool.demotions == demotions + 1
            assert rt.warmth == WarmthLevel.INITIALIZED
        else:
            assert gone == 1 and pool.size() == 0
    finally:
        sched.shutdown()


@pytest.mark.parametrize("cls", [LeadScheduler, FreshenScheduler])
def test_hold_comes_before_the_dispatch_sweep(fake_clock, cls):
    """(d) A long prediction made while the pool's instance lies idle past
    keep-alive: the hold comes first, so the prewarm's own sweep spares
    the instance and warms it where it is; the copied dispatch reaps it
    and has nothing left to warm."""
    runs = []
    sched, pool = _sched(fake_clock, runs, cls=cls)
    try:
        _tick(sched, fake_clock, 1.0)
        reaped = pool.reaped
        fake_clock.set(1.0 + COLD + KEEP + 1.0)
        sched.on_invocation_start("t", fake_clock())
        if cls is FreshenScheduler:
            assert pool.size() == 0 and pool.reaped == reaped + 1
            assert sched.events[-1].reason == "no-idle-instance"
            return
        assert pool.size() == 1 and pool.reaped == reaped
        assert sched.events[-1].reason == "dispatched"
        assert _skipped(pool) == 1 and len(runs) == 1
    finally:
        sched.shutdown()


def test_gated_prediction_places_no_hold(fake_clock):
    """The hold keeps the accountant's gate: a prediction the gate refuses
    holds nothing, and the next tick starts cold as in the copy."""
    runs = []
    sched, pool = _sched(fake_clock, runs)
    sched.accountant.disable_after = 1
    sched.accountant.bill("app").mispredicted_freshens = 1
    delay = _delay(sched)
    try:
        _tick(sched, fake_clock, 1.0)
        assert _held(sched) == 0 and pool._holds == []
        _tick(sched, fake_clock, 1.0 + delay)
        assert pool.cold_starts == 2 and len(runs) == 2
    finally:
        sched.shutdown()


def test_newer_prediction_extends_the_hold(fake_clock):
    """(e) A newer prediction holds until its own arrival: the instance
    outlives the older hold and lapses at the newer one's end."""
    runs = []
    sched, pool = _sched(fake_clock, runs)
    delay = _delay(sched)
    try:
        _tick(sched, fake_clock, 1.0)
        sched.on_invocation_start("t", 3.0)
        assert _held(sched) == 2
        assert pool.reap(now=1.0 + delay + KEEP + 1e-3) == 0
        assert pool.reap(now=3.0 + delay + KEEP + 1e-3) == 1
    finally:
        sched.shutdown()


def test_billing_keeps_the_gate_open_over_ticks(fake_clock):
    """(g) The freshen each later tick dispatches is billed at its
    predicted arrival, so the next tick resolves it as useful and the
    accuracy gate keeps letting holds through: five ticks, one load."""
    runs = []
    sched, pool = _sched(fake_clock, runs)
    sched.accountant.disable_after = 2
    delay = _delay(sched)
    try:
        at = 1.0
        for tick in range(5):
            fake_clock.set(at)
            sched.on_invocation_start("t", at)
            deadline = time.monotonic() + 10
            # the first tick finds no instance to freshen; each later one
            # warms the held instance, billed once its thread ends
            while sched.accountant.peek_bill("app").freshen_invocations \
                    < tick:
                assert time.monotonic() < deadline
                time.sleep(0.002)
            sched.submit("t", None, freshen_successors=False).result(
                timeout=10)
            at += delay
        bill = sched.accountant.peek_bill("app")
        assert bill.useful_freshens == 3 and bill.mispredicted_freshens == 0
        assert _held(sched) == 5
        assert pool.cold_starts == 1 and len(runs) == 1
        assert pool.prewarm_provisioned == 0 and _skipped(pool) >= 4
    finally:
        sched.shutdown()


def test_pool_counts_busy_instances_toward_a_hold(fake_clock):
    pool = HoldingPool(_spec(fake_clock, []),
                       PoolConfig(max_instances=2, keep_alive=KEEP),
                       clock=fake_clock)
    a, _, _ = pool.acquire()
    b, _, _ = pool.acquire()
    pool.release(b)
    pool.hold(1, until=100.0)
    assert pool.reap(now=50.0) == 1                # a is busy: b is not held
    pool.release(a)
    assert pool.reap(now=99.0) == 0                # now a is the held one
    assert pool.reap(now=100.0) == 1


# ----------------------------------------------------------------------
# the engine: a primed timer whose period exceeds its keep-alive
torch = pytest.importorskip("torch")

SEQ = 8


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    from repro_torch.configs import get_config
    from repro_torch.models import make_model
    from repro_torch.serving import WeightStore
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(d_model=128),
                              vocab_size=256, dtype="float32")
    st = WeightStore(str(tmp_path_factory.mktemp("lead")))
    st.publish("tiny", make_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0)))
    return cfg, st


def test_engine_primed_timer_second_arrival_runs_no_entry_inline(store):
    """A timer every 1.5 s (±0.2) behind a 0.3 s keep-alive, its recurrence
    primed: the first arrival is cold; the second lands on the instance
    the first one's prediction held and runs no plan entry inline."""
    from repro_torch.serving import Executor, ModelEndpoint, ServingEngine
    cfg, st = store
    eng = ServingEngine()
    try:
        assert isinstance(eng.scheduler, LeadScheduler)
        ep = ModelEndpoint("tiny", cfg, st, Executor(), batch_size=1,
                           seq_len=SEQ, device="cpu")
        eng.deploy(ep, pool_config=PoolConfig(max_instances=1,
                                              keep_alive=0.3))
        pool = eng.scheduler.pool("tiny")
        pool.reap(now=time.monotonic() + 1e6)
        rec = RecurrencePredictor()
        rec.seed("tiny", [1.3, 1.5, 1.7] * 7)
        eng.scheduler.predictor.recurrence = rec
        toks = np.zeros((1, SEQ), np.int32)
        t0 = time.monotonic()
        eng.submit("tiny", toks).result(timeout=60)
        first = pool.freshen_stats()
        assert pool.cold_starts == 1
        time.sleep(max(0.0, t0 + 1.5 - time.monotonic()))
        eng.submit("tiny", toks).result(timeout=60)
        second = pool.freshen_stats()
        assert second["inline"] == first["inline"]
        assert second["waits"] == first["waits"]
        assert pool.cold_starts == 1
        snap = eng.metrics_snapshot()
        assert snap["scheduler.freshen.held"] >= 1
        assert snap["pool.tiny.hold_skipped_reaps"] >= 1
    finally:
        eng.close()
