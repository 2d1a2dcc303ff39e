"""The traffic generator: the same seed gives the same arrivals and
prompts, another seed other ones, and every seed the same amount of work."""
import numpy as np
import pytest

from bench.harness import traffic

FNS = [{"name": "hot", "arrivals": {"kind": "poisson", "rate": 8.0}},
       {"name": "t", "arrivals": {"kind": "periodic", "period": 15.0,
                                  "phase": 1.0, "jitter": 0.5}},
       {"name": "b", "arrivals": {"kind": "bursty", "bursts": 3,
                                  "burst_size": 4, "gap": 5.0, "rate": 20.0}}]
SEED = 2 ** 31 + 12345          # seeds run past 32 signed bits


def _key(plan):
    return [(a.fn, round(a.due, 9), a.index) for a in plan]


def test_same_seed_same_traffic():
    assert _key(traffic.schedule(FNS, 45.0, SEED)) == \
        _key(traffic.schedule(FNS, 45.0, SEED))
    assert np.array_equal(traffic.prompts(5, (4, 16), 97, SEED),
                          traffic.prompts(5, (4, 16), 97, SEED))


def test_other_seed_other_traffic():
    assert _key(traffic.schedule(FNS, 45.0, SEED)) != \
        _key(traffic.schedule(FNS, 45.0, SEED + 1))
    assert not np.array_equal(traffic.prompts(5, (4, 16), 97, SEED),
                              traffic.prompts(5, (4, 16), 97, SEED + 1))


@pytest.mark.parametrize("seed", [1, 2, SEED])
def test_every_seed_same_work(seed):
    plan = traffic.schedule(FNS[:2], 45.0, seed)
    assert sum(a.fn == "hot" for a in plan) == 360
    ticks = sorted(a.due for a in plan if a.fn == "t")
    assert len(ticks) == 3
    for k, t in enumerate(ticks):
        assert abs(t - (1.0 + 15.0 * k)) <= 0.5
    assert [a.index for a in plan] == list(range(len(plan)))
    assert all(x.due <= y.due for x, y in zip(plan, plan[1:]))


def test_history_precedes_the_window():
    r = traffic.rng(SEED, traffic.ARRIVALS)
    h = traffic.history(FNS[1]["arrivals"], 20, r)
    assert len(h) == 20 and max(h) < 0
    gaps = np.diff(h)
    assert np.all(np.abs(gaps - 15.0) <= 1.0)


def test_prompts_in_range():
    p = traffic.prompts(3, (4, 128), 2048, SEED)
    assert p.dtype == np.int32 and p.shape == (3, 4, 128)
    assert p.min() >= 0 and p.max() < 2048


def test_pace_sends_each_arrival_once_in_due_order():
    import time
    plan = traffic.schedule(FNS[:1], 0.5, SEED)
    seen = []
    late = traffic.pace(plan, time.monotonic(), lambda a: seen.append(a.index),
                        workers=2)
    assert sorted(seen) == list(range(len(plan))) and len(late) == len(plan)
    assert all(x >= 0 for x in late)
