"""The one general traffic generator: a mix file (``bench/traffic/<mix>.json``)
in, arrivals and prompts out, all drawn from the run's seed.

Arrival archetypes, after ``repro_torch.workloads.trace`` (periodic,
bursty) with Poisson traffic beside them:

* ``poisson``: ``rate`` per second.  The count is fixed at
  ``round(rate * seconds)`` and the times are uniform over the window
  (a Poisson process conditioned on its count), so every seed sends the
  same amount of work in another order;
* ``periodic``: the timer trigger: ``phase + k * period``, each tick moved
  by up to ``jitter`` seconds either way;
* ``bursty``: ``bursts`` of ``burst_size`` arrivals at ``rate`` inside a
  burst, separated by ``gap`` seconds.

An open-loop sender (``pace``) sends each arrival when it is due, whether
or not earlier ones finished, after ``repro_torch.workloads.replay``; its
lateness is recorded, and latency is taken from the due time.
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, List, Sequence

import numpy as np

# independent streams of one seed (the weights draw from the seed itself,
# on the device)
ARRIVALS, PROMPTS, SAMPLE, HISTORY = 1, 2, 3, 4


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), stream])


@dataclass
class Arrival:
    due: float              # seconds after the window opens
    fn: str
    index: int = 0          # position in the run's schedule


def arrivals(spec: dict, fn: str, seconds: float,
             r: np.random.Generator) -> List[float]:
    """Due times in [0, seconds) of one function's arrival spec."""
    kind = spec["kind"]
    if kind == "poisson":
        n = int(round(spec["rate"] * seconds))
        return sorted(float(t) for t in r.uniform(0.0, seconds, size=n))
    if kind == "periodic":
        out, k = [], 0
        while True:
            t = spec.get("phase", 0.0) + k * spec["period"]
            if t >= seconds:
                return out
            j = spec.get("jitter", 0.0)
            t += float(r.uniform(-j, j)) if j else 0.0
            if 0.0 <= t < seconds:
                out.append(t)
            k += 1
    if kind == "bursty":
        out, t = [], spec.get("phase", 0.0)
        while t < seconds:
            for _ in range(spec["burst_size"]):
                t += float(r.exponential(1.0 / spec["rate"]))
                if t < seconds:
                    out.append(t)
            t += spec["gap"]
        return out
    raise ValueError(f"unknown arrival kind {kind!r} for {fn}")


def history(spec: dict, ticks: int, r: np.random.Generator) -> List[float]:
    """``ticks`` earlier arrivals of a periodic spec, before the window
    (negative times): the history a recurrence predictor is primed with."""
    j = spec.get("jitter", 0.0)
    return [-(ticks - k) * spec["period"] + (float(r.uniform(-j, j)) if j
                                             else 0.0)
            for k in range(ticks)]


def schedule(functions: Sequence[dict], seconds: float,
             seed: int) -> List[Arrival]:
    """Every function's arrivals in the window, in due order."""
    r = rng(seed, ARRIVALS)
    out = [Arrival(t, f["name"]) for f in functions
           for t in arrivals(f["arrivals"], f["name"], seconds, r)]
    out.sort(key=lambda a: (a.due, a.fn))
    for i, a in enumerate(out):
        a.index = i
    return out


def prompts(n: int, shape: Sequence[int], vocab: int,
            seed: int) -> np.ndarray:
    """``n`` prompts of ``shape`` token ids in [0, vocab), int32."""
    return rng(seed, PROMPTS).integers(0, vocab, size=(n, *shape),
                                       dtype=np.int32)


def pace(plan: Sequence[Arrival], t0: float, send: Callable[[Arrival], None],
         workers: int = 8) -> List[float]:
    """Open loop: each arrival is sent at ``t0 + due`` (host monotonic
    clock) by one of ``workers`` sender threads, so a send that blocks in
    the program's admission delays its own request and not the arrivals
    after it, as independent users' would not be.  Returns each send's
    lateness in seconds, in due order."""
    late = [0.0] * len(plan)
    with ThreadPoolExecutor(max_workers=workers,
                            thread_name_prefix="bench-sender") as pool:
        futs = []
        for i, a in enumerate(plan):
            delay = t0 + a.due - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            futs.append(pool.submit(_send_one, send, a, t0, late, i))
        for f in futs:
            f.result()
    return late


def _send_one(send, a: Arrival, t0: float, late: List[float], i: int):
    late[i] = max(0.0, time.monotonic() - (t0 + a.due))
    send(a)
