"""A profiler slice of the window on the device clock, and its reduction.

``profile_slice`` runs ``torch.profiler`` (host and CUDA activity) over a
few seconds in the middle of the measured window.  ``reduce`` turns the
kineto events into what the per-layer readers use:

* ``busy_ns`` / ``window_ns``: the union of every device operation
  (kernels, copies, sets) inside the slice, and the slice's length;
* ``steps``: the replayed graphs whose every kernel lies inside the slice.
  Kernels launched by one ``cudaGraphLaunch`` share its correlation id,
  so a group is one replay; it is a ``prefill`` (a score or prefill step:
  one K1 per layer) or a ``decode`` (one K2 per layer), with its span on
  the device (first kernel start to last kernel end), its K1 and K2 time;
* ``device_ops`` and ``idle_gaps`` for the result's ``breakdown``: device
  time by kernel name, and the longest gaps with no device operation,
  each named by the host operation that overlapped it most.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from bench.roofline.counts import KERNELS


@dataclass
class DeviceTrace:
    window_ns: int
    busy_ns: int
    steps: List[dict] = field(default_factory=list)
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)


def warm_profiler(device) -> None:
    """Start and stop the profiler once before the window: its first start
    imports a good part of torch (``torch._dynamo``, the distributed
    packages) and sets up CUPTI, seconds of work that would otherwise
    stall the traffic, and an import that another thread could see half
    done."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts):
        torch.zeros(8, device=device).add_(1)
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def profile_slice(start: float, seconds: float = None,
                  until=None) -> Tuple[object, int, int]:
    """Profile the window from ``start`` (host monotonic clock) for
    ``seconds``, or until ``until()`` returns (the end of the traffic: no
    launch is then in flight while the profiler stops).  Runs in the thread
    that imported torch, as kineto requires; the traffic runs in other
    threads meanwhile.  Returns (profiler, start ns, end ns) on the clock
    the events use; the end is None when ``until`` ended the slice."""
    from torch.profiler import ProfilerActivity, profile
    delay = start - time.monotonic()
    if delay > 0:
        time.sleep(delay)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    a = time.time_ns()
    b = None
    if until is None:
        time.sleep(seconds)
        b = time.time_ns()
    else:
        until()
    prof.stop()
    return prof, a, b


def short_name(name: str) -> str:
    n = name[5:] if name.startswith("void ") else name
    for stop in ("<", "("):
        i = n.find(stop)
        if i > 0 and not n.startswith("Mem"):
            n = n[:i]
    return n[:80]


def _kernel_of(name: str) -> Optional[str]:
    for k, subs in KERNELS.items():
        if any(s in name for s in subs):
            return k
    return None


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def reduce(events, a: int, b: int, top: int = 10) -> DeviceTrace:
    """Reduce kineto events to a ``DeviceTrace`` over [a, b] (ns)."""
    dev, host = [], []
    for e in events:
        s = e.start_ns()
        t = s + e.duration_ns()
        if t <= a or s >= b:
            continue
        if str(e.device_type()).endswith("CUDA"):
            dev.append((s, t, e.name(), e.correlation_id()))
        else:
            host.append((s, t, e.name()))
    union = _union([(max(s, a), min(t, b)) for s, t, _, _ in dev])
    busy = sum(t - s for s, t in union)

    by_name: Dict[str, float] = {}
    for s, t, name, _ in dev:
        key = short_name(name)
        by_name[key] = by_name.get(key, 0.0) + (min(t, b) - max(s, a)) / 1e9
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]

    gaps = []
    edges = [(a, a)] + union + [(b, b)]
    for (_, e0), (s1, _) in zip(edges, edges[1:]):
        if s1 > e0:
            gaps.append((e0, s1))
    gaps.sort(key=lambda g: g[0] - g[1])
    idle = []
    for g0, g1 in gaps[:top]:
        best, name = 0, "no traced host op"
        for s, t, n in host:
            ov = min(t, g1) - max(s, g0)
            if ov > best and n != "ProfilerStep*":
                best, name = ov, n
        idle.append((name, (g1 - g0) / 1e9))

    groups: Dict[int, list] = {}
    for s, t, name, corr in dev:
        if corr:
            groups.setdefault(corr, []).append((s, t, name))
    steps = []
    for corr, ks in groups.items():
        if len(ks) < 2:
            continue
        s0, t1 = min(k[0] for k in ks), max(k[1] for k in ks)
        if s0 < a or t1 > b:
            continue                      # cut by the slice's edges
        k1 = [t - s for s, t, n in ks if _kernel_of(n) == "k1"]
        k2 = [t - s for s, t, n in ks if _kernel_of(n) == "k2"]
        k2_calls = sum(1 for _, _, n in ks if KERNELS["k2"][0] in n)
        steps.append(dict(start=s0, span_ns=t1 - s0,
                          kernel_ns=sum(t - s for s, t, _ in ks),
                          kernels=len(ks), k1_ns=k1, k2_ns=sum(k2),
                          k2_calls=k2_calls))
    steps.sort(key=lambda st: st["start"])
    return DeviceTrace(window_ns=b - a, busy_ns=busy, steps=steps,
                       device_ops=device_ops, idle_gaps=idle)
