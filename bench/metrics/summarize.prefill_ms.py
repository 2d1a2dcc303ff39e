"""Device ms per replayed prefill: the summed durations of one replay's
kernels on the profiler's device clock, averaged over the prefill replays
(one K1 per layer) in the slice."""
from bench.harness.steps import prefills


def read(run):
    steps = prefills(run)
    if not steps:
        return None
    return sum(s["kernel_ns"] for s in steps) / len(steps) / 1e6
