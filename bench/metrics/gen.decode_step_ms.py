"""Device ms per replayed decode step: the summed durations of one
replay's kernels on the profiler's device clock (its device busy time;
the gaps between a graph's kernels widen under the profiler, so they are
left out), averaged over the decode replays in the slice."""
from bench.harness.steps import decodes_with_pos


def read(run):
    steps = decodes_with_pos(run)
    if not steps:
        return None
    return sum(s["kernel_ns"] for s, _ in steps) / len(steps) / 1e6
