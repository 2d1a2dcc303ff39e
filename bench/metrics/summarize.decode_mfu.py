"""The whole decode step's share of the chip's peak in deepseek-summarize:
each replay's least time at its position, max(FLOPs / 989 TFLOP/s,
bytes / 3.35 TB/s) from what it needs (``bench/roofline/mla_moe.py``:
attention in MLA's absorbed form, six routed experts a layer, the latent
cache to its position), summed, over the replays' kernels' summed
durations."""
from bench.harness.steps import decodes_with_pos
from bench.roofline.counts import bound_s
from bench.roofline.mla_moe import decode_step


def read(run):
    steps = decodes_with_pos(run)
    if not steps:
        return None
    m, B = run["config"]["model"], run["config"]["endpoint"]["batch"]
    least = sum(bound_s(*decode_step(m, B, pos))[0] for _, pos in steps)
    return 100.0 * least / (sum(s["kernel_ns"] for s, _ in steps) / 1e9)
