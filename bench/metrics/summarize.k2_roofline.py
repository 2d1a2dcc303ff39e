"""K2's share of its roofline in the replayed decode steps of
deepseek-summarize, at MLA's shape (Hkv = H, dk = nope + rope, dv):
every call's bound at its step's position (``bench/roofline/mla_moe.py``)
over the calls' device time (the split and the merge kernel)."""
from bench.harness.steps import decodes_with_pos
from bench.roofline.counts import bound_s
from bench.roofline.mla_moe import k2


def read(run):
    steps = decodes_with_pos(run)
    if not steps:
        return None
    m, B = run["config"]["model"], run["config"]["endpoint"]["batch"]
    least = sum(s["k2_calls"] * bound_s(*k2(m, B, pos))[0]
                for s, pos in steps)
    busy = sum(s["k2_ns"] for s, _ in steps) / 1e9
    return 100.0 * least / busy if busy > 0 else None
