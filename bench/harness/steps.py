"""The replayed steps of a traced slice, as the per-layer readers see them."""
from __future__ import annotations

from typing import List, Optional, Tuple


def layers(run) -> int:
    return int(run["config"]["model"]["num_hidden_layers"])


def prefills(run) -> List[dict]:
    """Score or prefill replays: one K1 per layer."""
    t = run["trace"]
    if t is None:
        return []
    L = layers(run)
    return [s for s in t.steps if len(s["k1_ns"]) == L]


def decodes_with_pos(run) -> Optional[List[Tuple[dict, int]]]:
    """Decode replays (one K2 per layer) with the position each decoded,
    counted from the prefills in the slice: the j-th decode after a
    prefill of S tokens is at position S + j - 1, and the decodes before
    the slice's first prefill end a request at S + n_tok - 2.  None when
    the slice holds no prefill to count from."""
    t = run["trace"]
    if t is None:
        return None
    L = layers(run)
    S, n_tok = run["counters"]["prompt_len"], run["counters"]["n_tok"]
    seq = [s for s in t.steps
           if len(s["k1_ns"]) == L or s["k2_calls"] == L]
    first = next((i for i, s in enumerate(seq) if len(s["k1_ns"]) == L), None)
    if first is None:
        return None
    out = []
    for back, s in enumerate(reversed(seq[:first])):
        out.append((s, S + n_tok - 2 - back))
    j = 0
    for s in seq[first:]:
        if len(s["k1_ns"]) == L:
            j = 0
            continue
        j += 1
        out.append((s, S + j - 1))
    return out
