"""Whether what the timed path produced is correct: the window's answers
held against the plain float32 reference, once the window has closed and
the program's state is freed.  The reference is the configuration's own,
the module its ``reference`` key names (``Cell.reference``).

The reference gets the weights anew from the seed and the inputs the
window sent; it takes nothing the program made.  Two numbers, each held
against its limit in ``bench/limits/<workload>.json``:

* ``logits_rel_err_mean`` (scoring): for every sampled answer, each
  row's ``|served - reference| / |reference|`` over the vocabulary
  (2-norms) of the last position's logits; their mean.  The mean and not
  the largest: the experts route without drops, but a random router
  leaves many top-k choices near a tie, and a rounding that flips one
  moves a few rows by 6-7%, within 2.5x of the control's largest
  (``PERF.md``);
* ``token_gap`` (generation): for every served token of every row that
  every finished request returned, by how much its reference logit lies
  below the reference's best at that position (teacher-forced over the
  row's prompt and its served tokens); the largest.

``missing`` counts answers that never came: it must be 0.
"""
from __future__ import annotations

import gc
from typing import Dict, List

import numpy as np
import torch

from bench.harness.weights import make_weights


def _rel_err(served: np.ndarray, want: torch.Tensor) -> float:
    got = torch.as_tensor(np.asarray(served, np.float32)).reshape(want.shape)
    want = want.float().cpu()
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want))


def _candidate(ref, m, W, toks, served, precision):
    """What is judged: the served logits, or for the control the
    reference's own at ``precision``."""
    if precision == "float32":
        return np.asarray(served, np.float32)
    return ref.forward(m, W, toks, last_only=True,
                       precision=precision).cpu().numpy()


def row_errors(ref, m, W, w, device, precision="float32") -> List[float]:
    """Each row's error of every sampled answer (entry ``functions``)."""
    errs = []
    for i in sorted(w.answers):
        toks = torch.as_tensor(w.inputs[i], device=device)
        want = ref.forward(m, W, toks, last_only=True)
        got = _candidate(ref, m, W, toks, w.answers[i], precision)
        errs += [_rel_err(got[r], want[r]) for r in range(toks.shape[0])]
    return errs


def scoring(ref, m, W, w, device, precision="float32") -> Dict[str, float]:
    """Full endpoint batches (entry ``functions``)."""
    return {"logits_rel_err_mean": _mean(row_errors(ref, m, W, w, device,
                                                   precision))}


def _mean(errs: List[float]) -> float:
    return sum(errs) / len(errs) if errs else float("inf")


def _gaps(ref, m, W, prompt_row, served, device, precision) -> np.ndarray:
    """Reference gap of each served token, and with ``precision`` set
    below float32 the gap of the token that precision puts first."""
    S = len(prompt_row)
    seq = np.concatenate([np.asarray(prompt_row), np.asarray(served[:-1])])
    toks = torch.as_tensor(seq[None], device=device)
    logits = ref.forward(m, W, toks)[0, S - 1:]               # (n, V)
    if precision != "float32":
        pick = ref.forward(m, W, toks, precision=precision)[0, S - 1:]
        chosen = pick.argmax(-1)
    else:
        chosen = torch.as_tensor(np.asarray(served), device=logits.device)
    best = logits.max(-1).values
    return (best - logits.gather(1, chosen.long()[:, None])[:, 0]).cpu().numpy()


def served_rows(served) -> np.ndarray:
    """A generation's answer as (rows, tokens): ``generate`` returns row
    0's tokens, a list; an answer of every row is (rows, tokens)."""
    served = np.asarray(served)
    return served[None] if served.ndim == 1 else served


def generation(ref, m, W, w, device, precision="float32"
               ) -> Dict[str, float]:
    worst = 0.0
    V = m["vocab_size"]
    for i in sorted(w.answers):
        rows = served_rows(w.answers[i])
        if rows.ndim != 2 or rows.shape[0] > len(w.inputs[i]) \
                or rows.shape[1] != w.counters["n_tok"] \
                or (rows < 0).any() or (rows >= V).any():
            worst = float("inf")
            continue
        for r, served in enumerate(rows):
            worst = max(worst, float(_gaps(ref, m, W, w.inputs[i][r],
                                           served, device, precision).max()))
    return {"token_gap": worst}


COMPARE = {"functions": scoring, "generate": generation}


def judge(cell, seed: int, w, device, precision: str = "float32"
          ) -> Dict[str, float]:
    """The cell's compared numbers, from its reference at ``precision``
    (``"fp8"``: the control), with ``missing`` beside them."""
    conf, ref = cell.config, cell.reference
    m = conf["model"]
    if device.type == "cuda":
        ref.no_tf32()
    W = make_weights(ref, m, getattr(torch, conf["dtype"]), seed, device)
    try:
        numbers = COMPARE[cell.mix["entry"]](ref, m, W, w, device, precision)
    finally:
        del W
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    numbers["missing"] = float(w.failed)
    return numbers


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}): every number within its
    limit, nothing missing."""
    limits = dict(limits, missing=0.0)
    table = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    ok = all(np.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in table.values())
    return ok, table
