#!/usr/bin/env python3
"""The readings a cell's correctness limits are set from, on the card.

  python3 bench/calibrate.py --workload granite-fresh --seeds 1,2,3 --seconds 45

For each seed, one run of the cell at its own size and load, then its
compared numbers twice: the program's answers against the float32
reference (the lower reading), and the control, the reference itself in
float8 (e4m3, one scale per tensor) in the program's place (the upper
reading).  The reference is the cell's configuration's own, the module
its ``reference`` key names.  One JSON line per seed.  The benchmark's own
runs never run the control.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def row_spread(cell, seed, w, device) -> dict:
    """A scoring cell's row errors, the program's and the control's: the
    mean, and the five largest, each with its row's smallest top-k margin
    over the expert layers at its last position on the reference's side
    (the look behind the limit: how near a tie the worst rows route)."""
    import torch

    from bench.harness import check
    from bench.harness.weights import make_weights
    ref, m = cell.reference, cell.config["model"]
    W = make_weights(ref, m, getattr(torch, cell.config["dtype"]), seed,
                     device)
    near = []
    for i in sorted(w.answers):
        toks = torch.as_tensor(w.inputs[i], device=device)
        B, S = toks.shape
        margins: list = []
        ref.forward(m, W, toks, last_only=True, margins=margins)
        near += [min((float(mg[r * S + S - 1]) for mg in margins),
                     default=None) for r in range(B)]
    out = {}
    for side, precision in (("program", "float32"), ("control_fp8", "fp8")):
        errs = check.row_errors(ref, m, W, w, device, precision)
        order = sorted(range(len(errs)), key=errs.__getitem__)[::-1]
        out[side] = {"rows": len(errs), "mean": sum(errs) / len(errs),
                     "top5": [[errs[j], near[j]] for j in order[:5]]}
    margins = sorted(x for x in near if x is not None)
    out["median_margin"] = margins[len(margins) // 2] if margins else None
    del W
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    from bench.harness import cells, check, spec
    if not torch.cuda.is_available():
        print("calibration needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.load(args.workload, ROOT)
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        w, prog = cells.DRIVERS[cell.mix["entry"]](
            cell, seed, args.seconds, False, device)
        prog.close()
        print(json.dumps({
            "seed": seed, "answers": len(w.answers), "failed": w.failed,
            "program": check.judge(cell, seed, w, device),
            "control_fp8": check.judge(cell, seed, w, device,
                                       precision="fp8")}), flush=True)
        if cell.mix["entry"] == "functions":
            print(json.dumps(dict(seed=seed, **row_spread(cell, seed, w,
                                                          device))),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
