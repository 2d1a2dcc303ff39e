#!/usr/bin/env python3
"""Run one benchmark cell once and print its result as the last line.

  python3 bench/run.py --workload granite-fresh --seed 7 --seconds 45 --trace 0

From the root of a checkout, on a machine with the cards the cell asks
for.  ``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1``
its per-layer metrics from a profiler slice of the window.  Everything
the run needs is made from ``--seed``; the program under test is the
PyTorch/CUDA package ``repro_torch`` under ``src/``.
"""
from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None) -> list:
    """The top-level names, compared whole, of loaded modules (or of
    ``names``) that are JAX's or the JAX package's."""
    names = list(sys.modules) if names is None else names
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _metric(value, unit):
    return {"value": value, "unit": unit}


def end_to_end(cell, w, setup_s) -> dict:
    units = {m["name"]: m["unit"] for m in cell.end_to_end}
    out = {}
    for name in units:
        if name == "setup_s":
            v = setup_s
        elif name == "timer_invoke_mean_ms":
            v = latency_report(w.counters)["timers"]["mean_ms"]
        elif name == "tokens_per_s":
            v = w.tokens / (w.last_done - w.t0)
        elif name == "device_gb_s_per_invoke":
            v = w.counters["device_byte_s"] / 1e9 / w.counters["invokes"]
        else:
            raise KeyError(f"no measurement for end-to-end metric {name!r}")
        out[name] = _metric(v, units[name])
    return out


def latency_report(counters) -> dict:
    """Invocation latency (due to answer, ms) by kind of function, beside
    the cell's metrics: all invokes, the timers' and the others'."""
    import numpy as np
    by_fn = counters["latency_by_fn"]
    groups = {"all": [x for v in by_fn.values() for x in v],
              "timers": [x for n in counters["timers"] for x in by_fn[n]],
              "others": [x for n, v in by_fn.items()
                         if n not in counters["timers"] for x in v]}
    out = {}
    for g, v in groups.items():
        if v:
            a = np.asarray(v, np.float64) * 1e3
            out[g] = {"n": len(v), "mean_ms": float(a.mean()),
                      "p50_ms": float(np.percentile(a, 50)),
                      "p95_ms": float(np.percentile(a, 95)),
                      "max_ms": float(a.max())}
    return out


def per_layer(cell, run) -> dict:
    units = {m["name"]: m["unit"] for m in cell.per_layer}
    out = {}
    for name, read in cell.readers.items():
        v = read(run)
        if v is not None:
            out[name] = _metric(v, units[name])
    return out


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> dict:
    """One run of ``cell``: set-up, window, metrics, the program freed,
    then the check.  Returns the result line's object."""
    import torch

    from bench.harness import cells, check, devtrace
    if trace:
        devtrace.warm_profiler(device)
    driver = cells.DRIVERS[cell.mix["entry"]]
    w, prog = driver(cell, seed, seconds, trace, device)
    setup_s = w.t0 - t_start
    last = t_start
    for stage, t in prog.marks + [("settle", w.t0)]:
        print(f"setup {stage} {t - last:.3f} s", file=sys.stderr)
        last = t
    try:
        run = dict(config=cell.config, mix=cell.mix, window=w,
                   trace=w.trace, counters=w.counters)
        metrics = (per_layer(cell, run) if trace
                   else end_to_end(cell, w, setup_s))
    finally:
        prog.close()
    numbers = check.judge(cell, seed, w, device)
    correct, table = check.verdict(numbers, cell.limits)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": kind, "count": cell.chips,
                   "memory_peak_bytes": w.memory_peak}
    result = {"correct": correct, "attempted": w.attempted,
              "failed": w.failed, "metrics": metrics, "device": device_info}
    if trace and w.trace is not None:
        device_info["busy_s"] = w.trace.busy_ns / 1e9
        device_info["window_s"] = w.trace.window_ns / 1e9
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in w.trace.device_ops],
            "idle_gaps": [[n, s] for n, s in w.trace.idle_gaps]}
    late = sorted(w.late) or [0.0]
    result["load"] = {"sent": len(w.late),
                      "late_p95_ms": (statistics.quantiles(late, n=20)[-1]
                                      if len(late) > 1 else late[0]) * 1e3,
                      "late_max_ms": late[-1] * 1e3}
    if "latency_by_fn" in w.counters:
        result["latency"] = latency_report(w.counters)
    result["check"] = table
    for e in w.errors:
        print(f"request failed: {e}", file=sys.stderr)
    return result


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    from bench.harness import spec
    cell = spec.load(args.workload, ROOT)
    found = (torch.cuda.device_count() if torch.cuda.is_available() else 0)
    if found < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); found "
              f"{found}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T_START)
    loaded = forbidden_modules()
    if loaded:
        print(f"modules of JAX or the JAX package were loaded: {loaded}",
              file=sys.stderr)
        return 3
    for k, v in result["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
