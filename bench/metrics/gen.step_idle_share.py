"""Median, over the window's decode steps, of the share of a step's
period the device spent outside it: 1 - device ms / period, where the
device ms run from the step's graph starting to its argmax done (the
program's CUDA events) and its period runs from its host start to the
next step's of the same generation.
From the program's process tracer (``repro_torch.telemetry.recorder``):
records begun in the window and not under the profiler; None where the
program has no such tracer, or its records hold no device time (on the
CPU)."""
import statistics


def read(run):
    try:
        from repro_torch.telemetry.recorder import between, process_tracer
    except ImportError:
        return None
    w = run["window"]
    steps = process_tracer().decode_steps()
    nxt = {(d.gen, d.pos): d.start for d in steps}
    shares = []
    for d in between(steps, w.t0, w.t0 + w.seconds):
        t = nxt.get((d.gen, d.pos + 1))
        if d.device_ms is not None and t is not None and t > d.start:
            shares.append(1.0 - d.device_ms / 1e3 / (t - d.start))
    if not shares:
        return None
    return 100.0 * statistics.median(shares)
