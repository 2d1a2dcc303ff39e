"""Mean, over the window's timer invocations (``counters["timers"]``), of
their summed ``plan.*`` phases: what each invocation's own thread spent
running plan entries inline or waiting for freshen's.  Read from the
program's process tracer (``repro_torch.telemetry.recorder``): invocation
spans begun in the window and not under the profiler; None where the
program has no such tracer or recorded no such span."""


def read(run):
    try:
        from repro_torch.telemetry.recorder import between, process_tracer
    except ImportError:
        return None
    w, timers = run["window"], set(run["counters"].get("timers") or ())
    spans = [s for s in between(process_tracer().spans(), w.t0,
                                w.t0 + w.seconds)
             if s.fn in timers and "execute" in s.phase_seconds()]
    if not spans:
        return None
    plan = [sum(v for k, v in s.phase_seconds().items()
                if k.startswith("plan.")) for s in spans]
    return 1e3 * sum(plan) / len(plan)
