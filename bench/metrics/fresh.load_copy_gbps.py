"""Bytes over seconds of the window's ``weights.copy`` work spans: each
``WeightStore.load``'s allocation and host-to-device copies, up to its
stream wait, with the arrays' bytes.  From the program's process tracer
(``repro_torch.telemetry.recorder``): spans begun in the window and not
under the profiler; None where the program has no such tracer or
recorded no such span."""

NAME = "weights.copy"


def read(run):
    try:
        from repro_torch.telemetry.recorder import between, process_tracer
    except ImportError:
        return None
    w = run["window"]
    spans = [s for s in between(process_tracer().work_spans(), w.t0,
                                w.t0 + w.seconds) if s.name == NAME]
    secs = sum(s.duration for s in spans)
    if not spans or secs <= 0:
        return None
    return sum(s.nbytes for s in spans) / secs / 1e9
