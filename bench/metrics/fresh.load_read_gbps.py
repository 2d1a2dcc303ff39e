"""Bytes over seconds of the window's ``weights.read`` work spans: each
``WeightStore.load``'s read of the checkpoint's ``.npz`` into host arrays,
with the file's bytes.  From the program's process tracer
(``repro_torch.telemetry.recorder``): spans begun in the window and not
under the profiler; None where the program has no such tracer or
recorded no such span."""

NAME = "weights.read"


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
