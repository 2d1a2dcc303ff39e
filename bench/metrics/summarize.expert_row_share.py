"""The share of the expert rows the MoE dispatch computed that carry a
routed assignment: the routed (token, expert) pairs over the capacity rows
computed, summed over the prefill and decode replays begun in the window
(their expert-row records, fixed at each step's capture).  From the
program's process tracer (``repro_torch.telemetry.recorder``): records
begun in the window and not under the profiler; None where the program
keeps no such records."""


def read(run):
    try:
        from repro_torch.telemetry.recorder import between, process_tracer
        records = process_tracer().row_records()
    except (ImportError, AttributeError):
        return None
    w = run["window"]
    mine = between(records, w.t0, w.t0 + w.seconds)
    rows = sum(r.rows for r in mine)
    if not rows:
        return None
    return 100.0 * sum(r.assignments for r in mine) / rows
