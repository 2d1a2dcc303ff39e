"""Exporters: span ring buffers -> Chrome trace-event JSON.

The mapping (documented in docs/benchmarks.md "Trace export schema"):

* Each completed invocation is a complete event (``ph: "X"``) named
  ``invoke:<fn>`` on ``pid=1`` ("invocations"), ``tid`` = the worker
  thread that drove it; its phase children are nested ``"X"`` events on
  the same lane (Chrome nests by time containment).
* Each terminal freshen-lifecycle span is an ``"X"`` event named
  ``freshen:<fn>`` on ``pid=2`` ("freshen"), one ``tid`` lane per
  outcome (landed/expired/gated), spanning predicted-at -> terminal.
  Its predicted arrival anchor is an instant event (``ph: "i"``).
* A landed freshen emits a flow arrow (``ph: "s"`` at the freshen,
  ``ph: "f"`` at the linked invocation's start) with ``id`` = the
  freshen span id — in Perfetto the arrow points from the prewarm to
  the arrival it anchored.

Timestamps: span clocks are monotonic *seconds*; trace-event ``ts`` /
``dur`` are microseconds.  The earliest span start is rebased to 0 so
traces are readable regardless of process uptime.
"""
from __future__ import annotations

from typing import Iterable, List

_US = 1e6

_OUTCOME_TID = {"landed": 1, "expired": 2, "gated": 3, "pending": 4}


def chrome_trace_events(spans: Iterable, freshens: Iterable) -> List[dict]:
    """Build the Chrome trace-event list for completed invocation spans
    and terminal freshen spans (objects from ``repro_torch.telemetry.tracer``)."""
    spans = list(spans)
    freshens = list(freshens)

    starts = [s.start for s in spans] + [f.start for f in freshens]
    base = min(starts) if starts else 0.0

    def us(t: float) -> float:
        return (t - base) * _US

    events: List[dict] = [
        {"ph": "M", "pid": 1, "name": "process_name",
         "args": {"name": "invocations"}},
        {"ph": "M", "pid": 2, "name": "process_name",
         "args": {"name": "freshen"}},
    ]
    for outcome, tid in _OUTCOME_TID.items():
        events.append({"ph": "M", "pid": 2, "tid": tid,
                       "name": "thread_name", "args": {"name": outcome}})

    for sp in spans:
        if sp.end is None:
            continue
        tid = sp.thread_id % 10_000  # readable lane ids
        events.append({
            "ph": "X", "pid": 1, "tid": tid, "name": f"invoke:{sp.fn}",
            "cat": "invocation", "ts": us(sp.start),
            "dur": max(0.0, (sp.end - sp.start) * _US),
            "args": {"id": sp.span_id, "app": sp.app, **sp.attrs,
                     "linked_freshens": list(sp.linked_freshens)},
        })
        for ph in sp.phases:
            if ph.end is None:
                continue
            events.append({
                "ph": "X", "pid": 1, "tid": tid, "name": ph.name,
                "cat": "phase", "ts": us(ph.start),
                "dur": max(0.0, (ph.end - ph.start) * _US),
                # "span" keys the phase to its invocation: lanes are
                # tid%10000, so viewers must not rely on time
                # containment alone (lane collisions across executors)
                "args": {"span": sp.span_id, **ph.attrs},
            })

    inv_by_id = {sp.span_id: sp for sp in spans}
    for fs in freshens:
        end = fs.end if fs.end is not None else fs.predicted_for
        tid = _OUTCOME_TID.get(fs.outcome, 4)
        events.append({
            "ph": "X", "pid": 2, "tid": tid, "name": f"freshen:{fs.fn}",
            "cat": "freshen", "ts": us(fs.start),
            "dur": max(0.0, (end - fs.start) * _US),
            "args": {"id": fs.span_id, "outcome": fs.outcome,
                     "level": fs.level, "confidence": fs.confidence,
                     "reason": fs.reason,
                     "linked_invocation": fs.linked_invocation},
        })
        events.append({
            "ph": "i", "pid": 2, "tid": tid, "s": "t",
            "name": f"predicted:{fs.fn}", "cat": "freshen",
            "ts": us(fs.predicted_for),
        })
        if fs.outcome == "landed" and fs.linked_invocation is not None:
            inv = inv_by_id.get(fs.linked_invocation)
            events.append({
                "ph": "s", "pid": 2, "tid": tid, "cat": "freshen_link",
                "name": "freshen->arrival", "id": fs.span_id,
                "ts": us(fs.start),
            })
            if inv is not None:
                events.append({
                    "ph": "f", "pid": 1, "tid": inv.thread_id % 10_000,
                    "cat": "freshen_link", "name": "freshen->arrival",
                    "id": fs.span_id, "bp": "e", "ts": us(inv.start),
                })
    return events
