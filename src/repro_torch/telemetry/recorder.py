"""The port's process tracer: the invocation tracer taken below the
invocation, on the clock of the device trace.

``Recorder`` is a ``Tracer`` (``telemetry/tracer.py``, the reference's
own) with two more bounded rings, and ``process_tracer()`` is the one
instance of a process: ``ServingEngine`` and ``ModelEndpoint`` record into
it when they are given no tracer, and an operator or a benchmark reads it
the way it would read a default metrics registry.  An explicitly passed
tracer, ``NULL_TRACER`` included, wins.  ``enabled`` is the one switch; it
is on by default.

Names it records, beside the reference's invocation phases (``route``,
``queue``, ``acquire``, ``boot_process``, ``boot_init``, ``warm_to``,
``run``, ``release``) and freshen-lifecycle spans:

* invocation phases that ``ModelEndpoint.code`` adds inside ``run``, on
  the thread that runs the invocation:

      plan.weights   FrFetch(0): the weights entry, run inline or waited for
      plan.compile   FrFetch(1): the score step's executable
      plan.warmup    FrWarm(2): the score step bound to the params
      plan.capture   the bind the invoke did itself, where the warm budget
                     held the warm-up back (only when it captured)
      execute        the prefetch entry, the step and its logits' read

  ``ModelEndpoint.code`` and ``generate`` annotate the invocation span with
  ``instance``, the key of the instance that served it.

* work spans, one per run of a plan entry's thunk, wherever it runs:

      weights.load         the weights entry (``WeightStore.load``)
        weights.read       its ``.npz`` read into host arrays
                           (``nbytes``: the file's size)
        weights.copy       allocation and the host-to-device copies, up to
                           the stream wait (``nbytes``: the arrays' bytes)
      compile              the score step's executable
      warmup               the score step bound to the params (captured)
      decode_executables   a generation endpoint's session steps
      session_cache        its preallocated decode cache
      session_graphs       its steps bound to the params and cache

  Each carries ``fn`` (the endpoint), ``instance`` (``instance_key`` of the
  instance it ran for), ``thread``, ``parent`` (the work span open around
  it on the thread, or None) and ``via``: the id of the invocation span
  whose thread ran it inline, or ``"freshen"`` when it ran on a thread
  with no invocation (a freshen thread, or a blocking freshen).

* decode-step records, one per step of ``ModelEndpoint.generate``: the
  position it decoded, its host start (before the copy into the step's
  graph) and host end (after its token was read), and the device
  milliseconds from the event its graph records as the replay starts to
  one recorded on its stream after its argmax (None on the CPU;
  ``DecodeTimer``).  ``gen`` numbers the generation it belongs to.

Every span and record begun while a torch profiler runs carries
``profiled``: its times hold the profiler's own cost.

The shared clock.  Spans keep the tracer's clock, the host monotonic clock
the benchmark's window uses.  The recorder also holds the offset from it
to the clock of ``torch.profiler``'s events (the host's real-time clock,
``time.time_ns``), read from back-to-back clock pairs and read again once
it is ``OFFSET_EVERY`` seconds old; each span and record keeps the offset
of its start, so ``dev_ns(t)`` puts its times on the device trace's clock
and an idle gap of a profiler trace can be put down to the span open over
it.  ``export_chrome`` writes them with those nanoseconds in ``args``.
"""
from __future__ import annotations

import itertools
import json
import sys
import threading
import time
import weakref
from collections import deque
from typing import Callable, Iterable, List, Optional, Union

from repro_torch.telemetry.tracer import (NULL_SPAN, Tracer, current_span)
from repro_torch.telemetry.export import chrome_trace_events

_US = 1e6
OFFSET_EVERY = 1.0          # seconds an offset to the device clock is kept

_tls = threading.local()


def profiler_running() -> bool:
    """Whether a torch profiler is recording (the flag ``models/moe.py``'s
    stage ranges test); False where torch's profiler was never imported."""
    prof = sys.modules.get("torch.autograd.profiler")
    return bool(prof is not None and prof._is_profiler_enabled)


def read_offset_ns() -> int:
    """Real-time ns minus monotonic ns, from the tightest of three
    back-to-back reads (the real-time read taken against the midpoint of
    the two monotonic reads around it)."""
    best = None
    for _ in range(3):
        m0 = time.monotonic_ns()
        r = time.time_ns()
        m1 = time.monotonic_ns()
        if best is None or m1 - m0 < best[0]:
            best = (m1 - m0, r - (m0 + m1) // 2)
    return best[1]


def dev_ns(t: float, offset_ns: int) -> int:
    """Host monotonic seconds ``t`` on the device trace's clock (ns)."""
    return int(round(t * 1e9)) + offset_ns


def _stack() -> list:
    st = getattr(_tls, "work", None)
    if st is None:
        st = _tls.work = []
    return st


class _NullWork:
    """The work span of a disabled tracer: records nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_WORK = _NullWork()


class WorkSpan:
    """One run of a plan entry's thunk (or a part of one), opened and
    closed by ``with`` on the thread that runs it."""
    __slots__ = ("recorder", "span_id", "name", "parent", "fn", "instance",
                 "thread", "via", "start", "end", "nbytes", "profiled",
                 "offset_ns", "attrs")

    def __init__(self, recorder: "Recorder", span_id: int, name: str,
                 parent: Optional["WorkSpan"], fn, instance, nbytes,
                 attrs: dict):
        inv = current_span()
        self.recorder = recorder
        self.span_id = span_id
        self.name = name
        self.parent = parent.span_id if parent is not None else None
        self.fn = fn if fn is not None or parent is None else parent.fn
        self.instance = (instance if instance is not None or parent is None
                         else parent.instance)
        self.thread = threading.get_ident()
        self.via = inv.span_id if inv is not None else "freshen"
        self.nbytes = nbytes
        self.attrs = attrs
        self.profiled = profiler_running()
        self.offset_ns = recorder.offset_ns()
        self.end: Optional[float] = None
        self.start = recorder.clock()

    def __enter__(self):
        _stack().append(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        self.end = self.recorder.clock()
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        _stack().pop()
        self.recorder._finish_work(self)
        return False

    @property
    def duration(self) -> float:
        return (self.end - self.start) if self.end is not None else 0.0


class DecodeStep:
    """One decode step of ``ModelEndpoint.generate``."""
    __slots__ = ("gen", "fn", "instance", "thread", "pos", "start", "end",
                 "device_ms", "profiled", "offset_ns")

    def __init__(self, gen, fn, instance, thread, pos, start, end,
                 device_ms, profiled, offset_ns):
        self.gen, self.fn, self.instance = gen, fn, instance
        self.thread, self.pos = thread, pos
        self.start, self.end = start, end
        self.device_ms, self.profiled = device_ms, profiled
        self.offset_ns = offset_ns


class DecodeTimer:
    """Times the decode steps of one generation: made once the step
    before the first (the prefill) is enqueued, then ``begin()`` before a
    step's copy-in, ``stepped()`` once the step, its argmax and its next
    position are enqueued, ``end(pos)`` once its token has been read, and
    ``close()`` after the last step.

    On a card a step's device milliseconds run from ``started``, the
    event the step's graph records on the device as each replay starts
    (``BoundStep.started``), to an event recorded on the stream after its
    argmax: the host's copy-in and launch, before the graph starts, count
    as idle.  Every event is read in ``stepped``, while the device runs
    the step just launched, never between a token's read and the next
    launch (a read there costs the loop 8-30 us on an H100).  The next
    replay records ``started`` again, so ``stepped`` reads it at once, as
    the gap from the previous step's end; the step's device ms are its
    end less the previous step's end less that gap, read at the next
    ``stepped`` (or ``close``), when the step is kept.  Two end events,
    made once a generation, take turns."""
    __slots__ = ("recorder", "gen", "fn", "instance", "thread", "_started",
                 "_ends", "_stream", "_k", "_gap", "_start", "_profiled",
                 "_offset", "_pending")

    def __init__(self, recorder: "Recorder", fn, instance, device,
                 started=None):
        self.recorder = recorder
        self.gen = recorder._next_id()
        self.fn, self.instance = fn, instance
        self.thread = threading.get_ident()
        self._started = self._ends = self._stream = None
        self._k = 0                 # the end event of the previous step
        if started is not None:             # a captured graph's, on a card
            import torch
            self._started = started
            self._stream = torch.cuda.current_stream(device)
            self._ends = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            self._ends[0].record(self._stream)      # the prefill's end
        self._gap = None
        self._start = 0.0
        self._profiled = False
        self._offset = recorder.offset_ns()
        self._pending = None

    def begin(self) -> None:
        self._profiled = profiler_running()
        self._start = self.recorder.clock()

    def stepped(self) -> None:
        self._finish()
        if self._ends is None:
            return
        prev, end = self._ends[self._k], self._ends[self._k ^ 1]
        end.record(self._stream)
        self._started.synchronize()
        self._gap = prev.elapsed_time(self._started)
        self._k ^= 1

    def end(self, pos: int) -> None:
        self._pending = (pos, self._start, self.recorder.clock(),
                         self._profiled, self._gap)

    def close(self) -> None:
        """Keep the last step's record."""
        self._finish()

    def _finish(self) -> None:
        if self._pending is None:
            return
        pos, start, end, profiled, gap = self._pending
        self._pending = None
        ms = None
        if self._ends is not None:
            # the previous step's end to this one's, less the gap
            last = self._ends[self._k]
            ms = self._ends[self._k ^ 1].elapsed_time(last) - gap
        self.recorder._add_decode(DecodeStep(
            self.gen, self.fn, self.instance, self.thread, pos, start, end,
            ms, profiled, self._offset))


class Recorder(Tracer):
    """The reference's ``Tracer`` with work spans and decode-step records,
    each in its own bounded ring, and the offset to the device trace's
    clock (module docstring)."""

    def __init__(self, capacity: int = 4096,
                 clock: Callable[[], float] = time.monotonic,
                 enabled: bool = True, horizon: float = 5.0,
                 work_capacity: int = 4096, decode_capacity: int = 16384):
        super().__init__(capacity=capacity, clock=clock, enabled=enabled,
                         horizon=horizon)
        self._ring_lock = threading.Lock()
        self._work: deque = deque(maxlen=work_capacity)
        self._decode: deque = deque(maxlen=decode_capacity)
        self._record_ids = itertools.count(1)
        self._instance_ids = itertools.count(1)
        self._instances: "weakref.WeakKeyDictionary" = \
            weakref.WeakKeyDictionary()
        self._tracked = 0                 # freshens tracked since a sweep
        self.dropped_records = 0          # work/decode evicted by a ring
        self._offset = (self.clock(), read_offset_ns())

    # -- the shared clock -----------------------------------------------
    def offset_ns(self) -> int:
        """The offset to the device trace's clock, read again once it is
        ``OFFSET_EVERY`` seconds old on this tracer's clock."""
        at, off = self._offset
        now = self.clock()
        if not 0.0 <= now - at < OFFSET_EVERY:
            off = read_offset_ns()
            self._offset = (now, off)
        return off

    def _next_id(self) -> int:
        with self._ring_lock:
            return next(self._record_ids)

    def instance_key(self, runtime) -> int:
        """A small number for an instance's ``Runtime``, stable while it
        lives and never given to another in this process."""
        with self._ring_lock:
            key = self._instances.get(runtime)
            if key is None:
                key = self._instances[runtime] = next(self._instance_ids)
            return key

    # -- spans and records ------------------------------------------------
    def invocation(self, fn: str, app: str = "default", **attrs):
        """The reference's invocation span, with the device-clock offset
        of its start and ``profiled`` where a profiler runs."""
        if not self.enabled:
            return NULL_SPAN
        if profiler_running():
            attrs["profiled"] = True
        return super().invocation(fn, app=app, offset_ns=self.offset_ns(),
                                  **attrs)

    def _track_freshen(self, span):
        """Track a dispatched freshen; every ``capacity`` of them, expire
        those whose horizon passed, so the pending table of a process that
        lives on stays bounded (an arrival only resolves its own
        function's)."""
        super()._track_freshen(span)
        with self._ring_lock:
            self._tracked += 1
            sweep = self._tracked >= max(self.capacity, 1)
            if sweep:
                self._tracked = 0
        if sweep:
            self.sweep_expired()

    def work(self, name: str, fn=None, instance=None, nbytes=None,
             **attrs) -> Union[WorkSpan, _NullWork]:
        """A work span, opened by ``with`` on the thread that does the
        work; a child of the work span open on that thread, if any."""
        if not self.enabled:
            return NULL_WORK
        st = _stack()
        parent = st[-1] if st else None
        return WorkSpan(self, self._next_id(), name, parent, fn, instance,
                        nbytes, attrs)

    def _finish_work(self, span: WorkSpan) -> None:
        with self._ring_lock:
            if len(self._work) == self._work.maxlen:
                self.dropped_records += 1
            self._work.append(span)

    def decode_timer(self, fn, instance, device,
                     started=None) -> Optional[DecodeTimer]:
        """A ``DecodeTimer`` for one generation, or None when disabled;
        ``started`` is the decode step's ``BoundStep.started``."""
        if not self.enabled:
            return None
        return DecodeTimer(self, fn, instance, device, started)

    def _add_decode(self, step: DecodeStep) -> None:
        with self._ring_lock:
            if len(self._decode) == self._decode.maxlen:
                self.dropped_records += 1
            self._decode.append(step)

    # -- views ------------------------------------------------------------
    def work_spans(self) -> List[WorkSpan]:
        """Finished work spans, oldest first (ring snapshot)."""
        with self._ring_lock:
            return list(self._work)

    def decode_steps(self) -> List[DecodeStep]:
        """Decode-step records, oldest first (ring snapshot)."""
        with self._ring_lock:
            return list(self._decode)

    def clear(self):
        super().clear()
        with self._ring_lock:
            self._work.clear()
            self._decode.clear()
            self.dropped_records = 0

    def _chrome_events(self) -> List[dict]:
        """The reference's Chrome events, with work spans and decode
        records added on their threads' lanes (``pid`` 1), every event
        rebased to the earliest start of them all, and each span's and
        record's device-clock ns in ``args["dev_ns"]``."""
        spans = self.spans()
        freshens = self.freshen_spans()
        work = self.work_spans()
        decode = self.decode_steps()
        events = chrome_trace_events(spans, freshens)
        old = [s.start for s in spans] + [f.start for f in freshens]
        new = [w.start for w in work] + [d.start for d in decode]
        if not old + new:
            return events
        base = min(old + new)
        shift = (min(old) - base) * _US if old else 0.0
        inv = {sp.span_id: sp for sp in spans}
        offset = self.offset_ns()
        for ev in events:
            if "ts" not in ev:
                continue
            ev["ts"] += shift
            t = ev["ts"] / _US + base
            args = ev.setdefault("args", {})
            owner = inv.get(args.get("id") if ev.get("cat") == "invocation"
                            else args.get("span"))
            off = owner.attrs.get("offset_ns", offset) if owner else offset
            args["dev_ns"] = dev_ns(t, off)

        def us(t: float) -> float:
            return (t - base) * _US
        for w in work:
            if w.end is None:
                continue
            events.append({
                "ph": "X", "pid": 1, "tid": w.thread % 10_000,
                "name": w.name, "cat": "work", "ts": us(w.start),
                "dur": max(0.0, (w.end - w.start) * _US),
                "args": {"id": w.span_id, "parent": w.parent, "fn": w.fn,
                         "instance": w.instance, "via": w.via,
                         "nbytes": w.nbytes, "profiled": w.profiled,
                         "dev_ns": dev_ns(w.start, w.offset_ns),
                         "dev_end_ns": dev_ns(w.end, w.offset_ns),
                         **w.attrs}})
        for d in decode:
            events.append({
                "ph": "X", "pid": 1, "tid": d.thread % 10_000,
                "name": "decode", "cat": "decode", "ts": us(d.start),
                "dur": max(0.0, (d.end - d.start) * _US),
                "args": {"gen": d.gen, "pos": d.pos, "fn": d.fn,
                         "instance": d.instance, "device_ms": d.device_ms,
                         "profiled": d.profiled,
                         "dev_ns": dev_ns(d.start, d.offset_ns),
                         "dev_end_ns": dev_ns(d.end, d.offset_ns)}})
        return events

    def export_chrome(self, path: str) -> int:
        """Write the reference's Chrome events with the work spans and
        decode records added (``_chrome_events``); returns the event
        count."""
        events = self._chrome_events()
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
        return len(events)


_PROCESS = Recorder()


def process_tracer() -> Recorder:
    """The process's recorder (module docstring)."""
    return _PROCESS


def recorder_of(tracer) -> Optional[Recorder]:
    """``tracer`` where it is an enabled ``Recorder``, else None: a plain
    ``Tracer`` keeps invocation spans only."""
    if isinstance(tracer, Recorder) and tracer.enabled:
        return tracer
    return None


def child(name: str, **kw) -> Union[WorkSpan, _NullWork]:
    """A work span under the one open on this thread, in its recorder;
    nothing where none is open."""
    st = _stack()
    return st[-1].recorder.work(name, **kw) if st else NULL_WORK


def between(records: Iterable, t0: float, t1: float) -> list:
    """The records whose start lies in [t0, t1], those begun under a
    profiler left out (a reader's window)."""
    out = []
    for r in records:
        profiled = (r.attrs.get("profiled", False) if hasattr(r, "phases")
                    else r.profiled)
        if t0 <= r.start <= t1 and not profiled:
            out.append(r)
    return out
