"""Trigger services (Table 1): the mechanisms that start a function, each
with a measurable trigger→start delay.  The delay window is what gives
freshen its head start (§2).

Real implementations with real threads/queues/filesystem (measured, not
constants):

* DirectTrigger   — synchronous dispatch through the invoker queue (≈ Boto3
                    direct invoke).
* StepTrigger     — orchestrator hop: completion callback → next state
                    lookup → dispatch (≈ Step Functions).
* PubSubTrigger   — topic fanout via a broker thread (≈ SNS): publish →
                    broker dequeue → subscriber dispatch.
* StorageTrigger  — spool-directory watcher polling the filesystem
                    (≈ S3 bucket notification; polling interval dominates,
                    which is exactly why S3 is the slowest row of Table 1).
"""
from __future__ import annotations
# fabriclint: allow-file[clock] -- this module *measures* real trigger
# dispatch latency; the wall clock is the instrument, not a dependency.

import os
import queue
import tempfile
import threading
import time
import uuid
from dataclasses import dataclass
from typing import Callable, List, Optional


@dataclass
class TriggerRecord:
    trigger_type: str
    fired_at: float          # timestamp just before the trigger (paper method)
    started_at: float        # timestamp at start of the triggered function

    @property
    def delay(self) -> float:
        return self.started_at - self.fired_at


class _Dispatcher(threading.Thread):
    """Worker that pulls (fired_at, fn, args) and runs fn, recording delay."""

    def __init__(self, name: str, records: List[TriggerRecord], ttype: str):
        super().__init__(name=name, daemon=True)
        self.q: queue.Queue = queue.Queue()
        self.records = records
        self.ttype = ttype
        self._stop = False
        self.start()

    def run(self):
        while not self._stop:
            try:
                item = self.q.get(timeout=0.1)
            except queue.Empty:
                continue
            fired_at, fn, args = item
            started = time.monotonic()
            self.records.append(TriggerRecord(self.ttype, fired_at, started))
            fn(args)
            self.q.task_done()

    def stop(self):
        self._stop = True


class DirectTrigger:
    def __init__(self):
        self.records: List[TriggerRecord] = []
        self._disp = _Dispatcher("direct", self.records, "direct")

    def fire(self, fn: Callable, args=None):
        self._disp.q.put((time.monotonic(), fn, args))

    def close(self):
        self._disp.stop()


class StepTrigger:
    """Orchestrator hop: an extra state-machine thread between completion and
    dispatch (one more queue handoff than direct)."""

    def __init__(self):
        self.records: List[TriggerRecord] = []
        self._disp = _Dispatcher("step-dispatch", self.records, "step")
        self._orch: queue.Queue = queue.Queue()
        self._th = threading.Thread(target=self._orchestrate, daemon=True)
        self._stop = False
        self._th.start()

    def _orchestrate(self):
        while not self._stop:
            try:
                fired_at, fn, args = self._orch.get(timeout=0.1)
            except queue.Empty:
                continue
            # state-machine bookkeeping: resolve next state, check guards
            _ = uuid.uuid4()
            self._disp.q.put((fired_at, fn, args))

    def fire(self, fn: Callable, args=None):
        self._orch.put((time.monotonic(), fn, args))

    def close(self):
        self._stop = True
        self._disp.stop()


class PubSubTrigger:
    """Topic broker with fanout to subscriber dispatchers."""

    def __init__(self, fanout_latency: float = 0.002):
        self.records: List[TriggerRecord] = []
        self.fanout_latency = fanout_latency
        self._subs: List[_Dispatcher] = []
        self._topic: queue.Queue = queue.Queue()
        self._stop = False
        self._broker = threading.Thread(target=self._run_broker, daemon=True)
        self._broker.start()

    def subscribe(self, name: str = "sub"):
        d = _Dispatcher(name, self.records, "pubsub")
        self._subs.append(d)
        return d

    def _run_broker(self):
        while not self._stop:
            try:
                fired_at, fn, args = self._topic.get(timeout=0.1)
            except queue.Empty:
                continue
            time.sleep(self.fanout_latency)      # broker persistence + fanout
            for d in self._subs:
                d.q.put((fired_at, fn, args))

    def fire(self, fn: Callable, args=None):
        if not self._subs:
            self.subscribe()
        self._topic.put((time.monotonic(), fn, args))

    def close(self):
        self._stop = True
        for d in self._subs:
            d.stop()


class StorageTrigger:
    """Spool-directory watcher: fire() writes a real file; a poller notices
    it and dispatches.  Polling interval dominates the delay."""

    def __init__(self, poll_interval: float = 0.05,
                 spool_dir: Optional[str] = None):
        self.records: List[TriggerRecord] = []
        self.poll_interval = poll_interval
        self.spool_dir = spool_dir or tempfile.mkdtemp(prefix="spool-")
        self._handlers = {}
        self._stop = False
        self._th = threading.Thread(target=self._poll, daemon=True)
        self._th.start()

    def _poll(self):
        seen = set()
        while not self._stop:
            time.sleep(self.poll_interval)
            try:
                names = sorted(os.listdir(self.spool_dir))
            except FileNotFoundError:
                continue
            for name in names:
                path = os.path.join(self.spool_dir, name)
                if name in seen or not name.endswith(".evt"):
                    continue
                seen.add(name)
                with open(path) as f:
                    fired_at = float(f.read().strip())
                started = time.monotonic()
                self.records.append(
                    TriggerRecord("storage", fired_at, started))
                fn, args = self._handlers.get("default", (None, None))
                if fn:
                    fn(args)

    def on_object(self, fn: Callable, args=None):
        self._handlers["default"] = (fn, args)

    def fire(self, _fn_ignored=None, args=None):
        fired = time.monotonic()
        path = os.path.join(self.spool_dir, f"{uuid.uuid4().hex}.evt")
        with open(path, "w") as f:
            f.write(repr(fired))

    def close(self):
        self._stop = True


def measure_trigger_delays(n: int = 50) -> dict:
    """Table 1 analogue: median trigger→start delay per service."""
    results = {}
    done = threading.Event()
    counter = {"n": 0}

    def noop(_):
        counter["n"] += 1
        if counter["n"] >= n:
            done.set()

    for name, make in [("direct", DirectTrigger), ("step", StepTrigger),
                       ("pubsub", PubSubTrigger)]:
        trig = make()
        if isinstance(trig, PubSubTrigger):
            trig.subscribe()
        counter["n"] = 0
        done.clear()
        for _ in range(n):
            trig.fire(noop)
            time.sleep(0.001)
        done.wait(timeout=10)
        time.sleep(0.05)
        delays = sorted(r.delay for r in trig.records)
        results[name] = delays[len(delays) // 2] if delays else float("nan")
        trig.close()

    st = StorageTrigger(poll_interval=0.05)   # S3-style notification poll
    st.on_object(noop)
    counter["n"] = 0
    done.clear()
    for _ in range(min(n, 20)):
        st.fire()
        time.sleep(0.06)
    done.wait(timeout=10)
    time.sleep(0.1)
    delays = sorted(r.delay for r in st.records)
    results["storage"] = delays[len(delays) // 2] if delays else float("nan")
    st.close()
    return results
