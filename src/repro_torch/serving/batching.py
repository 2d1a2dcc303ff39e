"""Request batching: collect single requests into fixed-size batches
(padding the tail) so the compiled executable shape is reused — serverless
"requests" become batched model invocations.

Two batchers live here:

* ``Batcher`` — the original fabric-blind batcher: fixed target size,
  flush on fullness or deadline, ``handler`` runs on the worker thread.
  Kept as-is for callers that batch outside the platform (examples,
  tests); its per-batch fill counts now land in a bounded registry
  ``Histogram`` instead of an unbounded list.
* ``EndpointBatcher`` — the pool-aware batcher ``ServingEngine.deploy``
  installs in front of a deployed endpoint.  It drains its queue into
  batches sized ``min(configured, queue_depth, idle_capacity())`` so the
  batch it forms matches what the fabric can actually run *right now*,
  dispatches each batch as ONE pooled invocation (one acquire/release,
  one span), and treats ``PoolSaturated`` as backpressure: the batch is
  requeued at the front and retried, never surfaced to callers as an
  error.
"""
from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, List, Optional

import numpy as np

from repro_torch.core.pool import PoolSaturated
from repro_torch.telemetry import MetricsRegistry

# how many recent per-batch fill counts the ``batch_fill`` view retains;
# the registry histogram keeps exact lifetime count/sum regardless
FILL_VIEW_LIMIT = 1024


@dataclass
class Request:
    payload: Any
    future: Future = field(default_factory=Future)
    submitted_at: float = field(default_factory=time.monotonic)


_CLOSE = object()       # sentinel: wakes the worker immediately on close()


class Batcher:
    """Groups requests into batches of ``batch_size``; flushes on fullness or
    ``max_wait`` seconds after the *first* request of a partial batch.
    ``handler(payloads: list) -> list`` runs on the worker thread.

    ``close()`` is graceful: a sentinel wakes the worker, every request
    already queued is flushed through the handler (no caller is ever left
    hanging on a Future), and only then does the worker exit.  Requests
    submitted after close raise ``RuntimeError``."""

    def __init__(self, batch_size: int, handler: Callable[[List[Any]], List[Any]],
                 max_wait: float = 0.01, name: str = "batcher",
                 clock: Callable[[], float] = time.monotonic):
        self.batch_size = batch_size
        self.handler = handler
        self.max_wait = max_wait
        # paces queue.get timeouts, so the default must be the wall
        # clock; injectable for tests
        self.clock = clock
        self._q: queue.Queue = queue.Queue()
        self._stop = False
        self._lifecycle = threading.Lock()   # makes submit-vs-close atomic
        self.metrics = MetricsRegistry(f"{name}.")
        self._c_batches = self.metrics.counter("batches")
        self._c_requests = self.metrics.counter("requests")
        self._h_fill = self.metrics.histogram("batch.fill")
        # bounded recency view (tests index [-1] / max() over it); the
        # histogram above carries the exact lifetime count and sum — a
        # long-running platform no longer accretes one int per batch
        self.batch_fill: Deque[int] = deque(maxlen=FILL_VIEW_LIMIT)
        self._th = threading.Thread(target=self._loop, daemon=True)
        self._th.start()

    # legacy counter attributes, now registry-backed views
    @property
    def batches_processed(self) -> int:
        return self._c_batches.value

    @property
    def requests_processed(self) -> int:
        return self._c_requests.value

    def submit(self, payload: Any) -> Future:
        # check+put under the lifecycle lock: a submit can never slip its
        # request into the queue after close() has finished draining
        with self._lifecycle:
            if self._stop:
                raise RuntimeError("Batcher is closed")
            req = Request(payload)
            self._q.put(req)
        return req.future

    def _flush(self, batch: List[Request]):
        if not batch:
            return
        try:
            results = self.handler([r.payload for r in batch])
            if len(results) != len(batch):
                raise RuntimeError(
                    f"handler returned {len(results)} results for "
                    f"{len(batch)} requests")
            for r, res in zip(batch, results):
                if not r.future.done():      # caller may have cancelled
                    r.future.set_result(res)
        except BaseException as exc:
            for r in batch:
                if not r.future.done():
                    r.future.set_exception(exc)
        self._c_batches.inc()
        self._c_requests.inc(len(batch))
        self._h_fill.observe(len(batch))
        self.batch_fill.append(len(batch))

    def _loop(self):
        closing = False
        while not closing:
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                if self._stop:
                    break
                continue
            if first is _CLOSE:
                break
            # Partial-batch deadline: starts at the FIRST request and is
            # honored exactly — a batch never waits longer than max_wait,
            # even when requests keep trickling in.
            batch: List[Request] = [first]
            deadline = self.clock() + self.max_wait
            while len(batch) < self.batch_size:
                remaining = deadline - self.clock()
                if remaining <= 0:
                    break
                try:
                    req = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if req is _CLOSE:
                    closing = True
                    break
                batch.append(req)
            self._flush(batch)
        # Drain: flush everything that was queued before (or raced with)
        # close so no submitted Future is ever dropped.
        tail: List[Request] = []
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            if req is _CLOSE:
                continue
            tail.append(req)
            if len(tail) == self.batch_size:
                self._flush(tail)
                tail = []
        self._flush(tail)

    def close(self, timeout: float = 5.0):
        with self._lifecycle:
            if self._stop:
                return
            self._stop = True
        self._q.put(_CLOSE)
        self._th.join(timeout=timeout)
        if self._th.is_alive():
            # Worker is merely slow (long handler): it will still drain the
            # queue itself; failing stragglers here would race its drain
            # loop and break the no-dropped-request guarantee.
            return
        # Worker is dead: fail any stragglers rather than hang their
        # callers forever.
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            if req is _CLOSE:
                continue
            if not req.future.done():
                req.future.set_exception(RuntimeError("Batcher closed"))

    def stats(self):
        summary = self._h_fill.summary()
        return {"batches": self.batches_processed,
                "requests": self.requests_processed,
                "mean_fill": summary["mean"] if summary["count"] else 0.0}


class EndpointBatcher:
    """Pool-aware batching in front of one deployed endpoint.

    ``run_batch(payloads: list) -> Future[list]`` dispatches one batch as
    a single pooled invocation through the platform (one acquire/release,
    one traced span — ``ServingEngine`` builds the closure) and resolves
    to the per-payload results in order.

    The batcher is *fabric-aware* through two read-only signals:

    * ``capacity()`` — how many more invocations the endpoint's pool(s)
      could start without queueing (``InstancePool.idle_capacity``, or the
      cluster-wide sum).  The adaptive fill is
      ``min(batch_size, queue_depth, max(1, capacity))``: when the fabric
      has room, several smaller batches dispatch concurrently across warm
      instances instead of one large batch serializing behind a single
      acquire; when it is tight, batches grow toward the configured size
      so each acquire amortizes more requests.
    * ``PoolSaturated`` resolving a dispatched batch — backpressure, not
      an error: the batch re-enters the queue at the *front* (admission
      order holds) and is retried after ``retry_interval``.

    Requests never error out because the platform was momentarily full;
    only ``close()`` or a genuine handler failure resolves their futures
    exceptionally."""

    def __init__(self, name: str,
                 run_batch: Callable[[List[Any]], Future],
                 batch_size: int, max_wait: float = 0.01,
                 capacity: Optional[Callable[[], int]] = None,
                 retry_interval: float = 0.005,
                 clock: Callable[[], float] = time.monotonic):
        self.name = name
        self.run_batch = run_batch
        self.batch_size = batch_size
        self.max_wait = max_wait
        self.capacity = capacity
        self.retry_interval = retry_interval
        # deadlines are compared against Request.submitted_at (monotonic
        # domain) and pace real cond waits; injectable for tests
        self.clock = clock
        self._pending: Deque[Request] = deque()
        self._cond = threading.Condition()
        self._stop = False
        self._inflight = 0
        self.metrics = MetricsRegistry(f"batcher.{name}.")
        self._c_batches = self.metrics.counter("batches")
        self._c_requests = self.metrics.counter("requests")
        self._c_backpressure = self.metrics.counter("backpressure")
        self._h_fill = self.metrics.histogram("batch.fill")
        self.batch_fill: Deque[int] = deque(maxlen=FILL_VIEW_LIMIT)
        self._th = threading.Thread(target=self._loop, daemon=True,
                                    name=f"endpoint-batcher-{name}")
        self._th.start()

    # -- admission ------------------------------------------------------
    def submit(self, payload: Any) -> Future:
        with self._cond:
            if self._stop:
                raise RuntimeError(f"EndpointBatcher {self.name!r} is closed")
            req = Request(payload)
            self._pending.append(req)
            self._cond.notify()
        return req.future

    def queue_depth(self) -> int:
        with self._cond:
            return len(self._pending)

    # -- batch formation ------------------------------------------------
    def _target_fill_locked(self) -> int:
        """Adaptive fill under the lock: never more than what is queued,
        never more than the configured executable batch, and — when the
        fabric signal is wired — no larger than what the pool could run
        now (floor 1: a saturated fabric still forms a batch; saturation
        is handled as backpressure at dispatch, not starvation here)."""
        target = min(self.batch_size, len(self._pending))
        if self.capacity is not None:
            try:
                target = min(target, max(1, self.capacity()))
            except Exception:
                pass                     # a torn signal never stalls a batch
        return max(1, target)

    def _loop(self):
        while True:
            with self._cond:
                while not self._pending and not self._stop:
                    self._cond.wait(0.1)
                if self._stop and not self._pending:
                    return
                first_at = self._pending[0].submitted_at
            # deadline anchored at the OLDEST pending request: a trickle
            # never postpones the flush
            deadline = first_at + self.max_wait
            with self._cond:
                while (len(self._pending) < self.batch_size
                       and not self._stop):
                    remaining = deadline - self.clock()
                    if remaining <= 0:
                        break
                    self._cond.wait(remaining)
                    if not self._pending:
                        break
                if not self._pending:
                    continue
                fill = self._target_fill_locked()
                batch = [self._pending.popleft() for _ in range(fill)]
            self._dispatch(batch)

    # -- dispatch + backpressure ----------------------------------------
    def _dispatch(self, batch: List[Request]):
        try:
            fut = self.run_batch([r.payload for r in batch])
        except PoolSaturated:
            self._backpressure(batch)
            return
        except BaseException as exc:
            self._fail(batch, exc)
            return
        with self._cond:
            self._inflight += 1
        fut.add_done_callback(lambda f: self._batch_done(batch, f))

    def _batch_done(self, batch: List[Request], fut: Future):
        with self._cond:
            self._inflight -= 1
        try:
            exc = fut.exception()
        except BaseException as e:       # cancelled
            exc = e
        if isinstance(exc, PoolSaturated):
            self._backpressure(batch)
            return
        if exc is not None:
            self._fail(batch, exc)
            return
        results = fut.result()
        try:
            if len(results) < len(batch):
                raise RuntimeError(
                    f"batch handler returned {len(results)} results for "
                    f"{len(batch)} requests")
            for r, res in zip(batch, results):
                if not r.future.done():
                    r.future.set_result(res)
        except BaseException as e:       # noqa: BLE001
            self._fail(batch, e)
            return
        self._c_batches.inc()
        self._c_requests.inc(len(batch))
        self._h_fill.observe(len(batch))
        self.batch_fill.append(len(batch))

    def _backpressure(self, batch: List[Request]):
        """Saturation: requeue at the front (admission order holds) and
        let the worker retry after a short pause rather than failing the
        callers."""
        self._c_backpressure.inc()
        with self._cond:
            if self._stop:
                # closing: no retry loop will run these — fail loudly
                # rather than hang callers forever
                pass
            else:
                for r in reversed(batch):
                    self._pending.appendleft(r)
                self._cond.notify()
                # wake the worker *after* a pause so the retry is not a
                # hot spin against a still-saturated pool
                threading.Timer(self.retry_interval, self._nudge).start()
                return
        self._fail(batch, RuntimeError(
            f"EndpointBatcher {self.name!r} closed while backpressured"))

    def _nudge(self):
        with self._cond:
            self._cond.notify()

    @staticmethod
    def _fail(batch: List[Request], exc: BaseException):
        for r in batch:
            if not r.future.done():
                r.future.set_exception(exc)

    # -- lifecycle ------------------------------------------------------
    def close(self, timeout: float = 5.0):
        """Graceful: the worker drains everything pending (each drained
        batch still dispatches through ``run_batch``), then exits."""
        with self._cond:
            if self._stop:
                return
            self._stop = True
            self._cond.notify_all()
        self._th.join(timeout=timeout)
        # worker gone (or stuck): fail stragglers rather than hang callers
        with self._cond:
            stragglers = list(self._pending)
            self._pending.clear()
        self._fail(stragglers, RuntimeError(
            f"EndpointBatcher {self.name!r} closed"))

    def stats(self) -> dict:
        summary = self._h_fill.summary()
        with self._cond:
            depth, inflight = len(self._pending), self._inflight
        return {"batches": self._c_batches.value,
                "requests": self._c_requests.value,
                "backpressure": self._c_backpressure.value,
                "mean_fill": summary["mean"] if summary["count"] else 0.0,
                "queue_depth": depth, "inflight": inflight}

    def metrics_snapshot(self) -> dict:
        return self.metrics.snapshot()


def pad_batch(payloads: List[np.ndarray], batch_size: int) -> np.ndarray:
    """Stack variable-count payloads to a fixed batch (repeat last row)."""
    arr = np.stack(payloads)
    if len(payloads) < batch_size:
        pad = np.repeat(arr[-1:], batch_size - len(payloads), axis=0)
        arr = np.concatenate([arr, pad], axis=0)
    return arr
