"""Executor: the port's compile cache + capture and warm-up machinery
(``repro/serving/executor.py``).

The reference lowers and compiles each served step ahead of time into
one XLA executable.  Here that takes two stages:

* ``compile`` makes what the step needs ready: on CUDA, building (nvcc,
  seconds, once per process) or loading the kernel library; on the CPU
  nothing but the binding.  The cache is keyed by (name, device, shapes,
  types): the reference's key follows the inputs, and a compiled step
  here is a closure over one device's model, so each card an endpoint
  runs on compiles (and is timed) on its own.  ``compile_seconds``
  records what each compile cost.
* ``Compiled.bind`` (``Executor.warmup`` in a freshen plan) binds the
  step to the tensors it reads by address, the params and a session's
  decode cache, and on CUDA captures it as a CUDA graph: one run on a
  side stream (cuBLAS handles and lazy inits exist before capture), then
  ``torch.cuda.graph`` on that stream.  Each later call copies the fed
  arguments (tokens; token and pos) into the graph's static buffers,
  replays it, and returns outputs the next replay does not overwrite;
  the bound cache stays in place.  Each graph begins by recording
  ``BoundStep.started``, a timing event the replay records again on the
  device as the graph starts, so a caller can time the replay on the
  device without the host's launch of it.  ``capture_seconds`` records each
  capture beside the compile.  A capture that fails raises: there is no
  eager step on the card.  On the CPU a bound step runs eagerly, after
  one warm run on zeros of the fed arguments.

A step's first ``n_bound`` arguments are bound, the rest fed.  A bound
step holds its binding's tensors, so their addresses cannot be reused
while it lives (the caching allocator hands freed addresses out again);
its ``Compiled`` indexes live bound steps weakly, by the identity of
those tensors.  Whoever keeps a bound step decides how long its graph
lives: a freshen plan entry keeps it until the entry is redone for a
new weight version or invalidated, and then the graph, its memory pool
and the old binding are freed.

Captures on one card take turns (``capture_lock``), so the device-wide
synchronize that ``torch.cuda.graph`` runs before it begins never meets
another capture in progress there; the port's other waits on the card
are on the caller's stream.
"""
from __future__ import annotations
# fabriclint: allow-file[clock] -- compile/capture/warmup seconds are
# measured wall-clock costs fed to the freshen planner.

import contextlib
import gc
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.checkpoint.io import tree_map
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.specs import spec_leaves, tensors_like_specs

_locks_guard = threading.Lock()
_capture_locks: Dict[torch.device, threading.Lock] = {}
_backends: Dict[torch.device, "_CudaGraphs"] = {}


def capture_lock(device: torch.device) -> threading.Lock:
    """The lock captures on ``device`` take turns under."""
    with _locks_guard:
        return _capture_locks.setdefault(device, threading.Lock())


_gc_guard = threading.Lock()
_gc_pauses = 0
_gc_resume = False


@contextlib.contextmanager
def _gc_paused():
    """Hold off Python's cyclic garbage collector while a graph is
    captured: a collection in the capturing thread can free a dead
    step's graph, and destroying a graph while the thread captures is
    not permitted and invalidates the capture.  Counted, so captures on
    several cards at once let collection resume only when the last
    ends."""
    global _gc_pauses, _gc_resume
    with _gc_guard:
        if _gc_pauses == 0:
            _gc_resume = gc.isenabled()
            gc.disable()
        _gc_pauses += 1
    try:
        yield
    finally:
        with _gc_guard:
            _gc_pauses -= 1
            if _gc_pauses == 0 and _gc_resume:
                gc.enable()


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


class _CudaGraphs:
    """Warm-up and capture on one card, on a side stream of its own."""

    def __init__(self, device: torch.device):
        self.device = device
        self.side = torch.cuda.Stream(device)

    def warm(self, run: Callable[[], Any]) -> None:
        with torch.cuda.device(self.device):
            caller = torch.cuda.current_stream(self.device)
            self.side.wait_stream(caller)
            with torch.cuda.stream(self.side):
                run()
            caller.wait_stream(self.side)
            self.side.synchronize()

    def capture(self, run: Callable[[], Any]):
        """(graph, the outputs of ``run`` as the graph leaves them)."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(self.device), torch.cuda.graph(
                graph, stream=self.side, capture_error_mode="thread_local"):
            out = run()
        return graph, out


def _graph_backend(device: torch.device) -> Optional[_CudaGraphs]:
    """How a bound step on ``device`` warms up and captures, or None to
    run it eagerly (the CPU).  The one seam the CPU tests replace."""
    if device.type != "cuda":
        return None
    with _locks_guard:
        backend = _backends.get(device)
        if backend is None:
            backend = _backends[device] = _CudaGraphs(device)
        return backend


def _start_event(device: torch.device) -> Optional[torch.cuda.Event]:
    """A timing event that a capture on ``device`` records as a node of
    its graph (``external``), or None off CUDA."""
    if device.type != "cuda":
        return None
    return torch.cuda.Event(enable_timing=True, external=True)


class BoundStep:
    """A compiled step bound to its first arguments: a captured graph on
    a card, an eager call on the CPU.  Call it with the fed arguments."""

    def __init__(self, compiled: "Compiled", bound: tuple):
        self.compiled = compiled
        self.bound = bound
        self.graph = None
        # recorded on the device as each replay of the graph starts; None
        # for an eager step
        self.started: Optional[torch.cuda.Event] = None
        self.launches: Dict[str, int] = {}     # per replay, from capture
        self.warm_seconds = 0.0
        self.capture_seconds = 0.0
        self._lock = threading.Lock()
        dev = compiled.device
        backend = _graph_backend(dev)
        if backend is None:
            # the warm-up of an eager step: one run on zeros of the fed
            # arguments
            fed = tensors_like_specs(compiled.fed_specs, dev)
            t0 = time.monotonic()
            self(*fed)
            self.warm_seconds = time.monotonic() - t0
            return
        self.static = static = tensors_like_specs(compiled.fed_specs, dev)
        started = self.started = _start_event(dev)

        def run():
            return compiled.fn(*bound, *static)

        def timed():
            if started is not None:
                started.record()
            return run()
        with torch.no_grad(), capture_lock(dev):
            t0 = time.monotonic()
            backend.warm(run)
            t1 = time.monotonic()
            with ops.recording_launches() as tally, _gc_paused():
                self.graph, self.out = backend.capture(timed)
            t2 = time.monotonic()
        self.warm_seconds, self.capture_seconds = t1 - t0, t2 - t1
        self.launches = tally
        self._in_place = {id(t) for t in _leaves(bound)}

    def __call__(self, *fed):
        if self.graph is None:
            with torch.no_grad():
                return self.compiled.fn(*self.bound, *fed)
        with self._lock:
            for buf, x in zip(self.static, fed):
                buf.copy_(x)
            self.graph.replay()
            ops.add_launches(self.launches)
            # the bound cache stays in place; the rest is the next
            # replay's to overwrite, so the caller gets copies
            return tree_map(
                lambda t: t if id(t) in self._in_place else t.clone(),
                self.out)


class Compiled:
    """A compiled step function: what the executor's cache holds.  Its
    first ``n_bound`` arguments are bound (``bind``), the rest fed."""

    def __init__(self, name: str, fn: Callable, device: torch.device,
                 specs=(), n_bound: int = 0):
        self.name = name
        self.fn = fn
        self.device = device
        self.n_bound = n_bound
        self.fed_specs = tuple(specs)[n_bound:]
        self.capture_seconds: List[float] = []
        self._steps: "weakref.WeakValueDictionary[Tuple, BoundStep]" = \
            weakref.WeakValueDictionary()
        self._lock = threading.Lock()

    def bind(self, *bound) -> Tuple[BoundStep, float]:
        """The live step bound to these tensors, or a new one (warmed up,
        and on CUDA captured).  Returns (step, seconds that took now)."""
        if len(bound) != self.n_bound:
            raise TypeError(f"{self.name} binds {self.n_bound} arguments, "
                            f"got {len(bound)}")
        key = tuple(id(t) for t in _leaves(bound))
        with self._lock:
            step = self._steps.get(key)
        if step is not None:
            return step, 0.0
        step = BoundStep(self, bound)
        with self._lock:
            # a step bound to the same tensors in the meantime is as good
            step = self._steps.setdefault(key, step)
            if step.graph is not None:
                self.capture_seconds.append(step.capture_seconds)
        return step, step.warm_seconds + step.capture_seconds


class Executor:
    def __init__(self):
        self._cache: Dict[Tuple, Compiled] = {}
        self._lock = threading.Lock()
        self.compile_seconds: Dict[Tuple, float] = {}
        self.compile_count = 0
        self.hit_count = 0

    @staticmethod
    def _key(name: str, specs, device: torch.device) -> Tuple:
        return (name, str(device)) + tuple((tuple(s.shape), str(s.dtype))
                                           for s in spec_leaves(specs))

    @property
    def capture_seconds(self) -> Dict[Tuple, List[float]]:
        """Each compiled step's captures, in seconds, by compile key."""
        with self._lock:
            return {k: list(c.capture_seconds)
                    for k, c in self._cache.items() if c.capture_seconds}

    # ------------------------------------------------------------------
    def compile(self, name: str, fn: Callable, specs, *,
                device: DeviceLike = "cuda",
                n_bound: int = 0) -> Tuple[Compiled, float]:
        """Make ``fn`` ready to run on ``device`` for inputs of ``specs``,
        the first ``n_bound`` of which it binds; cached per device.
        Returns (compiled, seconds_spent_now)."""
        t0 = time.monotonic()
        dev = resolve_device(device)
        key = self._key(name, specs, dev)
        with self._lock:
            if key in self._cache:
                self.hit_count += 1
                return self._cache[key], 0.0
        if dev.type == "cuda":
            ops.LIBRARY.load()           # nvcc at first use in the process
        compiled = Compiled(name, fn, dev, specs, n_bound)
        dt = time.monotonic() - t0
        with self._lock:
            self._cache[key] = compiled
            self.compile_seconds[key] = dt
            self.compile_count += 1
        return compiled, dt

    def get(self, name: str, specs,
            device: DeviceLike) -> Optional[Compiled]:
        """The step compiled for ``specs`` on ``device``, or None."""
        with self._lock:
            return self._cache.get(self._key(name, specs,
                                             resolve_device(device)))

    # ------------------------------------------------------------------
    def warmup(self, compiled: Compiled, *bound) -> BoundStep:
        """Bind ``compiled`` to ``bound`` (an instance's own params, and
        a session's cache), the CWND-warming analogue: on CUDA one run on
        a side stream and the capture; on the CPU one eager run on zeros
        of the fed arguments.  Returns the bound step; its
        ``warm_seconds`` and ``capture_seconds`` say what this cost.  A
        binding already live is returned as it is."""
        return compiled.bind(*bound)[0]
