"""Executor: the port's compile cache + warm-up machinery
(``repro/serving/executor.py``).

PyTorch runs eagerly, so "compiling" a step function means making
everything it needs ready and binding it: on CUDA that is building (nvcc,
seconds, once per process) or loading the kernel library, on the CPU
nothing but the binding.  The cache is keyed by (name, device, shapes,
types): the reference's key follows the inputs, and a compiled step
here is a closure over one device's model, so each card an endpoint
runs on compiles (and is timed) on its own.  ``compile_seconds``
records what each compile cost — the cold start the freshen plan moves
off the critical path.
CUDA-graph capture of the fixed-shape steps is later work (ROADMAP.md
module item 9).
"""
from __future__ import annotations
# fabriclint: allow-file[clock] -- compile/warmup seconds are measured
# wall-clock costs fed to the freshen planner.

import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.specs import spec_leaves, tensors_like_specs


class Compiled:
    """A bound step function: what the executor's cache holds."""

    def __init__(self, name: str, fn: Callable, device: torch.device):
        self.name = name
        self.fn = fn
        self.device = device

    def __call__(self, *args):
        with torch.no_grad():
            return self.fn(*args)


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

    # ------------------------------------------------------------------
    def compile(self, name: str, fn: Callable, specs, *,
                device: DeviceLike = "cuda") -> Tuple[Compiled, float]:
        """Make ``fn`` ready to run on ``device`` for inputs of ``specs``;
        cached per device.  Returns (compiled, seconds_spent_now)."""
        t0 = time.monotonic()
        dev = resolve_device(device)
        key = self._key(name, specs, dev)
        with self._lock:
            if key in self._cache:
                self.hit_count += 1
                return self._cache[key], 0.0
        if dev.type == "cuda":
            ops.LIBRARY.load()           # nvcc at first use in the process
        compiled = Compiled(name, fn, dev)
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
    def warmup(self, compiled: Compiled, specs,
               device: Optional[DeviceLike] = None) -> float:
        """Run the compiled step once on zeros on ``device`` (default: the
        one it was compiled for; an endpoint shared by shards on several
        cards warms each instance's own) and wait for the device: warms
        the caching allocator, cuBLAS handles and the kernels' first
        launches — the CWND-warming analogue."""
        dev = compiled.device if device is None else torch.device(device)
        args = tensors_like_specs(specs, dev)
        t0 = time.monotonic()
        out: Any = compiled(*args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        del out
        return time.monotonic() - t0
