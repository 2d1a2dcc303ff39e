"""Pluggable instance backends — *where* a container's hooks execute.

The seed platform simulated sandbox creation with ``time.sleep(
cold_start_cost)`` inside ``Runtime.init``.  Real serverless cold starts
are dominated by interpreter startup plus import/load work (vHive,
Ustiugov et al. 2021), and provisioning policies are tuned against
*measured* startup cost (SPES, Lee et al. 2024).  This module makes the
execution substrate a policy choice:

* ``ThreadBackend`` — the seed behavior: hooks run in-process, cold-start
  cost is the configured simulated sleep.  Default, zero-dependency, and
  the only backend that supports shared scope groups (one process, one
  heap).
* ``SubprocessBackend`` — each instance's ``init``/``run``/``freshen``
  hooks execute in a persistent worker process
  (``python -m repro_torch.core.backend_worker``) over a length-prefixed pickle
  pipe protocol on stdin/stdout.  The cold start is then the *measured*
  interpreter-spawn + module-import + ``init_fn`` time, and
  ``InstancePool.measured_cold_start`` feeds that number back into
  warmth/retention policy (``HistoryPolicy.adapt`` / ``pool_config``).
* ``SnapshotBackend`` — instances are *forked* from a pre-warmed
  per-function **template process** (``repro_torch.core.backend_template``)
  whose interpreter is already up and whose modules — ``repro``, the
  spec's module, and a REAP-style recorded "import working set" from the
  first boot (arXiv 2101.09355) — are already imported.  The cold start
  collapses to fork + ``init_fn``, typically one to two orders of
  magnitude below the subprocess backend's full spawn, which is what
  re-tunes every retention/prewarm policy above it.

A backend instance is per-``Runtime`` (it owns the worker process or the
forked instance); selection is per-pool via ``PoolConfig.backend`` and
threads through ``FreshenScheduler.register(..., backend=...)``,
``ClusterWorker.register(..., backend=...)`` and
``ServingEngine.deploy(..., backend=...)``.  The snapshot template itself
is pool-owned — one per (function, pool), started at pool construction
and closed with the pool — so fork economics are shared across every
instance the pool ever provisions.

Subprocess and snapshot function specs must be *reconstructable in the
worker*: either every callable on the ``FunctionSpec`` is picklable by
reference (defined at module scope in an importable module), or
``FunctionSpec.ref`` names a ``"module:attr"`` that resolves — in the
worker — to the spec or to a zero-argument factory returning it (the
escape hatch for closure-built specs and endpoints holding unpicklable
state).
"""
from __future__ import annotations
# fabriclint: allow-file[blocking,clock] -- the channel lock exists to
# serialize pipe I/O with the worker (blocking inside it is the
# contract), and spawn/boot timings are measured wall-clock costs.

import os
import pickle
import socket
import struct
import subprocess
import sys
import threading
import time
from typing import Any, BinaryIO, Dict, Optional, Tuple

from repro_torch.core.freshen import FreshenPlan, FreshenState
from repro_torch.core.runtime import WarmthLevel

_FRESHEN_STAT_KEYS = ("freshened", "inline", "waits", "hits")


class BackendError(RuntimeError):
    """A backend could not execute a hook (worker died, spec not
    shippable, remote hook raised)."""


# ----------------------------------------------------------------------
# Pipe framing shared with repro_torch.core.backend_worker and
# repro_torch.core.backend_template: 4-byte big-endian length + pickled
# ``(tag, payload)`` tuple.
def write_frame(stream: BinaryIO, obj: Any) -> None:
    blob = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    stream.write(struct.pack("!I", len(blob)))
    stream.write(blob)
    stream.flush()


def read_frame(stream: BinaryIO) -> Optional[Any]:
    """One framed message, or None on EOF/short read (peer gone)."""
    header = stream.read(4)
    if len(header) < 4:
        return None
    (n,) = struct.unpack("!I", header)
    data = b""
    while len(data) < n:
        chunk = stream.read(n - len(data))
        if not chunk:
            return None
        data += chunk
    return pickle.loads(data)


def spec_payload(spec) -> Dict[str, Any]:
    """How a FunctionSpec ships to an out-of-process worker or template:
    ``spec_ref`` when the spec names an importable ``"module:attr"``,
    else the pickled spec itself (module-level callables pickle by
    reference)."""
    if spec.ref:
        return {"spec_ref": spec.ref}
    try:
        return {"spec_pickle": pickle.dumps(
            spec, protocol=pickle.HIGHEST_PROTOCOL)}
    except Exception as exc:
        raise BackendError(
            f"FunctionSpec {spec.name!r} is not picklable ({exc}); the "
            f"subprocess/snapshot backends need module-level callables or "
            f"a FunctionSpec.ref='module:attr' the worker can import "
            f"(or use the thread backend)") from exc


def worker_env(sys_path) -> Dict[str, str]:
    """Environment for a worker/template process: the parent's ``sys.path``
    prepended to — never clobbering — any externally-set ``PYTHONPATH``,
    so specs whose imports rely on the inherited value keep resolving."""
    env = dict(os.environ)
    joined = os.pathsep.join(sys_path)
    inherited = env.get("PYTHONPATH")
    env["PYTHONPATH"] = (joined + os.pathsep + inherited
                         if inherited else joined)
    return env


# ----------------------------------------------------------------------
class InstanceBackend:
    """The execution substrate for one Runtime's hooks.

    ``Runtime`` keeps lifecycle bookkeeping (init lock, freshen threads,
    counters) and delegates the actual work here:

    * ``boot_process(runtime)`` — pay the COLD->PROCESS rung (spawn the
      sandbox/interpreter, no function init).  Called under the runtime's
      init lock.
    * ``boot_init(runtime)``    — pay the PROCESS->INITIALIZED rung
      (``init_fn`` + freshen-plan build).  On return the instance must be
      servable.  The default delegates to ``boot`` so legacy backends that
      only implement the combined cold start keep working.
    * ``boot(runtime)``    — the combined cold start (both rungs); kept
      for direct callers and legacy subclasses.
    * ``demote(runtime, level)`` — release the warmth rungs above
      ``level`` (HOT->INITIALIZED invalidates fr caches; ->PROCESS tears
      down the inited runtime, keeping the sandbox resident).  Called
      under the runtime's init lock; default no-op.
    * ``run(runtime, args)``      — execute the run hook, returning the
      function result.
    * ``freshen(runtime)``        — execute the freshen hook to completion
      (Algorithm 2); called from a background thread by ``Runtime.freshen``
      so non-blocking dispatch semantics live above this layer.
    * ``freshen_stats(runtime)``  — the instance's fr_state counters
      (``freshened``/``inline``/``waits``/``hits``), or None before boot.
    * ``alive(runtime)``   — whether the substrate can still serve; False
      once a worker process or forked instance died under the runtime.
      ``InstancePool`` evicts dead instances instead of re-idling them.
    * ``close()``          — release the substrate (terminate the worker
      process); idempotent.
    """

    name = "abstract"

    def boot(self, runtime) -> None:
        raise NotImplementedError

    def boot_process(self, runtime) -> None:
        pass

    def boot_init(self, runtime) -> None:
        self.boot(runtime)

    def demote(self, runtime, level: WarmthLevel) -> None:
        pass

    def run(self, runtime, args: Any) -> Any:
        raise NotImplementedError

    def freshen(self, runtime) -> Optional[dict]:
        raise NotImplementedError

    def freshen_stats(self, runtime) -> Optional[dict]:
        raise NotImplementedError

    def alive(self, runtime) -> bool:
        return True

    def close(self) -> None:
        pass


class ThreadBackend(InstanceBackend):
    """In-process execution — the seed behavior.  Cold start is the
    configured simulated ``cold_start_cost`` sleep plus ``init_fn``;
    ``Runtime.process_boot_fraction`` splits the sleep between the
    PROCESS rung (sandbox boot share) and the INITIALIZED rung
    (init_fn/plan share), so partial warmth has a simulated per-level
    cost just like the measured backends."""

    name = "thread"

    def boot(self, runtime) -> None:
        self.boot_process(runtime)
        self.boot_init(runtime)

    def boot_process(self, runtime) -> None:
        if runtime.cold_start_cost:
            time.sleep(runtime.cold_start_cost
                       * runtime.process_boot_fraction)

    def boot_init(self, runtime) -> None:
        if runtime.cold_start_cost:
            time.sleep(runtime.cold_start_cost
                       * (1.0 - runtime.process_boot_fraction))
        if runtime.spec.init_fn:
            runtime.spec.init_fn(runtime)
        plan = (runtime.spec.plan_factory(runtime)
                if runtime.spec.plan_factory else FreshenPlan([]))
        runtime.fr_state = FreshenState(plan, clock=runtime.clock)

    def demote(self, runtime, level: WarmthLevel) -> None:
        if level < WarmthLevel.INITIALIZED:
            # drop the inited runtime; keep the scope dict — shared scope
            # groups alias it across instances and must stay coherent
            runtime.fr_state = None
        elif runtime.fr_state is not None:
            runtime.fr_state.invalidate()

    def run(self, runtime, args: Any) -> Any:
        from repro_torch.core.runtime import RunContext
        return runtime.spec.code(RunContext(runtime), args)

    def freshen(self, runtime) -> Optional[dict]:
        return runtime.fr_state.freshen()

    def freshen_stats(self, runtime) -> Optional[dict]:
        if runtime.fr_state is None:
            return None
        return runtime.fr_state.stats()


class _ChannelBackend(InstanceBackend):
    """Shared machinery for backends whose instance lives behind a framed
    byte channel (a worker's stdin/stdout pipes, a fork's unix socket).

    Commands are serialized by a lock — within one instance the hooks run
    one at a time, exactly like a single-core sandbox; concurrency comes
    from the pool holding many instances.  Function arguments and results
    must be picklable.

    The parent-side ``Runtime.fr_state`` stays ``None`` (the real fr_state
    lives in the remote instance); pool introspection goes through
    ``freshen_stats``, which round-trips to the instance and caches the
    last answer so a dead instance still reports its lifetime counters.

    Subclasses provide ``_channel()`` (the live ``(reader, writer)`` pair
    or None), ``_peer_alive()`` (a cheap liveness probe beyond the channel
    existing) and ``_death_detail()`` (suffix for died-mid-command
    errors), plus boot/close.
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._stats_cache: Optional[dict] = None
        self._dead = False              # a _call saw the peer die

    # -- subclass contract ----------------------------------------------
    def _channel(self) -> Optional[Tuple[BinaryIO, BinaryIO]]:
        raise NotImplementedError

    def _peer_alive(self) -> bool:
        return True

    def _death_detail(self) -> str:
        return ""

    # -- protocol ---------------------------------------------------------
    def _call(self, cmd: str, payload: Any) -> Any:
        with self._lock:
            chan = self._channel()
            if chan is None:
                raise BackendError(
                    f"{self.name} backend worker is not running "
                    f"(command {cmd!r})")
            reader, writer = chan
            try:
                write_frame(writer, (cmd, payload))
                msg = read_frame(reader)
            except (OSError, ValueError) as exc:
                self._dead = True
                raise BackendError(
                    f"{self.name} backend worker died during {cmd!r} "
                    f"({exc})") from exc
        if msg is None:
            self._dead = True
            raise BackendError(
                f"{self.name} backend worker died during {cmd!r}"
                f"{self._death_detail()}")
        tag, body = msg
        if tag == "err":
            raise BackendError(
                f"worker hook {cmd!r} failed remotely:\n{body}")
        return body

    # -- InstanceBackend --------------------------------------------------
    def run(self, runtime, args: Any) -> Any:
        return self._call("run", args)

    def freshen(self, runtime) -> Optional[dict]:
        stats = self._call("freshen", None)
        if isinstance(stats, dict):
            self._stats_cache = {k: stats.get(k, 0)
                                 for k in _FRESHEN_STAT_KEYS}
        return stats

    def freshen_stats(self, runtime) -> Optional[dict]:
        if self._channel() is None:
            return self._stats_cache
        try:
            stats = self._call("stats", None)
        except BackendError:
            return self._stats_cache
        self._stats_cache = {k: stats.get(k, 0) for k in _FRESHEN_STAT_KEYS}
        return dict(self._stats_cache)

    def demote(self, runtime, level: WarmthLevel) -> None:
        if self._channel() is None:
            return                      # nothing resident to release
        self._call("demote", {"level": int(level)})

    def alive(self, runtime) -> bool:
        if runtime.warmth == WarmthLevel.COLD:
            return True                 # nothing booted yet: boot provisions
        if self._dead:
            return False
        return self._channel() is not None and self._peer_alive()


class SubprocessBackend(_ChannelBackend):
    """One persistent worker process per instance; hooks run remotely.

    The worker is spawned in ``boot_process`` (interpreter exec + repro
    import + spec import — the PROCESS rung) and the function is inited by
    ``boot_init`` (remote ``init_fn`` + plan build — the INITIALIZED
    rung); both together are the measured cold start.  The worker then
    serves ``run``/``freshen``/``stats``/``demote`` commands over the pipe
    until ``close``.
    """

    name = "subprocess"

    def __init__(self, python: Optional[str] = None):
        super().__init__()
        self.python = python or sys.executable
        self._proc: Optional[subprocess.Popen] = None
        self.worker_init_seconds = 0.0     # init_fn+plan time inside worker
        self.spawn_seconds = 0.0           # measured spawn+import (PROCESS)

    # -- _ChannelBackend -------------------------------------------------
    def _channel(self) -> Optional[Tuple[BinaryIO, BinaryIO]]:
        proc = self._proc
        if proc is None or proc.poll() is not None:
            return None
        return proc.stdout, proc.stdin

    def _death_detail(self) -> str:
        proc = self._proc
        return f" (exit code {proc.poll()})" if proc is not None else ""

    # -- InstanceBackend -----------------------------------------------
    def boot(self, runtime) -> None:
        self.boot_process(runtime)
        self.boot_init(runtime)

    def boot_process(self, runtime) -> None:
        payload = spec_payload(runtime.spec)
        payload["sys_path"] = [p for p in sys.path if p]
        env = worker_env(payload["sys_path"])
        self.close()         # a failed earlier boot must not leak a worker
        t0 = time.monotonic()
        try:
            with self._lock:
                self._dead = False
                self._proc = subprocess.Popen(
                    [self.python, "-m", "repro_torch.core.backend_worker"],
                    stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env)
                self._call("load", payload)
        except BaseException:
            self.close()     # remote load failed: reap the spawned worker
            raise
        self.spawn_seconds = time.monotonic() - t0

    def boot_init(self, runtime) -> None:
        try:
            reply = self._call("init", {})
        except BaseException:
            self.close()     # remote init failed: reap the spawned worker
            raise
        self.worker_init_seconds = reply.get("init_seconds", 0.0)

    def close(self) -> None:
        with self._lock:
            proc, self._proc = self._proc, None
            if proc is None or proc.poll() is not None:
                return
            try:
                write_frame(proc.stdin, ("exit", None))
                proc.stdin.close()
            except (BrokenPipeError, OSError, ValueError):
                pass
        try:
            proc.wait(timeout=5.0)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class SnapshotBackend(_ChannelBackend):
    """Instances are forked from a pre-warmed per-function template process
    instead of spawned from scratch (repro_torch.core.backend_template).

    The template keeps the interpreter up with ``repro``, the spec's
    module, and the recorded import working set of the first boot already
    imported (REAP-style: record the working set once, prefetch it so
    every restore inherits it — arXiv 2101.09355).  ``boot`` is then
    fork + ``init_fn``: the interpreter-exec and module-import cost the
    subprocess backend pays on *every* cold start is paid once per
    (function, pool) by the template.  ``Runtime.init_seconds`` — and
    through it ``InstancePool.measured_cold_start()`` and the
    ``HistoryPolicy`` keep-alive floor — therefore measures the *restore*
    cost, which is what changes the retention economics.

    ``template`` is normally attached by the owning ``InstancePool`` (one
    template per (function, pool), started at pool construction, closed
    with the pool).  A standalone backend with no template lazily creates
    and owns one — its first ``boot`` then includes the template spawn.

    POSIX-only (``os.fork`` + ``AF_UNIX``); the forked instance serves the
    same run/freshen/stats protocol as the subprocess worker, over a unix
    socket instead of stdin/stdout pipes.
    """

    name = "snapshot"

    def __init__(self, template=None, python: Optional[str] = None):
        super().__init__()
        self.python = python
        self.template = template        # SnapshotTemplate (pool-attached)
        self._owns_template = False
        self._sock: Optional[socket.socket] = None
        self._rfile: Optional[BinaryIO] = None
        self._wfile: Optional[BinaryIO] = None
        self.child_pid: Optional[int] = None
        self.worker_init_seconds = 0.0  # init_fn+plan time inside the fork
        self.fork_seconds = 0.0         # measured fork+connect (PROCESS)
        self.restore_seconds = 0.0      # full measured fork+init restore

    # -- _ChannelBackend -------------------------------------------------
    def _channel(self) -> Optional[Tuple[BinaryIO, BinaryIO]]:
        rfile, wfile = self._rfile, self._wfile
        if rfile is None or wfile is None:
            return None
        return rfile, wfile

    def _peer_alive(self) -> bool:
        """Non-blocking peek: EOF means the forked instance died (killed,
        crashed); unreadable-but-open means it is alive."""
        sock = self._sock
        if sock is None:
            return False
        try:
            data = sock.recv(1, socket.MSG_PEEK | socket.MSG_DONTWAIT)
        except (BlockingIOError, InterruptedError):
            return True
        except OSError:
            return False
        return bool(data)

    def _death_detail(self) -> str:
        pid = self.child_pid
        return f" (forked instance pid {pid})" if pid else ""

    # -- InstanceBackend -----------------------------------------------
    def boot(self, runtime) -> None:
        self.boot_process(runtime)
        self.boot_init(runtime)

    def boot_process(self, runtime) -> None:
        self._close_instance()   # a failed earlier boot must not leak a fork
        tpl = self.template
        if tpl is None:
            from repro_torch.core.backend_template import SnapshotTemplate
            tpl = self.template = SnapshotTemplate(runtime.spec,
                                                   python=self.python)
            self._owns_template = True
        t0 = time.monotonic()
        tpl.start()              # idempotent; the pool normally pre-started
        sock, rfile, wfile, info = tpl.fork_instance(init=False)
        with self._lock:
            self._sock, self._rfile, self._wfile = sock, rfile, wfile
            self.child_pid = info.get("pid")
            self._dead = False
        self.fork_seconds = time.monotonic() - t0

    def boot_init(self, runtime) -> None:
        t0 = time.monotonic()
        try:
            reply = self._call("init", {})
        except BaseException:
            self._close_instance()   # failed init must not leak the fork
            raise
        self.worker_init_seconds = reply.get("init_seconds", 0.0)
        self.restore_seconds = self.fork_seconds + (time.monotonic() - t0)

    def _close_instance(self) -> None:
        with self._lock:
            sock, self._sock = self._sock, None
            rfile, self._rfile = self._rfile, None
            wfile, self._wfile = self._wfile, None
            self.child_pid = None
        if wfile is not None:
            try:
                write_frame(wfile, ("exit", None))
            except (BrokenPipeError, OSError, ValueError):
                pass
        for f in (rfile, wfile, sock):
            if f is not None:
                try:
                    f.close()
                except OSError:
                    pass

    def close(self) -> None:
        self._close_instance()
        tpl = self.template
        if self._owns_template and tpl is not None:
            tpl.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


# ----------------------------------------------------------------------
BACKENDS: Dict[str, type] = {
    ThreadBackend.name: ThreadBackend,
    SubprocessBackend.name: SubprocessBackend,
    SnapshotBackend.name: SnapshotBackend,
}


def make_backend(backend: str) -> InstanceBackend:
    """Instantiate a registered backend by name (``PoolConfig.backend``).
    The registry is open: tests and deployments may add entries."""
    try:
        cls = BACKENDS[backend]
    except KeyError:
        raise ValueError(
            f"unknown instance backend {backend!r}; "
            f"known: {sorted(BACKENDS)}") from None
    return cls()
