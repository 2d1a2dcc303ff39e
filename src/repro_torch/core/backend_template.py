"""Snapshot-backend template process: pre-warmed fork source per function.

The subprocess backend pays interpreter-exec + module-import on *every*
cold start; REAP (arXiv 2101.09355) shows that cost is dominated by a
stable working set that can be recorded once and prefetched on restore.
This module is the process-level analogue: one long-lived **template
process** per (function, pool) boots the interpreter, imports ``repro``
and the spec's modules, and — after the first instance boot — prefetches
the recorded *import working set* (every module the first ``init_fn``/
plan build pulled in).  From then on a cold start is ``os.fork`` of the
template plus the function's ``init_fn``: the forked child inherits the
warmed interpreter by copy-on-write.

Split of responsibilities:

* ``SnapshotTemplate`` (platform side) — owns the template subprocess and
  a private ``AF_UNIX`` listener.  ``fork_instance()`` asks the template
  to fork, accepts the child's socket connection, drives the child's
  ``init``, and hands the connected channel to a ``SnapshotBackend``.
* template process (``main``, spawned as
  ``python -m repro_torch.core.backend_template``) — sits on the same framed
  stdin/stdout protocol as the pipe worker, serving ``init`` /
  ``prefetch`` / ``fork`` / ``exit``.  It never builds a ``Runtime``
  itself: runtimes exist only in forked children.
* forked child (``_child_serve``) — connects back to the platform's
  listener, identifies itself with the fork token, boots a thread-backed
  ``Runtime`` (measuring ``init_seconds`` = the *restore* cost), then
  enters the same ``backend_worker.serve`` run/freshen/stats/exit loop
  the subprocess worker uses.  One wire contract, two transports.

Wire choreography for one fork (platform lock held through hello so
concurrent forks cannot cross-match their connections; the child's
``init`` round-trip happens *outside* the lock so slow ``init_fn``s
boot in parallel):

    platform              template                child
    ── fork{token} ──────►
                          os.fork() ───────────►  connect(sock)
    ◄── ok{pid} ──────────
    accept()  ◄──────────────────────────────────  hello{token,pid}
    ── init{record} ─────────────────────────────►
                                                  Runtime(spec).init()
    ◄── ok{init_seconds,plan_len,imported?} ──────
    ...                                           serve() loop

POSIX-only (``os.fork`` + ``AF_UNIX``).  The template reaps its exited
children before every fork (``waitpid(-1, WNOHANG)``); children that
outlive a closed template notice socket EOF and exit.
"""
from __future__ import annotations
# fabriclint: allow-file[blocking,clock] -- the template lock serializes
# the fork protocol (pipe/socket I/O under it is the contract), and
# template-boot/fork timings are measured wall-clock costs.

import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.backend import (BackendError, read_frame, spec_payload,
                                worker_env, write_frame)

_ACCEPT_TIMEOUT = 30.0       # template fork + child connect-back budget


class SnapshotTemplate:
    """Platform-side handle on one function's pre-warmed template process.

    Lifecycle: ``start()`` (idempotent, restartable after ``close()``)
    spawns the template, ships the spec, and — unless
    ``record_working_set=False`` — boots one throwaway probe instance to
    record the import working set, which the template then prefetches so
    every later fork inherits it warm.  ``fork_instance()`` yields a
    connected ``(sock, rfile, wfile, info)`` channel for one instance.
    ``close()`` tears the template down; live forked instances keep
    serving (they die on their own channel's EOF/exit).

    Normally owned by an ``InstancePool`` (one per (function, pool),
    started at pool construction so the template spawn happens at
    register time, off the first arrival's critical path).
    """

    def __init__(self, spec, python: Optional[str] = None,
                 record_working_set: bool = True):
        self.spec = spec
        self.python = python or sys.executable
        self.record_working_set = record_working_set
        self._lock = threading.RLock()
        self._proc: Optional[subprocess.Popen] = None
        self._listener: Optional[socket.socket] = None
        self._dir: Optional[str] = None
        self._fork_seq = 0
        self.template_pid: Optional[int] = None
        self.template_boot_seconds = 0.0   # spawn + base imports + prefetch
        self.first_boot_seconds = 0.0      # the recording probe's full boot
        self.working_set: List[str] = []   # modules recorded off first boot
        self.forks = 0

    # ------------------------------------------------------------------
    @property
    def alive(self) -> bool:
        proc = self._proc
        return proc is not None and proc.poll() is None

    def _call(self, cmd: str, payload: Any) -> Any:
        """One command round-trip on the template's stdin/stdout pipes."""
        proc = self._proc
        if proc is None or proc.poll() is not None:
            raise BackendError(
                f"snapshot template for {self.spec.name!r} is not running "
                f"(command {cmd!r})")
        try:
            write_frame(proc.stdin, (cmd, payload))
            msg = read_frame(proc.stdout)
        except (OSError, ValueError) as exc:
            raise BackendError(
                f"snapshot template for {self.spec.name!r} died during "
                f"{cmd!r} ({exc})") from exc
        if msg is None:
            raise BackendError(
                f"snapshot template for {self.spec.name!r} died during "
                f"{cmd!r} (exit code {proc.poll()})")
        tag, body = msg
        if tag == "err":
            raise BackendError(
                f"snapshot template command {cmd!r} failed:\n{body}")
        return body

    def start(self) -> "SnapshotTemplate":
        with self._lock:
            if self.alive:
                return self
            t0 = time.monotonic()
            self._dir = tempfile.mkdtemp(prefix="repro-snap-")
            sock_path = os.path.join(self._dir, "fork.sock")
            listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            listener.bind(sock_path)
            listener.listen(16)
            listener.settimeout(_ACCEPT_TIMEOUT)
            self._listener = listener
            payload = spec_payload(self.spec)
            payload["sys_path"] = [p for p in sys.path if p]
            payload["socket"] = sock_path
            try:
                self._proc = subprocess.Popen(
                    [self.python, "-m", "repro_torch.core.backend_template"],
                    stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                    env=worker_env(payload["sys_path"]))
                self.template_pid = self._call("init", payload)["pid"]
                if self.record_working_set:
                    self._record()
            except BaseException:
                self.close()     # half-started template must not leak
                raise
            self.template_boot_seconds = time.monotonic() - t0
        return self

    def _record(self) -> None:
        """REAP record phase: boot one probe instance with module tracing
        on, collect the modules its init pulled in beyond the template's
        baseline, and prefetch them into the template so every later fork
        starts with the working set already imported."""
        t0 = time.monotonic()
        sock, rfile, wfile, info = self._fork_and_init(record=True)
        self.first_boot_seconds = time.monotonic() - t0
        try:
            write_frame(wfile, ("exit", None))
            read_frame(rfile)
        except (OSError, ValueError):
            pass
        finally:
            for f in (rfile, wfile, sock):
                try:
                    f.close()
                except OSError:
                    pass
        self.working_set = list(info.get("imported") or [])
        if self.working_set:
            self._call("prefetch", self.working_set)

    def fork_instance(self,
                      init: bool = True) -> Tuple[socket.socket, Any, Any,
                                                  Dict]:
        """Fork one instance off the template and (by default) drive its
        init.  Returns ``(sock, rfile, wfile, info)`` ready for the
        ``serve`` protocol; with ``init=True`` the instance is booted and
        ``info`` carries ``pid``, ``init_seconds`` (the in-child init_fn +
        plan cost) and ``plan_len``.  With ``init=False`` the fork is left
        at the PROCESS rung — interpreter and working set warm, function
        un-inited — and the caller drives ``init`` over the channel when
        (if ever) it promotes the instance."""
        self.start()                     # lazy path for standalone backends
        return self._fork_and_init(record=False, init=init)

    def _fork_and_init(self, record: bool, init: bool = True):
        with self._lock:
            self._fork_seq += 1
            token = self._fork_seq
            self._call("fork", {"token": token})
            listener = self._listener
            try:
                conn, _ = listener.accept()
            except socket.timeout:
                raise BackendError(
                    f"forked instance of {self.spec.name!r} never connected "
                    f"back (template pid {self.template_pid})") from None
            conn.settimeout(None)
            rfile = conn.makefile("rb")
            wfile = conn.makefile("wb")
            hello = read_frame(rfile)
            if (hello is None or hello[0] != "hello"
                    or hello[1].get("token") != token):
                for f in (rfile, wfile, conn):
                    f.close()
                raise BackendError(
                    f"forked instance of {self.spec.name!r} sent a bad "
                    f"hello: {hello!r}")
            self.forks += 1
        if not init:                     # PROCESS-rung standby fork
            return conn, rfile, wfile, {"pid": hello[1].get("pid")}
        # init outside the lock: slow init_fns must not serialize every
        # other fork behind this one
        try:
            write_frame(wfile, ("init", {"record": record}))
            msg = read_frame(rfile)
        except (OSError, ValueError) as exc:
            msg = None
            detail = f" ({exc})"
        else:
            detail = ""
        if msg is None:
            for f in (rfile, wfile, conn):
                try:
                    f.close()
                except OSError:
                    pass
            raise BackendError(
                f"forked instance of {self.spec.name!r} died during "
                f"init{detail}")
        tag, body = msg
        if tag == "err":
            for f in (rfile, wfile, conn):
                try:
                    f.close()
                except OSError:
                    pass
            raise BackendError(
                f"snapshot instance init for {self.spec.name!r} failed "
                f"remotely:\n{body}")
        body["pid"] = hello[1].get("pid")
        return conn, rfile, wfile, body

    def close(self) -> None:
        """Tear the template down (idempotent; ``start()`` revives it).
        Forked instances are independently owned and unaffected."""
        with self._lock:
            proc, self._proc = self._proc, None
            listener, self._listener = self._listener, None
            tmpdir, self._dir = self._dir, None
            self.template_pid = None
        if proc is not None and proc.poll() is None:
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
        if listener is not None:
            try:
                listener.close()
            except OSError:
                pass
        if tmpdir is not None:
            shutil.rmtree(tmpdir, ignore_errors=True)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


# ======================================================================
# Template process side (python -m repro_torch.core.backend_template)
# ======================================================================
def _reap_children() -> None:
    """Collect exited forked instances so they never accumulate as
    zombies in the template (the platform cannot waitpid grandchildren)."""
    while True:
        try:
            pid, _ = os.waitpid(-1, os.WNOHANG)
        except ChildProcessError:
            return
        if pid == 0:
            return


def _child_serve(spec, sock_path: str, token: int) -> None:
    """Forked-instance main: connect back, identify, serve.  The spec is
    pre-loaded (the template resolved it), so the fork enters the shared
    ``backend_worker.serve`` loop at the PROCESS rung and the platform's
    ``init`` command — sent immediately for a full boot, or later (if
    ever) for a PROCESS-rung standby — climbs it to INITIALIZED."""
    from repro_torch.core.backend_worker import serve

    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.connect(sock_path)
    rfile = sock.makefile("rb")
    wfile = sock.makefile("wb")
    write_frame(wfile, ("hello", {"token": token, "pid": os.getpid()}))
    serve(rfile, wfile, spec=spec)


def main() -> int:
    # same protocol-stream hygiene as the pipe worker: claim fd 1, then
    # point it at stderr so nothing user-visible corrupts the framing
    proto_out = os.fdopen(os.dup(sys.stdout.fileno()), "wb")
    os.dup2(sys.stderr.fileno(), sys.stdout.fileno())
    proto_in = sys.stdin.buffer

    import importlib
    import traceback

    from repro_torch.core.backend_worker import _resolve_spec

    spec = None
    sock_path = None
    while True:
        msg = read_frame(proto_in)
        if msg is None:                  # platform closed the pipe
            break
        cmd, payload = msg
        try:
            if cmd == "init":
                for p in payload.get("sys_path", []):
                    if p and p not in sys.path:
                        sys.path.append(p)
                spec = _resolve_spec(payload)
                sock_path = payload["socket"]
                # warm the platform modules every fork will need
                importlib.import_module("repro_torch.core.runtime")
                importlib.import_module("repro_torch.core.backend_worker")
                write_frame(proto_out, ("ok", {"pid": os.getpid()}))
            elif cmd == "prefetch":
                warmed = 0
                for name in payload:
                    try:
                        importlib.import_module(name)
                        warmed += 1
                    except BaseException:
                        continue         # optional module: fork re-imports
                write_frame(proto_out, ("ok", {"warmed": warmed}))
            elif cmd == "fork":
                _reap_children()
                pid = os.fork()
                if pid == 0:             # forked instance
                    try:
                        proto_in.close()
                        proto_out.close()
                    except OSError:
                        pass
                    try:
                        _child_serve(spec, sock_path, payload["token"])
                    except BaseException:
                        traceback.print_exc()
                    finally:
                        os._exit(0)
                write_frame(proto_out, ("ok", {"pid": pid}))
            elif cmd == "exit":
                write_frame(proto_out, ("ok", None))
                break
            else:
                write_frame(proto_out, ("err", f"unknown command {cmd!r}"))
        except BaseException:
            try:
                write_frame(proto_out, ("err", traceback.format_exc()))
            except BrokenPipeError:
                break
    _reap_children()
    return 0


if __name__ == "__main__":
    sys.exit(main())
