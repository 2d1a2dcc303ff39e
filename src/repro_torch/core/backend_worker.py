"""The subprocess-backend worker: one sandboxed instance per process.

Spawned by ``repro_torch.core.backend.SubprocessBackend`` as
``python -m repro_torch.core.backend_worker``.  Speaks the length-prefixed
pickle frame protocol on stdin/stdout: the parent sends ``(cmd, payload)``
and gets back ``("ok", result)`` or ``("err", traceback_text)``.

The command loop mirrors the warmth ladder: a freshly spawned worker *is*
the PROCESS rung (interpreter up, function un-inited), ``init`` climbs to
INITIALIZED, and ``demote`` walks back down without tearing the process
down.

Commands:

* ``load``    — extend ``sys.path`` and materialize the ``FunctionSpec``
  (``spec_ref`` = ``"module:attr"`` resolving to a spec or a zero-arg
  factory, else ``spec_pickle`` bytes).  No runtime is built: the wall
  time the parent measures around spawn + this round-trip is the PROCESS
  rung's cost.
* ``init``    — build a thread-backed ``Runtime`` from the loaded spec
  and run its init hook (``init_fn`` + plan build — the INITIALIZED
  rung).  For compat the payload may carry the spec/sys_path inline
  (legacy single-shot boot); ``record: true`` additionally reports the
  modules the init pulled in beyond the pre-init baseline (the snapshot
  template's REAP working-set probe).
* ``demote``  — release warmth: ``level >= 2`` invalidates the fr caches
  (HOT -> INITIALIZED); ``level <= 1`` drops the runtime entirely while
  the process stays resident (-> PROCESS).
* ``run``     — execute the run hook with the unpickled args.
* ``freshen`` — execute the freshen hook (Algorithm 2) to completion.
* ``stats``   — fr_state counters plus run/freshen hook counts.
* ``exit``    — acknowledge and terminate.  EOF on stdin (parent gone)
  also terminates, so workers never outlive their platform.

The loop lives in ``serve()`` so snapshot-backend forks
(``repro_torch.core.backend_template``) speak the identical protocol over their
unix-socket channel: one wire contract, two transports (a fork enters
``serve`` with its spec pre-loaded — the template already resolved it).

File descriptor 1 is re-pointed at stderr before any user code runs: a
function body that prints can never corrupt the protocol stream.
"""
from __future__ import annotations

import importlib
import os
import pickle
import sys
import traceback


def _resolve_spec(payload):
    from repro_torch.core.runtime import FunctionSpec
    ref = payload.get("spec_ref")
    if ref:
        mod_name, _, attr = ref.partition(":")
        if not mod_name or not attr:
            raise ValueError(f"spec_ref must be 'module:attr', got {ref!r}")
        obj = getattr(importlib.import_module(mod_name), attr)
        if not isinstance(obj, FunctionSpec):
            obj = obj()
        if not isinstance(obj, FunctionSpec):
            raise TypeError(f"spec_ref {ref!r} did not yield a FunctionSpec")
        return obj
    return pickle.loads(payload["spec_pickle"])


def _extend_sys_path(payload) -> None:
    for p in payload.get("sys_path", []):
        if p and p not in sys.path:
            sys.path.append(p)


def serve(proto_in, proto_out, runtime=None, spec=None) -> None:
    """The instance command loop, shared by the pipe worker and snapshot-
    template forks.  Returns on ``exit`` or channel EOF; hook exceptions
    are reported as ``("err", tb)`` frames and the loop continues — an
    instance survives a failing run hook, and a failing ``init`` leaves
    the worker at the PROCESS rung for a clean retry."""
    from repro_torch.core.backend import read_frame, write_frame
    from repro_torch.core.runtime import Runtime, WarmthLevel

    while True:
        msg = read_frame(proto_in)
        if msg is None:                      # parent closed the channel
            return
        cmd, payload = msg
        try:
            if cmd == "load":
                _extend_sys_path(payload)
                spec = _resolve_spec(payload)
                runtime = None
                write_frame(proto_out, ("ok", {"pid": os.getpid()}))
            elif cmd == "init":
                payload = payload or {}
                if "spec_ref" in payload or "spec_pickle" in payload:
                    _extend_sys_path(payload)
                    spec = _resolve_spec(payload)
                if spec is None:
                    write_frame(proto_out,
                                ("err", "no spec loaded (command 'init')"))
                    continue
                record = bool(payload.get("record"))
                baseline = set(sys.modules) if record else None
                runtime = None
                rt = Runtime(spec)           # thread-backed inside the worker
                rt.init()
                runtime = rt
                info = {
                    "init_seconds": runtime.init_seconds,
                    "plan_len": len(runtime.fr_state.plan),
                    "pid": os.getpid(),
                }
                if record:
                    info["imported"] = sorted(set(sys.modules) - baseline)
                write_frame(proto_out, ("ok", info))
            elif cmd == "demote":
                level = WarmthLevel(int((payload or {}).get("level", 0)))
                if runtime is not None:
                    if level >= WarmthLevel.INITIALIZED:
                        runtime.demote_to(level)
                    else:
                        runtime = None       # process stays resident
                write_frame(proto_out, ("ok", {"level": int(level)}))
            elif cmd == "run":
                if runtime is None:
                    write_frame(proto_out,
                                ("err", "not initialized (command 'run')"))
                else:
                    write_frame(proto_out, ("ok", runtime.run(payload)))
            elif cmd == "freshen":
                if runtime is None:
                    write_frame(proto_out,
                                ("err",
                                 "not initialized (command 'freshen')"))
                else:
                    runtime.freshen(blocking=True)
                    write_frame(proto_out, ("ok", runtime.fr_state.stats()))
            elif cmd == "stats":
                if runtime is None:
                    write_frame(proto_out,
                                ("err", "not initialized (command 'stats')"))
                else:
                    stats = dict(runtime.fr_state.stats())
                    stats["run_count"] = runtime.run_count
                    stats["freshen_count"] = runtime.freshen_count
                    write_frame(proto_out, ("ok", stats))
            elif cmd == "exit":
                write_frame(proto_out, ("ok", None))
                return
            else:
                write_frame(proto_out, ("err", f"unknown command {cmd!r}"))
        except BaseException:
            try:
                write_frame(proto_out, ("err", traceback.format_exc()))
            except (BrokenPipeError, OSError):
                return


def main() -> int:
    # claim the protocol channel, then point fd 1 at stderr so user-code
    # prints (and library chatter) land in the parent's stderr instead
    proto_out = os.fdopen(os.dup(sys.stdout.fileno()), "wb")
    os.dup2(sys.stderr.fileno(), sys.stdout.fileno())
    proto_in = sys.stdin.buffer
    serve(proto_in, proto_out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
