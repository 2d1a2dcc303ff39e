"""Runtime lock-order sanitizer for the serving fabric.

``install()`` monkeypatches ``threading.Lock`` / ``RLock`` /
``Condition`` so that primitives *created inside repro modules* come
back wrapped in tracked proxies (everything else — stdlib, pytest,
third-party — keeps the real primitives).  Each tracked acquisition:

* pushes onto a per-thread held-lock stack,
* records class-level edges ``held -> acquiring`` in a global
  acquisition-order graph (:class:`LockGraph`), keyed by creation site
  (``"pool.py:_cond"``, ``"router.py:_admin"`` ...), and
* checks the declared invariants immediately:

  - **admin-under-lock** — ``_admin`` (control plane) is the outermost
    tier and must never be acquired while any other fabric lock is held;
  - **telemetry-leaf** — tracer/metrics locks are leaves: no fabric lock
    may be acquired while one is held;
  - **same-class-nesting** — two distinct instances of the same lock
    class nested (e.g. pool A's ``_cond`` inside pool B's) have no
    defined order and deadlock under inversion.

``graph.assert_acyclic()`` then proves the *observed* order is globally
consistent: a cycle in the class-level graph is a potential deadlock
even if no run ever interleaved into one.  Condition ``wait()`` is
modelled faithfully — the lock leaves the held stack for the duration of
the wait and re-records edges on re-acquisition.

Tests enable all of this with ``FABRIC_SANITIZE=1`` (see
``tests/conftest.py``); ``tests/test_sanitizer.py`` drives the pool /
router / scheduler stack through it explicitly.
"""
from __future__ import annotations

import linecache
import os
import re
import sys
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock
_REAL_CONDITION = threading.Condition

_TRACK_MARKER = os.sep + os.path.join("repro_torch", "")  # ".../repro_torch/..."
_SKIP_MARKER = os.sep + os.path.join("repro_torch", "analysis", "")

_ASSIGN_RE = re.compile(r"(?:self\.)?([A-Za-z_]\w*)\s*[:=]")

_TELEMETRY_FILES = frozenset({"tracer.py", "metrics.py"})


class LockOrderError(AssertionError):
    pass


@dataclass(frozen=True)
class Violation:
    kind: str                    # admin-under-lock | telemetry-leaf |
                                 # same-class-nesting
    acquiring: str
    held: Tuple[str, ...]
    thread: str

    def render(self) -> str:
        return (f"{self.kind}: acquiring '{self.acquiring}' while holding "
                f"{list(self.held)} on thread '{self.thread}'")


class LockGraph:
    """Class-level acquisition-order graph (creation-site keyed)."""

    def __init__(self):
        self._mu = _REAL_LOCK()
        self._edges: Dict[str, Set[str]] = {}
        self.violations: List[Violation] = []

    # -- recording -------------------------------------------------------
    def record(self, held_keys, new_key: str):
        with self._mu:
            for h in held_keys:
                if h != new_key:
                    self._edges.setdefault(h, set()).add(new_key)

    def violation(self, kind: str, acquiring: str, held_keys):
        v = Violation(kind=kind, acquiring=acquiring,
                      held=tuple(held_keys),
                      thread=threading.current_thread().name)
        with self._mu:
            self.violations.append(v)

    # -- queries ---------------------------------------------------------
    def edges(self) -> Dict[str, Set[str]]:
        with self._mu:
            return {k: set(v) for k, v in self._edges.items()}

    def find_cycle(self) -> Optional[List[str]]:
        edges = self.edges()
        WHITE, GREY, BLACK = 0, 1, 2
        color = {n: WHITE for n in
                 set(edges) | {d for ds in edges.values() for d in ds}}
        parent: Dict[str, str] = {}

        def dfs(start: str) -> Optional[List[str]]:
            stack = [(start, iter(edges.get(start, ())))]
            color[start] = GREY
            while stack:
                node, it = stack[-1]
                advanced = False
                for nxt in it:
                    if color[nxt] == GREY:          # back edge: cycle
                        cycle = [nxt, node]
                        cur = node
                        while cur != nxt:
                            cur = parent[cur]
                            cycle.append(cur)
                        cycle.reverse()
                        return cycle
                    if color[nxt] == WHITE:
                        color[nxt] = GREY
                        parent[nxt] = node
                        stack.append((nxt, iter(edges.get(nxt, ()))))
                        advanced = True
                        break
                if not advanced:
                    color[node] = BLACK
                    stack.pop()
            return None

        for node in list(color):
            if color[node] == WHITE:
                cycle = dfs(node)
                if cycle is not None:
                    return cycle
        return None

    # -- assertions ------------------------------------------------------
    def assert_acyclic(self):
        cycle = self.find_cycle()
        if cycle is not None:
            raise LockOrderError(
                "lock acquisition-order graph has a cycle (potential "
                "deadlock): " + " -> ".join(cycle))

    def assert_clean(self):
        if self.violations:
            raise LockOrderError(
                "lock-order violations:\n  " + "\n  ".join(
                    v.render() for v in self.violations))
        self.assert_acyclic()

    def reset(self):
        with self._mu:
            self._edges.clear()
            self.violations.clear()


graph = LockGraph()

_tls = threading.local()


def _held() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def held_keys() -> List[str]:
    """Creation-site keys of locks held by the current thread."""
    return [obj.key for obj in _held()]


def _is_admin(key: str) -> bool:
    return key.endswith(":_admin")


def _is_telemetry(key: str) -> bool:
    return key.split(":", 1)[0] in _TELEMETRY_FILES


def _note_acquired(obj: "_Tracked"):
    stack = _held()
    if any(h is obj for h in stack):
        stack.append(obj)                 # RLock re-entry: no new edges
        return
    if stack:
        keys = [h.key for h in stack]
        graph.record(set(keys), obj.key)
        if _is_admin(obj.key):
            graph.violation("admin-under-lock", obj.key, keys)
        if any(_is_telemetry(k) for k in keys):
            graph.violation("telemetry-leaf", obj.key, keys)
        if any(h.key == obj.key for h in stack):
            graph.violation("same-class-nesting", obj.key, keys)
    stack.append(obj)


def _note_released(obj: "_Tracked"):
    stack = _held()
    for i in range(len(stack) - 1, -1, -1):
        if stack[i] is obj:
            del stack[i]
            return


class _Tracked:
    """Proxy around a real Lock/RLock/Condition, keyed by creation site."""

    def __init__(self, inner, key: str):
        self._inner = inner
        self.key = key

    def acquire(self, *args, **kwargs):
        got = self._inner.acquire(*args, **kwargs)
        if got:
            _note_acquired(self)
        return got

    def release(self):
        _note_released(self)
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def __repr__(self):
        return f"<tracked {self.key} {self._inner!r}>"


class _TrackedCondition(_Tracked):
    """Condition proxy: ``wait`` releases the lock for its duration, so
    the held stack (and the order graph) reflect the true ownership."""

    def wait(self, timeout=None):
        _note_released(self)
        try:
            return self._inner.wait(timeout)
        finally:
            _note_acquired(self)

    def wait_for(self, predicate, timeout=None):
        _note_released(self)
        try:
            return self._inner.wait_for(predicate, timeout)
        finally:
            _note_acquired(self)

    def notify(self, n=1):
        self._inner.notify(n)

    def notify_all(self):
        self._inner.notify_all()


def _should_track(filename: str) -> bool:
    return _TRACK_MARKER in filename and _SKIP_MARKER not in filename


def _site_key(frame) -> str:
    fname = frame.f_code.co_filename
    short = os.path.basename(fname)
    line = linecache.getline(fname, frame.f_lineno)
    m = _ASSIGN_RE.match(line.strip())
    if m:
        return f"{short}:{m.group(1)}"
    return f"{short}:{frame.f_code.co_name}"


def _factory(real, condition: bool = False):
    def make(*args, **kwargs):
        inner = real(*args, **kwargs)
        frame = sys._getframe(1)
        if not _should_track(frame.f_code.co_filename):
            return inner
        cls = _TrackedCondition if condition else _Tracked
        return cls(inner, _site_key(frame))
    return make


_installed = False


def install() -> LockGraph:
    """Patch ``threading`` lock factories; idempotent.  Returns the
    global :class:`LockGraph`."""
    global _installed
    if not _installed:
        threading.Lock = _factory(_REAL_LOCK)
        threading.RLock = _factory(_REAL_RLOCK)
        threading.Condition = _factory(_REAL_CONDITION, condition=True)
        _installed = True
    return graph


def uninstall():
    """Restore the real factories (already-created tracked locks keep
    recording; the graph can simply be ``reset()``)."""
    global _installed
    threading.Lock = _REAL_LOCK
    threading.RLock = _REAL_RLOCK
    threading.Condition = _REAL_CONDITION
    _installed = False


def enabled_by_env() -> bool:
    return os.environ.get("FABRIC_SANITIZE", "") == "1"
