"""fabriclint — static concurrency-discipline lint for the serving fabric.

Usage::

    PYTHONPATH=src python -m repro_torch.analysis.lint src tests

Rules (tags in brackets are what ``# fabriclint: allow[tag]`` suppresses):

* **R1 blocking-under-lock** [blocking] — no ``time.sleep``,
  ``Future.result()``, socket/pipe I/O, backend boot/run/demote, thread
  joins, ``subprocess``/``os.fork`` or user-callback invocation inside a
  ``with self._lock:`` / ``_cond`` / ``_admin`` scope.  Functions named
  ``*_locked`` are treated as running under a caller-held lock (the
  repo's naming convention).  ``<cond>.wait()`` on a lock-like name is
  allowed: a condition wait *releases* the lock.
* **R2 lock-hierarchy** [lock-order] — lexically nested acquisitions must
  descend the declared order ``_admin`` (control plane) -> data locks
  (``_lock``/``_cond``/...) -> leaf locks (``_ring_lock``).  Same-level
  nesting is flagged; the runtime sanitizer covers cross-function order.
* **R3 clock-hygiene** [clock] — direct ``time.time()`` /
  ``time.monotonic()`` calls in ``src`` outside declared injection
  points.  References (``clock=time.monotonic`` defaults,
  ``field(default_factory=time.monotonic)``) are inherently fine — only
  *calls* are flagged — and the injection-fallback idiom
  ``time.monotonic() if now is None else now`` is structurally allowed.
* **R4 counter-drift** [counter] — augmented assignment to a known
  registry-backed counter attribute (``self.cold_starts += 1``), which
  bypasses ``MetricsRegistry``.  The telemetry package itself (the
  implementation layer) is exempt.
* **R5 span-leak** [span] — a ``tracer.invocation(...)`` /
  ``tracer.freshen(...)`` span that is neither completed
  (``finish``/``gated``/``dispatched``) nor escapes the function
  (returned, stored, passed on) leaks an open span.

Suppression: ``# fabriclint: allow[tag]`` on the finding's line or the
line above; ``# fabriclint: allow-file[tag]`` anywhere in the file.
Residual accepted findings live in ``tools/fabriclint_baseline.json``;
only *new* findings (fingerprints beyond the baseline counts) fail.
"""
from __future__ import annotations

import argparse
import ast
import json
import re
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

RULE_NAMES = {
    "R1": "blocking-under-lock",
    "R2": "lock-hierarchy",
    "R3": "clock-hygiene",
    "R4": "counter-drift",
    "R5": "span-leak",
}
RULE_TAGS = {
    "R1": "blocking",
    "R2": "lock-order",
    "R3": "clock",
    "R4": "counter",
    "R5": "span",
}

DEFAULT_BASELINE = Path("tools") / "fabriclint_baseline.json"

# A with-target counts as a lock when its terminal name looks like one of
# the fabric's lock attributes: _lock, _cond, _admin, _ring_lock,
# _state_lock, _lifecycle, _init_lock, _threads_lock, bare lock/cond ...
LOCK_NAME_RE = re.compile(r"(?:^|_)(?:lock|cond|admin|lifecycle|mutex)\d*$")

# Declared static order (R2): control plane above data locks above leaves.
# The runtime sanitizer (sanitizer.py) checks the fine-grained order.
_LEVEL_ADMIN, _LEVEL_DATA, _LEVEL_LEAF = 0, 1, 2

# Registry-backed counters (PR 8 moved these behind MetricsRegistry; the
# legacy attributes are read-only views, so a `+=` on them is drift).
COUNTER_ATTRS = frozenset({
    "cold_starts", "partial_cold_starts", "warm_acquires",
    "queued_acquires", "reaped", "dead_evictions", "demotions",
    "prewarm_dispatches", "prewarm_provisioned", "spills",
    "cross_freshens", "local_freshens", "passes", "adaptations",
    "scale_outs", "scale_ins", "waiters_expired",
    "fast_path", "slow_path",
})

_SOCKET_IO_ATTRS = frozenset({
    "recv", "recv_into", "recv_bytes", "send", "send_bytes", "sendall",
    "accept", "connect",
})
# Fabric calls that (may) block: backend boot/run, warmth promotion,
# demotion round-trips, instance init, drains.  warm_async / notify are
# deliberately absent — they are the sanctioned non-blocking variants.
_FABRIC_BLOCKING_ATTRS = frozenset({
    "run", "boot_process", "boot_init", "warm_to", "demote", "demote_to",
    "init", "shutdown", "spawn",
})
_CALLBACK_ATTRS = frozenset({"cb", "callback", "_fire_cb"})
_CALLBACK_NAMES = frozenset({"cb", "callback", "fn", "handler"})
_SUBPROCESS_ATTRS = frozenset({
    "run", "call", "check_call", "check_output", "Popen", "communicate",
})
_OS_BLOCKING_ATTRS = frozenset({"fork", "forkpty", "wait", "waitpid", "wait4"})
_SPAN_FACTORY_ATTRS = frozenset({"invocation", "freshen"})
_SPAN_COMPLETING_ATTRS = frozenset({
    "finish", "gated", "dispatched", "dispatch_done",
})

_PRAGMA_RE = re.compile(
    r"#\s*fabriclint:\s*(allow-file|allow)\[([a-z,\s-]+)\]")


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str        # posix-style path relative to the lint root
    line: int
    col: int
    scope: str       # dotted enclosing class/function path ("<module>")
    detail: str      # short stable token, e.g. "time.sleep" — part of the
                     # fingerprint, so keep it line-number free
    message: str

    @property
    def tag(self) -> str:
        return RULE_TAGS[self.rule]

    @property
    def fingerprint(self) -> str:
        # no line numbers: stable across unrelated edits above the site
        return f"{self.rule}:{self.path}:{self.scope}:{self.detail}"

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.rule}[{RULE_NAMES[self.rule]}] {self.message}")


class Pragmas:
    """``# fabriclint: allow[...]`` / ``allow-file[...]`` markers."""

    def __init__(self, source: str):
        self.line_tags: Dict[int, Set[str]] = {}
        self.file_tags: Set[str] = set()
        for lineno, text in enumerate(source.splitlines(), start=1):
            for kind, tags in _PRAGMA_RE.findall(text):
                parsed = {t.strip() for t in tags.split(",") if t.strip()}
                if kind == "allow-file":
                    self.file_tags |= parsed
                else:
                    self.line_tags.setdefault(lineno, set()).update(parsed)

    def suppressed(self, line: int, tag: str) -> bool:
        if tag in self.file_tags or "all" in self.file_tags:
            return True
        for cand in (line, line - 1):
            tags = self.line_tags.get(cand)
            if tags and (tag in tags or "all" in tags):
                return True
        return False


# ---------------------------------------------------------------------------
# small AST helpers


def _terminal_name(expr: ast.AST) -> Optional[str]:
    """The rightmost identifier of a Name/Attribute chain."""
    if isinstance(expr, ast.Name):
        return expr.id
    if isinstance(expr, ast.Attribute):
        return expr.attr
    return None


def _base_name(expr: ast.AST) -> Optional[str]:
    """For ``a.b.c`` return ``b`` (the owner of the terminal attribute)."""
    if isinstance(expr, ast.Attribute):
        return _terminal_name(expr.value)
    return None


def _lock_name(expr: ast.AST) -> Optional[str]:
    name = _terminal_name(expr)
    if name is not None and LOCK_NAME_RE.search(name):
        return name
    return None


def _lock_level(name: str) -> int:
    if name == "_admin":
        return _LEVEL_ADMIN
    if name == "_ring_lock":
        return _LEVEL_LEAF
    return _LEVEL_DATA


def _contains_name(tree: ast.AST, ident: str) -> bool:
    return any(isinstance(n, ast.Name) and n.id == ident
               for n in ast.walk(tree))


def _is_none_test(expr: ast.AST) -> bool:
    return (isinstance(expr, ast.Compare)
            and len(expr.ops) == 1
            and isinstance(expr.ops[0], (ast.Is, ast.IsNot))
            and any(isinstance(c, ast.Constant) and c.value is None
                    for c in expr.comparators))


def _blocking_reason(call: ast.Call) -> Optional[Tuple[str, str]]:
    """(detail, human reason) when this call may block / run user code."""
    func = call.func
    if isinstance(func, ast.Attribute):
        attr, base = func.attr, _terminal_name(func.value)
        if attr == "sleep":
            return "sleep", "time.sleep blocks while the lock is held"
        if attr == "result":
            return "Future.result", "Future.result() may wait indefinitely"
        if attr in ("wait", "wait_for"):
            if base is not None and LOCK_NAME_RE.search(base):
                return None        # condition wait *releases* the lock
            return (f"{base}.{attr}" if base else attr,
                    "blocking wait while the lock is held")
        if attr == "join" and (
                not call.args
                or any(kw.arg == "timeout" for kw in call.keywords)):
            return "join", "thread join while the lock is held"
        if base == "subprocess" and attr in _SUBPROCESS_ATTRS:
            return f"subprocess.{attr}", "subprocess call under a lock"
        if base == "os" and attr in _OS_BLOCKING_ATTRS:
            return (f"os.{attr}",
                    "fork/wait under a lock is a deadlock hazard "
                    "(REAP-style fork backends)")
        if attr in _SOCKET_IO_ATTRS:
            return f".{attr}", "socket/pipe I/O while the lock is held"
        if attr in _FABRIC_BLOCKING_ATTRS:
            return (f".{attr}",
                    f"backend/runtime '{attr}' may block (boot, pipe "
                    "round-trip, drain) while the lock is held")
        if attr in _CALLBACK_ATTRS:
            return (f".{attr}",
                    "user callback invoked under the lock (callbacks must "
                    "fire outside it, exactly once)")
    elif isinstance(func, ast.Name):
        if func.id == "open":
            return "open", "file I/O while the lock is held"
        if func.id == "sleep":
            return "sleep", "time.sleep blocks while the lock is held"
        if func.id == "Popen":
            return "subprocess.Popen", "subprocess spawn under a lock"
        if func.id in _CALLBACK_NAMES:
            return (func.id,
                    "user callback invoked under the lock (callbacks must "
                    "fire outside it, exactly once)")
    return None


# ---------------------------------------------------------------------------
# R1 + R2: a per-function walker that tracks the lexical lock stack


class _LockScopeWalker(ast.NodeVisitor):
    """Walks one function (or the module body) tracking ``with <lock>:``
    nesting.  Nested function/lambda bodies run *later*, outside the
    lock, so they are analyzed with a fresh stack."""

    def __init__(self, lint: "FileLint", scope: str, caller_held: bool):
        self.lint = lint
        self.scope = scope
        # (lock name, level or None) — caller-held frames have no level
        self.stack: List[Tuple[str, Optional[int]]] = []
        if caller_held:
            self.stack.append(("<caller-held>", None))

    # -- scope boundaries ------------------------------------------------
    def _enter_function(self, node, name: str):
        child_scope = f"{self.scope}.{name}" if self.scope else name
        caller_held = name.endswith("_locked")
        walker = _LockScopeWalker(self.lint, child_scope, caller_held)
        for stmt in node.body:
            walker.visit(stmt)

    def visit_FunctionDef(self, node: ast.FunctionDef):
        self._enter_function(node, node.name)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef):
        self._enter_function(node, node.name)

    def visit_Lambda(self, node: ast.Lambda):
        walker = _LockScopeWalker(self.lint, f"{self.scope}.<lambda>", False)
        walker.visit(node.body)

    def visit_ClassDef(self, node: ast.ClassDef):
        child_scope = f"{self.scope}.{node.name}" if self.scope else node.name
        walker = _LockScopeWalker(self.lint, child_scope, False)
        for stmt in node.body:
            walker.visit(stmt)

    # -- the rules -------------------------------------------------------
    def visit_With(self, node: ast.With):
        pushed = 0
        for item in node.items:
            name = _lock_name(item.context_expr)
            if name is None:
                self.visit(item.context_expr)
                continue
            level = _lock_level(name)
            for held, held_level in reversed(self.stack):
                if held_level is None:
                    continue               # unknown caller-held lock
                if level <= held_level:
                    self.lint.add(
                        "R2", item.context_expr, self.scope,
                        detail=f"{held}->{name}",
                        message=(f"'{name}' (level {level}) acquired while "
                                 f"holding '{held}' (level {held_level}); "
                                 "declared order is _admin -> data locks "
                                 "-> leaf locks, no same-level nesting"))
                break                      # only check against nearest frame
            self.stack.append((name, level))
            pushed += 1
        for stmt in node.body:
            self.visit(stmt)
        del self.stack[len(self.stack) - pushed:]

    visit_AsyncWith = visit_With

    def visit_Call(self, node: ast.Call):
        if self.stack:
            reason = _blocking_reason(node)
            if reason is not None:
                detail, why = reason
                held = self.stack[-1][0]
                self.lint.add(
                    "R1", node, self.scope, detail=detail,
                    message=f"{why} (inside '{held}' scope)")
        self.generic_visit(node)


# ---------------------------------------------------------------------------
# per-file driver


class FileLint:
    def __init__(self, path: Path, rel: str, source: str):
        self.path = path
        self.rel = rel
        self.source = source
        self.tree = ast.parse(source, filename=str(path))
        self.pragmas = Pragmas(source)
        self.findings: List[Finding] = []
        parts = Path(rel).parts
        self.clock_exempt = bool(
            {"tests", "benchmarks", "examples", "tools"} & set(parts))
        self.telemetry = "telemetry" in parts

    def add(self, rule: str, node: ast.AST, scope: str, *,
            detail: str, message: str):
        line = getattr(node, "lineno", 0)
        col = getattr(node, "col_offset", 0)
        if self.pragmas.suppressed(line, RULE_TAGS[rule]):
            return
        self.findings.append(Finding(
            rule=rule, path=self.rel, line=line, col=col,
            scope=scope or "<module>", detail=detail, message=message))

    # -- scope map for the flat passes (R3/R4/R5 run over ast.walk) ------
    def _scopes(self) -> Dict[int, str]:
        scopes: Dict[int, str] = {}

        def assign(node: ast.AST, scope: str):
            scopes[id(node)] = scope
            for child in ast.iter_child_nodes(node):
                child_scope = scope
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.ClassDef)):
                    child_scope = (f"{scope}.{child.name}" if scope
                                   else child.name)
                assign(child, child_scope)

        assign(self.tree, "")
        return scopes

    def run(self) -> List[Finding]:
        walker = _LockScopeWalker(self, "", caller_held=False)
        for stmt in self.tree.body:
            walker.visit(stmt)
        scopes = self._scopes()
        self._r3_clock(scopes)
        self._r4_counters(scopes)
        self._r5_spans(scopes)
        return self.findings

    # -- R3 --------------------------------------------------------------
    def _r3_clock(self, scopes: Dict[int, str]):
        if self.clock_exempt:
            return
        allowed_calls: Set[int] = set()
        for node in ast.walk(self.tree):
            # the injection-fallback idiom:
            #     now = time.monotonic() if now is None else now
            if isinstance(node, ast.IfExp) and _is_none_test(node.test):
                for branch in (node.body, node.orelse):
                    for sub in ast.walk(branch):
                        allowed_calls.add(id(sub))
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call) or id(node) in allowed_calls:
                continue
            func = node.func
            if (isinstance(func, ast.Attribute)
                    and isinstance(func.value, ast.Name)
                    and func.value.id == "time"
                    and func.attr in ("time", "monotonic", "perf_counter")):
                self.add(
                    "R3", node, scopes.get(id(node), ""),
                    detail=f"time.{func.attr}",
                    message=(f"direct time.{func.attr}() call; wire the "
                             "injectable clock through, or mark a "
                             "wall-clock contract with "
                             "'# fabriclint: allow[clock]'"))

    # -- R4 --------------------------------------------------------------
    def _r4_counters(self, scopes: Dict[int, str]):
        if self.telemetry:
            return                 # the implementation layer itself
        for node in ast.walk(self.tree):
            if (isinstance(node, ast.AugAssign)
                    and isinstance(node.target, ast.Attribute)
                    and node.target.attr in COUNTER_ATTRS):
                self.add(
                    "R4", node, scopes.get(id(node), ""),
                    detail=node.target.attr,
                    message=(f"direct mutation of '{node.target.attr}' "
                             "bypasses MetricsRegistry; use the registry "
                             "counter (legacy attributes are read-only "
                             "views)"))

    # -- R5 --------------------------------------------------------------
    def _r5_spans(self, scopes: Dict[int, str]):
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._r5_function(node, scopes)

    @staticmethod
    def _is_span_factory(call: ast.Call) -> bool:
        func = call.func
        if not (isinstance(func, ast.Attribute)
                and func.attr in _SPAN_FACTORY_ATTRS):
            return False
        owner = _terminal_name(func.value)
        return owner is not None and "tracer" in owner.lower()

    def _r5_function(self, fn, scopes: Dict[int, str]):
        scope = scopes.get(id(fn), fn.name)
        created: Dict[str, ast.Call] = {}
        for stmt in ast.walk(fn):
            # a bare `tracer.invocation(...)` expression drops the span
            if (isinstance(stmt, ast.Expr)
                    and isinstance(stmt.value, ast.Call)
                    and self._is_span_factory(stmt.value)):
                self.add(
                    "R5", stmt.value, scope, detail="discarded-span",
                    message=("span created and discarded; every span needs "
                             "a completing path (finish/gated/dispatched)"))
            if (isinstance(stmt, ast.Assign)
                    and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)
                    and isinstance(stmt.value, ast.Call)
                    and self._is_span_factory(stmt.value)):
                created[stmt.targets[0].id] = stmt.value
        if not created:
            return
        completed: Set[str] = set()
        escaped: Set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                func = node.func
                if (isinstance(func, ast.Attribute)
                        and isinstance(func.value, ast.Name)
                        and func.value.id in created):
                    if func.attr in _SPAN_COMPLETING_ATTRS:
                        completed.add(func.value.id)
                    continue       # method call on the span itself
                for arg in list(node.args) + [kw.value for kw in
                                              node.keywords]:
                    for var in created:
                        if _contains_name(arg, var):
                            escaped.add(var)
            elif isinstance(node, (ast.Return, ast.Yield, ast.YieldFrom)):
                if node.value is not None:
                    for var in created:
                        if _contains_name(node.value, var):
                            escaped.add(var)
            elif isinstance(node, ast.Assign):
                value_names = {var for var in created
                               if _contains_name(node.value, var)}
                if not value_names:
                    continue
                for target in node.targets:
                    if not (isinstance(target, ast.Name)
                            and target.id in value_names):
                        escaped.update(value_names)
        for var, call in created.items():
            if var not in completed and var not in escaped:
                self.add(
                    "R5", call, scope, detail=var,
                    message=(f"span '{var}' has no completing path "
                             "(finish/gated/dispatched) and never escapes "
                             f"{scope or 'the module'}"))


# ---------------------------------------------------------------------------
# tree driver + baseline


def iter_py_files(paths: Sequence[Path]) -> Iterable[Path]:
    for p in paths:
        if p.is_file() and p.suffix == ".py":
            yield p
        elif p.is_dir():
            for f in sorted(p.rglob("*.py")):
                if "__pycache__" not in f.parts:
                    yield f


def lint_paths(paths: Sequence[Path], *,
               root: Optional[Path] = None
               ) -> Tuple[List[Finding], List[str]]:
    """Lint every ``.py`` under *paths*; returns (findings, errors)."""
    root = (root or Path.cwd()).resolve()
    findings: List[Finding] = []
    errors: List[str] = []
    for f in iter_py_files(paths):
        try:
            rel = f.resolve().relative_to(root).as_posix()
        except ValueError:
            rel = f.as_posix()
        try:
            source = f.read_text(encoding="utf-8")
            findings.extend(FileLint(f, rel, source).run())
        except (SyntaxError, UnicodeDecodeError) as exc:
            errors.append(f"{rel}: {exc}")
    return findings, errors


def load_baseline(path: Path) -> Dict[str, int]:
    data = json.loads(path.read_text(encoding="utf-8"))
    return {str(k): int(v) for k, v in data.get("findings", {}).items()}


def baseline_payload(findings: Sequence[Finding]) -> dict:
    counts: Dict[str, int] = {}
    for f in findings:
        counts[f.fingerprint] = counts.get(f.fingerprint, 0) + 1
    return {
        "version": 1,
        "tool": "fabriclint",
        "findings": dict(sorted(counts.items())),
    }


def new_findings(findings: Sequence[Finding],
                 baseline: Dict[str, int]) -> List[Finding]:
    """Findings whose fingerprint count exceeds the baselined count."""
    remaining = dict(baseline)
    fresh: List[Finding] = []
    for f in findings:
        if remaining.get(f.fingerprint, 0) > 0:
            remaining[f.fingerprint] -= 1
        else:
            fresh.append(f)
    return fresh


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="fabriclint: concurrency-discipline lint "
                    "(see docs/concurrency.md)")
    parser.add_argument("paths", nargs="*", default=["src", "tests"],
                        help="files/directories to lint (default: src tests)")
    parser.add_argument("--baseline", type=Path, default=None,
                        help=f"baseline file (default: {DEFAULT_BASELINE} "
                             "when it exists)")
    parser.add_argument("--no-baseline", action="store_true",
                        help="ignore any baseline; report every finding")
    parser.add_argument("--write-baseline", action="store_true",
                        help="write current findings to the baseline file "
                             "and exit 0")
    args = parser.parse_args(argv)

    findings, errors = lint_paths([Path(p) for p in args.paths])
    for err in errors:
        print(f"fabriclint: parse error: {err}", file=sys.stderr)

    baseline_path = args.baseline
    if baseline_path is None and DEFAULT_BASELINE.exists():
        baseline_path = DEFAULT_BASELINE

    if args.write_baseline:
        target = baseline_path or DEFAULT_BASELINE
        target.parent.mkdir(parents=True, exist_ok=True)
        target.write_text(json.dumps(baseline_payload(findings), indent=2)
                          + "\n", encoding="utf-8")
        print(f"fabriclint: wrote {len(findings)} finding(s) to {target}")
        return 2 if errors else 0

    baseline: Dict[str, int] = {}
    if baseline_path is not None and not args.no_baseline:
        baseline = load_baseline(baseline_path)

    fresh = new_findings(findings, baseline)
    for f in fresh:
        print(f.render())
    baselined = len(findings) - len(fresh)
    status = (f"fabriclint: {len(fresh)} new finding(s), "
              f"{baselined} baselined")
    print(status)
    if errors:
        return 2
    return 1 if fresh else 0


if __name__ == "__main__":
    raise SystemExit(main())
