"""fabriclint: concurrency-discipline tooling for the serving fabric.

Two halves, one discipline (see ``docs/concurrency.md``):

* ``repro_torch.analysis.lint`` — an AST lint encoding the fabric's concurrency
  rules (blocking-under-lock, lock hierarchy, clock hygiene, counter
  drift, span leaks).  Run as ``python -m repro_torch.analysis.lint src tests``;
  new findings against ``tools/fabriclint_baseline.json`` fail CI.
* ``repro_torch.analysis.sanitizer`` — a runtime lock-order sanitizer: wraps
  ``threading.Lock/RLock/Condition`` creations inside ``repro`` with
  tracked proxies, maintains a per-thread held-lock stack, and builds a
  global acquisition-order graph with cycle detection.  Enabled in tests
  with ``FABRIC_SANITIZE=1`` so the concurrency and hypothesis suites
  double as deadlock detectors.

This package is stdlib-only on purpose: the lint must run before the JAX
stack is importable (e.g. as the first CI step).
"""
from repro_torch.analysis.lint import Finding, lint_paths  # noqa: F401
from repro_torch.analysis.sanitizer import LockGraph, install, uninstall  # noqa: F401
