"""Nothing a run loads is JAX or the JAX package (``repro``), compared by
whole top-level names: the port, ``repro_torch``, begins with ``repro``
and passes.  A reference imports nothing of the program, and no part of
the harness names a reference: each configuration's file does."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
DATA = BENCH / "tests" / "data"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
BENCHMARKS = [(ROOT, BENCH), (DATA, DATA)]     # (root, traffic and limits)

LOAD_ALL = """
import sys
sys.path[:0] = [{src!r}, {root!r}]
from pathlib import Path
import bench.run, bench.calibrate
from bench.harness import cells, check, devtrace, spec, steps, traffic, weights
from bench.roofline import counts
import json
for root, bench_dir in {benchmarks!r}:
    for w in json.load(open(Path(root) / "BENCHMARK.json"))["workloads"]:
        cell = spec.load(w["name"], Path(root), Path(bench_dir))
        spec.model_config(cell.config)
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def _named(key: str):
    """Every module a configuration of either ``BENCHMARK.json`` names
    under ``key``, as a path from the repository root."""
    out = set()
    for root, _ in BENCHMARKS:
        for c in json.loads((root / "BENCHMARK.json").read_text())["configs"]:
            conf = json.loads((root / c["file"]).read_text())
            if key in conf:
                out.add(conf[key])
    return sorted(out)


def test_a_run_loads_no_jax():
    code = LOAD_ALL.format(
        src=str(ROOT / "src"), root=str(ROOT),
        benchmarks=[(str(r), str(b)) for r, b in BENCHMARKS])
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    top = set(json.loads(p.stdout.strip().splitlines()[-1].replace("'", '"')))
    assert "repro_torch" in top and "torch" in top
    assert not top & FORBIDDEN, top & FORBIDDEN


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_bench_module_names_jax():
    for path in BENCH.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_every_configuration_names_its_modules():
    assert "bench/reference/transformer.py" in _named("reference")
    assert "bench/tests/data/reference/tiny_named.py" in _named("reference")
    assert "bench/tests/data/programs/tiny_named.py" in _named("program")


@pytest.mark.parametrize("path", sorted(
    {str(p.relative_to(ROOT)) for p in (BENCH / "reference").rglob("*.py")}
    | set(_named("reference"))))
def test_reference_imports_nothing_of_the_program(path):
    """A reference imports ``torch``, the standard library and other
    reference modules under ``bench/reference/``, and nothing else."""
    for name in _imports(ROOT / path):
        assert name.split(".")[0] in sys.stdlib_module_names | {"torch"} \
            or name == "bench.reference" \
            or name.startswith("bench.reference."), (path, name)


@pytest.mark.parametrize("path", _named("program"))
def test_program_module_names_no_jax(path):
    for name in _imports(ROOT / path):
        assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_harness_names_no_reference():
    """The harness takes each configuration's reference from its file,
    through ``spec.reference``: none of it imports a reference by name."""
    for path in [*(BENCH / "harness").rglob("*.py"), BENCH / "run.py",
                 BENCH / "calibrate.py"]:
        for name in _imports(path):
            assert not name.startswith("bench.reference"), (path, name)


def test_forbidden_modules_compares_whole_names():
    from bench.run import forbidden_modules
    assert forbidden_modules(["repro_torch", "repro_torch.serving",
                              "jaxlibx", "flaxen.io", "numpy"]) == []
    assert forbidden_modules(["repro.core", "jax.numpy", "jaxlib",
                              "flax.linen", "torch"]) == \
        ["flax", "jax", "jaxlib", "repro"]
