"""Nothing a run loads is JAX or the JAX package (``repro``), compared by
whole top-level names: the port, ``repro_torch``, begins with ``repro``
and passes.  The reference imports nothing of the program."""
import ast
import json
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

LOAD_ALL = """
import sys
sys.path[:0] = [{src!r}, {root!r}]
import bench.run, bench.calibrate
from bench.harness import cells, check, devtrace, spec, steps, traffic, weights
from bench.roofline import counts
from bench.reference import transformer
import json
for w in json.load(open({bench!r}))["workloads"]:
    spec.load(w["name"])
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def test_a_run_loads_no_jax():
    code = LOAD_ALL.format(src=str(ROOT / "src"), root=str(ROOT),
                           bench=str(ROOT / "BENCHMARK.json"))
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


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] in {"__future__", "math", "typing",
                                          "torch"}, (path, name)


def test_forbidden_modules_compares_whole_names():
    from bench.run import forbidden_modules
    assert forbidden_modules(["repro_torch", "repro_torch.serving",
                              "jaxlibx", "flaxen.io", "numpy"]) == []
    assert forbidden_modules(["repro.core", "jax.numpy", "jaxlib",
                              "flax.linen", "torch"]) == \
        ["flax", "jax", "jaxlib", "repro"]
