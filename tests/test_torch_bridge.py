"""The weight bridge between the packages, the port's import boundary,
and the verbatim copies of the reference's JAX-free modules.

* A checkpoint written by JAX loads into the port and, written back by
  the port, loads into JAX bit for bit — bfloat16 included, which the
  port handles without ``ml_dtypes``.
* With ``jax``, ``ml_dtypes`` and ``repro`` blocked, every ``repro_torch``
  module and ``chip_smoke.py`` import.
* Each copied module equals its original once ``repro_torch.`` is mapped
  back to ``repro.`` — the only change the copies may make.
"""
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import load_pytree as jax_load  # noqa: E402
from repro.checkpoint import save_pytree as jax_save  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.models import make_model as jax_make_model  # noqa: E402
from repro_torch.checkpoint import (flatten_with_paths, load_pytree,  # noqa: E402
                                    params_from_numpy, params_to_numpy,
                                    save_pytree)

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
COPIES = sorted(
    [f"core/{m}.py" for m in (
        "__init__", "accounting", "backend", "backend_worker",
        "backend_template", "cache", "freshen", "infer", "network", "pool",
        "prediction", "resources", "runtime", "scheduler", "triggers")]
    + [f"telemetry/{m}.py" for m in ("__init__", "metrics", "tracer",
                                     "export")]
    + [f"workloads/{m}.py" for m in ("__init__", "adapt", "history",
                                     "replay", "trace")]
    + ["serving/batching.py", "serving/datastore.py",
       "cluster/__init__.py", "cluster/accounting.py", "cluster/router.py",
       "data/__init__.py", "data/pipeline.py"]
    + [f"configs/{p.name}" for p in (SRC / "repro" / "configs").glob("*.py")])


@pytest.fixture(scope="module")
def jax_params():
    cfg = get_config("qwen2-0.5b").reduced(d_model=128)     # bfloat16
    return jax_make_model(cfg).init(jax.random.PRNGKey(0))


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


def test_round_trip_is_bit_equal(jax_params, tmp_path):
    jax_save(str(tmp_path / "jax.npz"), jax_params)
    port = load_pytree(str(tmp_path / "jax.npz"), device="cpu")
    types = {k: t.dtype for k, t in flatten_with_paths(port).items()}
    assert types["seg0/[0]/mixer/wq"] == torch.bfloat16
    assert types["final_norm/scale"] == torch.float32       # kept its type
    save_pytree(str(tmp_path / "port.npz"), port, metadata={"version": 3})
    back = jax_load(str(tmp_path / "port.npz"), jax_params)
    want = jax.tree_util.tree_leaves_with_path(jax_params)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        assert got[path].dtype == leaf.dtype, path
        np.testing.assert_array_equal(_bits(got[path]), _bits(leaf))


def test_params_from_numpy_takes_jax_arrays(jax_params, tmp_path):
    """``np.asarray`` of JAX leaves (ml_dtypes bfloat16) converts without
    a conversion step, and ``params_to_numpy`` is its inverse."""
    flat = {"/".join(str(getattr(p, "key", f"[{getattr(p, 'idx', '')}]"))
                     for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(jax_params)}
    port = params_from_numpy(flat, device="cpu")
    jax_save(str(tmp_path / "jax.npz"), jax_params)
    loaded = load_pytree(str(tmp_path / "jax.npz"), device="cpu")
    a, b = flatten_with_paths(port), flatten_with_paths(loaded)
    assert a.keys() == b.keys() == flat.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    flat2, dtype_map = params_to_numpy(port)
    again = flatten_with_paths(params_from_numpy(flat2, "cpu", dtype_map))
    for k in a:
        assert torch.equal(again[k], a[k]), k
    assert isinstance(port["seg0"], tuple)


def test_port_imports_without_jax_or_reference():
    code = f"""
import importlib, importlib.util, pkgutil, sys
for name in ("jax", "jaxlib", "ml_dtypes", "repro"):
    sys.modules[name] = None
sys.path.insert(0, {str(SRC)!r})
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke",
                                              {str(ROOT / 'chip_smoke.py')!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro")
             and sys.modules[m] is not None)
assert not bad, bad
print(len(names))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) >= 30


@pytest.mark.parametrize("module", ["repro_torch.train",
                                    "repro_torch.train.trainer",
                                    "repro_torch.data",
                                    "repro_torch.launch.train"])
def test_training_modules_import_without_jax_or_reference(module):
    """The training entry points stand alone: with ``jax``, ``ml_dtypes``
    and ``repro`` blocked they import, and pull in nothing of either."""
    code = f"""
import importlib, sys
for name in ("jax", "jaxlib", "ml_dtypes", "repro"):
    sys.modules[name] = None
sys.path.insert(0, {str(SRC)!r})
importlib.import_module({module!r})
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro")
             and sys.modules[m] is not None)
assert not bad, bad
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("rel", COPIES)
def test_verbatim_copy_has_not_drifted(rel):
    original = (SRC / "repro" / rel).read_text()
    copy = (SRC / "repro_torch" / rel).read_text()
    assert "repro_torch." in copy or "repro." not in original
    assert copy.replace("repro_torch.", "repro.") == original
