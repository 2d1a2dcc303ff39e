"""What one run needs, found by the names in ``BENCHMARK.json``.

* the cell (``workloads`` entry) and its configuration file
  (``configs[].file``);
* the configuration's plain reference, the module its ``reference`` key
  names, and the program's ``ModelConfig`` for it, from the module its
  ``program`` key names or else from ``program_config`` here;
* its traffic mix: ``bench/traffic/<traffic>.json``;
* its correctness limits: ``bench/limits/<workload>.json``;
* the metrics it reports: the end-to-end metrics whose ``workloads``
  list names it (or that have none), and the per-layer metrics likewise,
  each read by ``bench/metrics/<metric name>.py``.
"""
from __future__ import annotations

import functools
import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict                     # the configuration file's contents
    mix: dict                        # the traffic file's contents
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]
    reference: ModuleType            # the configuration's plain reference
    readers: Dict[str, Callable] = field(default_factory=dict)


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in reported if "moves" in metric else True


def reader(name: str) -> Callable:
    """``read(run)`` of ``bench/metrics/<name>.py``."""
    return _load_module(BENCH / "metrics" / f"{name}.py").read


def _bench_module(rel: str) -> ModuleType:
    """The module at ``rel``, a path from the repository root to a ``.py``
    file under ``bench/``."""
    path = (ROOT / rel).resolve()
    if Path(rel).is_absolute() or path.suffix != ".py" \
            or not path.is_relative_to(BENCH) or not path.is_file():
        raise ValueError(f"{rel!r} is no .py file under bench/, given as a "
                         "path from the repository root")
    return _load_module(path)


@functools.cache
def _load_module(path: Path) -> ModuleType:
    """The module at ``path``, loaded once by path: every caller of one
    file gets the same module."""
    name = "bench_module_" + "".join(
        c if c.isalnum() else "_" for c in str(path.relative_to(ROOT)))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference(conf: dict) -> ModuleType:
    """The plain reference of a configuration file: the module its
    ``reference`` key names, with ``layout``, ``forward`` and ``no_tf32``
    (``bench/README.md``)."""
    if "reference" not in conf:
        raise ValueError(f"configuration {conf.get('name')!r} has no "
                         "'reference' key: it must name its plain reference, "
                         "e.g. \"reference\": \"bench/reference/transformer.py\"")
    return _bench_module(conf["reference"])


def model_config(conf: dict):
    """The program's ``ModelConfig`` for a configuration file: what
    ``program_config(conf)`` of the module its ``program`` key names
    returns, or without the key, ``program_config`` below."""
    if "program" in conf:
        return _bench_module(conf["program"]).program_config(conf)
    return program_config(conf)


def load(workload: str, root: Path = ROOT, bench_dir: Path = BENCH) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``, its traffic and
    limits found under ``bench_dir``."""
    bench = _load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"known: {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload, set())]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _applies(m, workload, reported)]
    config = _load_json(root / conf["file"])
    cell = Cell(name=workload, chips=int(w["chips"]), config=config,
                mix=_load_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
                limits=_load_json(bench_dir / "limits" / f"{workload}.json"),
                end_to_end=e2e, per_layer=per_layer,
                reference=reference(config))
    cell.readers = {m["name"]: reader(m["name"]) for m in per_layer}
    return cell


def program_config(conf: dict):
    """The program's ``ModelConfig`` for a configuration file with no
    ``program`` key: the program's own entry for ``arch``, with every size
    the file states, as one segment of GQA attention with a dense MLP or
    routed experts."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import MoEConfig
    m = conf["model"]
    served = {"embedding_multiplier": 1.0, "residual_multiplier": 1.0,
              "attention_multiplier": m["head_dim"] ** -0.5,
              "logits_scaling": 1.0}
    for key, v in served.items():
        if key in m and abs(float(m[key]) - v) > 1e-12:
            raise ValueError(f"the program serves {key} {v} only, not "
                             f"{m[key]}")
    base = get_config(conf["arch"])
    act = {"silu": "swiglu", "gelu_pytorch_tanh": "gelu"}[m["hidden_act"]]
    kw = dict(n_layers=m["num_hidden_layers"], d_model=m["hidden_size"],
              n_heads=m["num_attention_heads"],
              n_kv_heads=m["num_key_value_heads"], head_dim=m["head_dim"],
              d_ff=m["intermediate_size"], vocab_size=m["vocab_size"],
              activation=act, tie_embeddings=m["tie_word_embeddings"],
              norm_eps=m["rms_norm_eps"], rope_theta=m["rope_theta"],
              dtype=conf["dtype"])
    if m.get("num_local_experts"):
        moe = base.moe or MoEConfig(n_experts=1, top_k=1, d_ff=1)
        kw["moe"] = dataclasses.replace(
            moe, n_experts=m["num_local_experts"],
            top_k=m["num_experts_per_tok"], d_ff=m["intermediate_size"],
            n_shared=0, capacity_factor=m["moe_capacity_factor"],
            group_size=m["moe_group_size"])
        kind = "attn_moe"
    else:
        kind = "attn"
    kw["segments"] = (((kind,), m["num_hidden_layers"]),)
    return dataclasses.replace(base, **kw)
