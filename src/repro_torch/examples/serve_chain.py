"""End-to-end serving driver: a three-model inference pipeline behind the
freshen platform, with batched requests — the paper's serving scenario on
the PyTorch/CUDA port.

Stage chain:  embed-small -> rank-medium -> generate-small
The platform knows the chain (orchestration DAG), so invoking stage k
freshens stage k+1 (weights, kernel library, warmup) inside the trigger
window.  Requests are batched by the Batcher.

The port's counterpart of ``examples/serve_chain.py`` (whose docstring
describes the platform's pools and accounting).  ``build`` takes the
stages' configs and a store that already holds their weights, and
``run_pipeline`` also returns each request's fed-forward tokens and
logits, so ``chip_smoke.py`` and the tests can run the same pipeline at
their own widths and on their own weights.

Run this example:  PYTHONPATH=src python -m repro_torch.examples.serve_chain [--requests 12] [--device cpu]
"""
# fabriclint: allow-file[clock] -- the pipeline's wall time is a measured
# wall-clock cost.
import argparse
import dataclasses
import tempfile
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import make_model
from repro_torch.serving import (Batcher, Executor, ModelEndpoint, ServingEngine,
                                 WeightStore, pad_batch)

BATCH, SEQ = 4, 32
STAGES = ("embed-small", "rank-medium", "generate-small")
DIMS = {"embed-small": 128, "rank-medium": 256, "generate-small": 128}


def stage_configs() -> Dict[str, ModelConfig]:
    """The example's stages: qwen2-0.5b reduced to each stage's d_model,
    vocab 512, in chain order."""
    return {name: dataclasses.replace(
        get_config("qwen2-0.5b").reduced(d_model=DIMS[name]), vocab_size=512)
        for name in STAGES}


def publish_stages(cfgs: Dict[str, ModelConfig], device: DeviceLike = "cuda",
                   root: Optional[str] = None) -> WeightStore:
    """A new store holding stage i's init weights (seed i) under its name."""
    dev = resolve_device(device)
    store = WeightStore(root or tempfile.mkdtemp(prefix="serve-chain-"))
    for i, (name, cfg) in enumerate(cfgs.items()):
        params = make_model(cfg, device=dev).init(
            torch.Generator(device=dev).manual_seed(i))
        store.publish(name, params)
    return store


def build(freshen_on: bool, cfgs: Dict[str, ModelConfig],
          store: WeightStore, *, seq: int = SEQ,
          device: DeviceLike = "cuda"):
    """An engine with one endpoint per stage of ``cfgs`` (in chain
    order), served from ``store``, which holds each stage's weights under
    its name, batch ``BATCH`` x ``seq``; chained when ``freshen_on``.
    Returns ``(engine, stage names)``."""
    eng = ServingEngine()
    for name, cfg in cfgs.items():
        eng.deploy(ModelEndpoint(name, cfg, store, Executor(),
                                 batch_size=BATCH, seq_len=seq,
                                 device=device))
    stages = list(cfgs)
    if freshen_on:
        eng.chain(stages)
    return eng, stages


def run_pipeline(eng, stages, requests, freshen_on):
    """``requests`` requests through the stages, one at a time, each stage
    behind a ``Batcher`` (one row padded to the batch); a stage's input is
    the argsort of the previous stage's last logits, on the host.
    Returns ``(latencies by stage, wall seconds, outputs)``, where
    ``outputs[stage]`` holds each request's ``(tokens in, logits row)``."""
    batch, seq = (eng.endpoints[stages[0]].batch_size,
                  eng.endpoints[stages[0]].seq_len)
    vocab = eng.endpoints[stages[0]].cfg.vocab_size
    lat = {s: [] for s in stages}
    outputs = {s: [] for s in stages}

    def handler_for(stage):
        def handler(payloads):
            toks = pad_batch(payloads, batch)
            out = eng.invoke(stage, toks, freshen_successors=freshen_on)
            lat[stage].append(out["timing"]["total"])
            # only the requests' rows go back: the padding's stay behind
            return [out["logits"][i] for i in range(len(payloads))]
        return handler

    batchers = {s: Batcher(batch, handler_for(s), max_wait=0.02)
                for s in stages}
    rng = np.random.default_rng(0)
    t0 = time.monotonic()
    try:
        for i in range(requests):
            x = rng.integers(0, vocab, size=(seq,), dtype=np.int32)
            for s in stages:
                fut = batchers[s].submit(x)
                logits = fut.result(timeout=300)
                outputs[s].append((x, logits))
                x = np.argsort(logits[-1])[-seq:].astype(np.int32)  # feed fwd
        wall = time.monotonic() - t0
    finally:
        # a failing request must not leak flush-timer threads
        for b in batchers.values():
            b.close()
    return lat, wall, outputs


def report(eng, stages, lat, wall, requests, freshen_on):
    """The reference's lines: per-stage latencies, the bill, the latency
    summary and each pool's counters."""
    label = "freshen ON " if freshen_on else "freshen OFF"
    print(f"=== {label}: {requests} requests, "
          f"wall {wall:.2f}s ===")
    for s in stages:
        arr = np.array(lat[s]) * 1e3
        print(f"  {s:16s} first={arr[0]:8.1f}ms  "
              f"p50={np.percentile(arr,50):7.1f}ms  "
              f"max={arr.max():8.1f}ms  ({len(arr)} batches)")
    st = eng.scheduler.accountant.bill("serving")
    print(f"  bill: fn={st.function_seconds:.2f}s "
          f"freshen={st.freshen_seconds:.2f}s "
          f"useful={st.useful_freshens} "
          f"mispred={st.mispredicted_freshens} "
          f"cold_starts={st.cold_starts}")
    summary = eng.scheduler.accountant.latency_summary("serving")
    print(f"  latency: p50={summary['p50']*1e3:.1f}ms "
          f"p95={summary['p95']*1e3:.1f}ms p99={summary['p99']*1e3:.1f}ms "
          f"queue={summary['mean_queue_delay']*1e3:.2f}ms")
    for name, ps in eng.platform_stats().items():
        print(f"  pool[{name}]: instances={ps['instances']} "
              f"cold={ps['cold_starts']} hits={ps['hits']} "
              f"inline={ps['inline']}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfgs = stage_configs()
    store = publish_stages(cfgs, args.device)
    for mode in (False, True):
        eng, stages = build(mode, cfgs, store, device=args.device)
        try:
            lat, wall, _ = run_pipeline(eng, stages, args.requests, mode)
            report(eng, stages, lat, wall, args.requests, mode)
        finally:
            # router/worker threads must die even when the demo fails
            eng.close()


if __name__ == "__main__":
    main()
