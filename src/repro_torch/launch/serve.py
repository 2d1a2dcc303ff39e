"""Serving launcher for the port: deploy model endpoints behind the
freshen platform and drive synthetic load through a chain.

  PYTHONPATH=src python -m repro_torch.launch.serve --device cuda
  PYTHONPATH=src python -m repro_torch.launch.serve --full --seq 128 --batch 4
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --no-freshen

Without ``--full`` each stage serves the reduced config (d_model 128,
vocab 256) as the reference launcher does; ``--full`` serves the
unreduced config.  Weights are random, drawn from ``--seed``.
"""
from __future__ import annotations
# fabriclint: allow-file[clock] -- launch-time measurement harness:
# wall-clock stamps feed the printed timings only.

import argparse
import dataclasses
import tempfile
import time

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--full", action="store_true",
                    help="serve the unreduced config")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stages", type=int, default=2)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--no-freshen", action="store_true")
    ap.add_argument("--service-class", default="latency_sensitive",
                    choices=["latency_sensitive", "standard", "batch"])
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.core.accounting import ServiceClass
    from repro_torch.device import resolve_device
    from repro_torch.models import make_model
    from repro_torch.serving import (Executor, ModelEndpoint, ServingEngine,
                                     WeightStore)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = dataclasses.replace(cfg.reduced(d_model=128), vocab_size=256)
    freshen_on = not args.no_freshen
    store = WeightStore(tempfile.mkdtemp(prefix="serve-"))
    eng = ServingEngine()
    try:
        eng.scheduler.accountant.service_class["serving"] = \
            ServiceClass(args.service_class)
        names = [f"stage{i}" for i in range(args.stages)]
        for i, name in enumerate(names):
            gen = torch.Generator(device=dev).manual_seed(args.seed + i)
            store.publish(name, make_model(cfg, device=dev).init(gen))
            eng.deploy(ModelEndpoint(name, cfg, store, Executor(),
                                     batch_size=args.batch, seq_len=args.seq,
                                     device=dev))
        if freshen_on:
            eng.chain(names)

        rng = np.random.default_rng(args.seed)
        lat = {n: [] for n in names}
        t0 = time.monotonic()
        for _ in range(args.requests):
            toks = rng.integers(0, cfg.vocab_size, size=(args.batch, args.seq),
                                dtype=np.int32)
            for n in names:
                if freshen_on and n != names[0]:
                    eng.scheduler.runtimes[n].join_freshen(timeout=120)
                out = eng.invoke(n, toks, freshen_successors=freshen_on)
                lat[n].append(out["timing"]["total"])
        wall = time.monotonic() - t0

        print(f"device={dev} arch={cfg.name} "
              f"mode={'freshen' if freshen_on else 'baseline'} "
              f"requests={args.requests} wall={wall:.2f}s")
        for n in names:
            arr = np.array(lat[n]) * 1e3
            print(f"  {n}: first={arr[0]:.1f}ms "
                  f"p50={np.percentile(arr, 50):.1f}ms")
            st = eng.scheduler.runtimes[n].fr_state.stats()
            print(f"     freshen stats: {st}")
        bill = eng.scheduler.accountant.bill("serving")
        print(f"bill: fn={bill.function_seconds:.2f}s "
              f"freshen={bill.freshen_seconds:.2f}s "
              f"overhead={bill.freshen_overhead_ratio*100:.1f}% "
              f"useful={bill.useful_freshens} "
              f"mispred={bill.mispredicted_freshens}")
    finally:
        eng.close()


if __name__ == "__main__":
    main()
