"""Serving launcher for the port: deploy model endpoints behind the
freshen platform and drive synthetic load through a chain.

  PYTHONPATH=src python -m repro_torch.launch.serve --device cuda
  PYTHONPATH=src python -m repro_torch.launch.serve --full --seq 128 --batch 4
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --no-freshen
  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b --full
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-moe-1b-a400m --full
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-350m --full --seq 128

Without ``--full`` each stage serves the reduced config (d_model 128,
vocab 256) as the reference launcher does; ``--full`` serves the
unreduced config.  Weights are random, drawn from ``--seed``.  Every
config of ``repro_torch.configs`` is served; the bytes are one stage's
bf16 weights at ``--full``:

- ``qwen2-0.5b`` (the default; 0.99 GB);
- ``recurrentgemma-2b`` (RG-LRU and local attention; 4.29 GB);
- ``granite-moe-1b-a400m`` (attention and a 32-expert top-8 MoE;
  2.67 GB);
- ``deepseek-v2-lite-16b`` (MLA, a dense first layer, then 64-expert
  top-6 MoE layers with 2 shared experts; 31.4 GB);
- ``xlstm-350m`` (12 mLSTM and 12 sLSTM blocks; 0.75 GB; the mLSTM
  prefill runs in chunks of 64, so ``--seq`` must be a multiple of 64
  or below it);
- ``musicgen-medium`` (48 layers, 24/24 heads, tanh-GELU MLP; 2.73 GB);
- ``phi3-medium-14b`` (40/10 heads at dh 128; 29.3 GB);
- ``nemotron-4-15b`` (48/8 heads, squared-ReLU MLP, vocab 256000;
  31.3 GB);
- ``pixtral-12b`` (32/8 heads, ``rope_theta`` 1e6; 24.5 GB);
- ``gemma2-27b`` (4096-window local layers between global ones,
  softcaps, post-norms; 54.5 GB).

deepseek and the last five have run on a card at their published
widths (``chip_smoke.py``: musicgen uncut, the others cut to 4 layers);
their uncut runs are what remains of ROADMAP.md item 3 ("Served at full
size").  An MoE layer dispatches whole groups of tokens, so batch x seq
must be a multiple of the config's ``group_size`` (512) or below it.
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
