"""Training launcher for the port (``repro/launch/train.py``).

Trains the reduced float32 variant of ``--arch`` on the synthetic corpus
(``repro_torch.data``) for real, on the card by default:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b --steps 50
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --arch qwen2-0.5b --steps 20

On the card attention runs K1 forward and K1b backward; recurrentgemma's
RG-LRU scan has no backward kernel yet and raises there (ROADMAP.md
module item 6c), so that family trains on the CPU only.  ``--dry-run``
(lowering the full config on a production mesh) is not ported yet.
"""
from __future__ import annotations

import argparse
import dataclasses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dry-run", action="store_true",
                    help="lower+compile train_4k on the production mesh")
    args = ap.parse_args(argv)

    if args.dry_run:
        raise NotImplementedError(
            "--dry-run is not ported yet: ROADMAP.md module item 8b "
            "(launch/dryrun.py)")

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, packed_batches
    from repro_torch.device import resolve_device
    from repro_torch.models import make_model
    from repro_torch.train import OptimizerConfig, Trainer, TrainerConfig

    dev = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    cfg = dataclasses.replace(cfg, dtype="float32")
    model = make_model(cfg, device=dev)
    print(f"training {cfg.name} on {dev}: {cfg.param_count()/1e6:.1f}M "
          f"params (reduced variant)")
    data = packed_batches(DataConfig(vocab_size=cfg.vocab_size,
                                     seq_len=args.seq,
                                     batch_size=args.batch, seed=0))
    trainer = Trainer(
        model,
        OptimizerConfig(peak_lr=args.lr, warmup_steps=args.steps // 10,
                        total_steps=args.steps),
        TrainerConfig(steps=args.steps, num_microbatches=args.microbatches,
                      checkpoint_every=(args.steps if args.checkpoint else 0),
                      checkpoint_path=args.checkpoint),
        data)
    hist = trainer.run()
    for h in hist[:: max(1, args.steps // 10)]:
        print(f"step {h['step']:4d} loss {h['loss']:.4f} "
              f"gnorm {h['grad_norm']:.2f} {h['seconds']*1e3:.0f}ms")
    print(f"done: loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}")
    return hist


if __name__ == "__main__":
    main()
