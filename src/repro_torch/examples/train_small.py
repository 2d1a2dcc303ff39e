"""Training driver: train a small LM on the synthetic corpus with the full
substrate (data pipeline -> model -> AdamW -> checkpoint), then publish the
checkpoint to the WeightStore so the serving side can freshen against it
(version-staleness refetch).

The port's counterpart of ``examples/train_small.py``.  The body is
:func:`train`, which takes a config, a device and optional starting
params; ``main`` builds the reference's reduced float32 config from its
flags and prints the reference's lines.  On the card attention runs K1
forward and K1b backward.  As in the reference, ``main`` publishes into
a new store, so it prints version 1; a trained version meets a served
endpoint when it is published into the endpoint's own store (see
``chip_smoke.py``'s ``rollout`` phase).

The paper is a serving paper, so the REQUIRED end-to-end driver is
serve_chain.py; this demonstrates the training substrate.  Defaults are
laptop-sized; ``--dim 768 --layers 12 --steps 300`` gives a ~100M model.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_small --steps 60 [--device cpu]
"""
# fabriclint: allow-file[clock] -- nothing here reads the clock itself;
# the Trainer's step seconds are measured wall-clock costs.
import argparse
import dataclasses
import os
import tempfile
from typing import Optional

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data import DataConfig, packed_batches
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import make_model
from repro_torch.serving import WeightStore
from repro_torch.train import OptimizerConfig, Trainer, TrainerConfig


def train(cfg: ModelConfig, device: DeviceLike = "cuda", params=None, *,
          steps: int = 60, batch: int = 8, seq: int = 128,
          opt_cfg: Optional[OptimizerConfig] = None,
          checkpoint_path: str = "") -> Trainer:
    """Train ``cfg`` for ``steps`` steps on ``packed_batches`` (seed 0,
    the config's vocabulary) in 2 microbatches, as the reference does,
    from ``params`` or from the model's init (seed 0 on ``device``).

    The optimizer is the reference's (peak lr 1e-3, 20 warm-up steps,
    cosine to ``steps``) unless ``opt_cfg`` is given.  With
    ``checkpoint_path`` the Trainer checkpoints params and moments every
    ``max(10, steps // 3)`` steps.  Returns the Trainer after its run:
    ``trainer.params`` is what to publish (its checkpoint also holds the
    moments), ``trainer.history`` each step's metrics."""
    dev = resolve_device(device)
    data = packed_batches(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                     batch_size=batch, seed=0))
    trainer = Trainer(
        make_model(cfg, device=dev),
        opt_cfg or OptimizerConfig(peak_lr=1e-3, warmup_steps=20,
                                   total_steps=steps),
        TrainerConfig(steps=steps,
                      checkpoint_every=(max(10, steps // 3)
                                        if checkpoint_path else 0),
                      checkpoint_path=checkpoint_path,
                      num_microbatches=2),
        data, params=params)
    trainer.run()
    return trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--dim", type=int, default=192)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced(n_layers=args.layers,
                                        d_model=args.dim, vocab=args.vocab)
    cfg = dataclasses.replace(cfg, dtype="float32")
    n_params = cfg.param_count()
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M")

    ckpt_dir = tempfile.mkdtemp(prefix="train-small-")
    trainer = train(cfg, args.device, steps=args.steps, batch=args.batch,
                    seq=args.seq,
                    checkpoint_path=os.path.join(ckpt_dir, "ck.npz"))
    hist = trainer.history
    for h in hist[:: max(1, args.steps // 10)]:
        print(f"  step {h['step']:4d}  loss {h['loss']:.4f}  "
              f"gnorm {h['grad_norm']:.2f}  lr {h['lr']:.2e}  "
              f"{h['seconds']*1e3:.0f}ms")
    print(f"final loss: {hist[-1]['loss']:.4f} "
          f"(start {hist[0]['loss']:.4f})")

    # publish for the serving side: freshen's version_fn sees v2 and refetches
    store = WeightStore(os.path.join(ckpt_dir, "store"))
    v = store.publish("trained-small", trainer.params)
    print(f"published to WeightStore as version {v} "
          f"({store.nbytes('trained-small')/1e6:.1f} MB)")
    return trainer, store


if __name__ == "__main__":
    main()
