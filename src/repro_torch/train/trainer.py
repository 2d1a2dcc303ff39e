"""Training loop of the port (``repro/train/trainer.py``): a train step
with microbatch gradient accumulation, loss and metric tracking, and
periodic checkpoints.

``make_train_step`` returns a plain function (params, opt_state, batch)
-> (params, opt_state, metrics).  PyTorch runs eagerly, so there is no
``jit``: the step takes gradients with ``torch.autograd.grad`` and applies
``adamw_update``.  On the card attention runs K1 forward and K1b
backward (``kernels/ops.py``); the RG-LRU scan has no backward kernel yet
and raises there.
"""
from __future__ import annotations
# fabriclint: allow-file[clock] -- step timing is a measured wall-clock
# cost (throughput reporting), not schedulable fabric time.

import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint.io import (flatten_with_paths, save_pytree,
                                       tree_map, unflatten_paths)
from repro_torch.models.model import Model
from repro_torch.train.optimizer import (OptimizerConfig, OptState,
                                         adamw_update, init_opt_state)


def loss_and_grads(model: Model, params, batch, seq_chunk: int = 512):
    """(loss, metrics, grads) of ``model.loss`` at ``params``: the grads
    tree mirrors params, each leaf in its param's type; a param the loss
    does not reach gets zeros, as ``jax.grad`` gives it."""
    flat = {k: t.detach().requires_grad_(True)
            for k, t in flatten_with_paths(params).items()}
    with torch.enable_grad():
        loss, metrics = model.loss(unflatten_paths(flat), batch,
                                   seq_chunk=seq_chunk)
        grads = torch.autograd.grad(loss, list(flat.values()),
                                    allow_unused=True)
    grads = {k: torch.zeros_like(t) if g is None else g
             for (k, t), g in zip(flat.items(), grads)}
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, unflatten_paths(grads)


def make_train_step(model: Model, opt_cfg: OptimizerConfig, *,
                    num_microbatches: int = 1,
                    seq_chunk: int = 512) -> Callable:
    """Full step: forward and backward (accumulated over microbatches)
    and the AdamW update.  With ``num_microbatches > 1`` each
    microbatch's gradients are summed into float32 buffers and averaged,
    and, as in the reference, the metrics' ``xent`` is the mean loss and
    ``aux`` is 0."""

    def step(params, opt_state: OptState, batch):
        if num_microbatches == 1:
            loss, metrics, grads = loss_and_grads(model, params, batch,
                                                  seq_chunk)
        else:
            def split(x, i):
                B = x.shape[0]
                if B % num_microbatches:
                    raise ValueError(f"batch {B} is not a multiple of "
                                     f"{num_microbatches} microbatches")
                n = B // num_microbatches
                return x[i * n:(i + 1) * n]
            g_sum = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            l_sum = None
            for i in range(num_microbatches):
                mb = {k: split(v, i) for k, v in batch.items()}
                loss_i, _, grads = loss_and_grads(model, params, mb,
                                                  seq_chunk)
                flat_sum = flatten_with_paths(g_sum)
                for k, g in flatten_with_paths(grads).items():
                    flat_sum[k].add_(g.float())
                del grads
                l_sum = loss_i if l_sum is None else l_sum + loss_i
            grads = tree_map(lambda g: g / num_microbatches, g_sum)
            loss = l_sum / num_microbatches
            metrics = {"xent": loss,
                       "aux": torch.zeros((), dtype=torch.float32,
                                          device=loss.device)}
        params, opt_state, opt_metrics = adamw_update(opt_cfg, params, grads,
                                                      opt_state)
        return params, opt_state, {"loss": loss, **metrics, **opt_metrics}

    return step


@dataclass
class TrainerConfig:
    steps: int = 100
    log_every: int = 10
    checkpoint_every: int = 0           # 0 => disabled
    checkpoint_path: str = ""
    num_microbatches: int = 1


class Trainer:
    """Runs ``tcfg.steps`` train steps on batches from ``data_iter`` (dicts
    of numpy arrays or tensors, moved to the model's device).  Params
    come from ``params`` or from ``model.init(generator)``; the default
    generator is seeded 0 on the model's device."""

    def __init__(self, model: Model, opt_cfg: OptimizerConfig,
                 tcfg: TrainerConfig, data_iter, params=None,
                 generator: Optional[torch.Generator] = None):
        self.model = model
        self.opt_cfg = opt_cfg
        self.tcfg = tcfg
        self.data = data_iter
        if params is None:
            generator = generator or torch.Generator(
                device=model.device).manual_seed(0)
            params = model.init(generator)
        self.params = params
        self.opt_state = init_opt_state(self.params)
        self.step_fn = make_train_step(
            model, opt_cfg, num_microbatches=tcfg.num_microbatches,
            seq_chunk=256)
        self.history: list[dict] = []

    def _to_device(self, batch) -> dict:
        return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                                   else v, device=self.model.device)
                for k, v in batch.items()}

    def train_step(self, batch) -> dict:
        """One step on ``batch``; returns its metrics as Python floats."""
        self.params, self.opt_state, metrics = self.step_fn(
            self.params, self.opt_state, self._to_device(batch))
        return {k: float(v) for k, v in metrics.items()}

    def run(self) -> list[dict]:
        for i in range(self.tcfg.steps):
            batch = next(self.data)
            t0 = time.monotonic()
            metrics = self.train_step(batch)   # float() waits for the card
            metrics["step"] = i
            metrics["seconds"] = time.monotonic() - t0
            self.history.append(metrics)
            if self.tcfg.checkpoint_every and \
                    (i + 1) % self.tcfg.checkpoint_every == 0:
                save_pytree(self.tcfg.checkpoint_path,
                            {"params": self.params,
                             "mu": self.opt_state.mu,
                             "nu": self.opt_state.nu},
                            metadata={"step": i + 1})
        return self.history
