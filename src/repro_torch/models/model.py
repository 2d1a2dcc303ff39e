"""Top-level model API of the port: init / prefill / decode_step
(``repro/models/model.py``).

A ``Model`` interprets a ``ModelConfig``.  Its entry points are plain
functions of (params, inputs); params are a dict tree that mirrors the
reference's pytree, so the freshen plan can fetch weights and the
"executable" separately and swap a new weight version in without
rebuilding anything.  ``loss``, training and ``input_specs`` are later
slices (ROADMAP.md module item 6); so are the vision/audio frontend
embeddings of pixtral and musicgen.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.checkpoint.io import tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer
from repro_torch.models.layers import (ParamFactory, dense_init,
                                      init_rmsnorm, rmsnorm_apply)
from repro_torch.specs import TensorSpec, zeros_like_specs


def _softcap(x, cap):
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


class Model:
    def __init__(self, cfg: ModelConfig, device: DeviceLike = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        for pattern, _ in cfg.segments:
            for kind in pattern:
                transformer.require_ported(kind)

    # ------------------------------------------------------------------
    def init(self, generator: torch.Generator) -> dict:
        """Random params with the reference's shapes and types, drawn
        from ``generator`` on its device and moved to the model's."""
        params = self._init(ParamFactory(generator))
        return tree_map(lambda t: t.to(self.device), params)

    def param_specs(self) -> dict:
        """``TensorSpec`` tree of :meth:`init`'s params, allocating
        nothing."""
        return self._init(ParamFactory())

    def _init(self, make: ParamFactory) -> dict:
        cfg = self.cfg
        dtype = getattr(torch, cfg.dtype)
        params: dict[str, Any] = {
            "embed": make.normal((cfg.vocab_size, cfg.d_model), dtype,
                                 cfg.d_model ** -0.5),
            "final_norm": init_rmsnorm(make, cfg.d_model),
        }
        if not cfg.tie_embeddings:
            params["unembed"] = dense_init(make, cfg.d_model, cfg.vocab_size,
                                           dtype)
        for i, (pattern, repeats) in enumerate(cfg.segments):
            params[f"seg{i}"] = transformer.init_segment(make, pattern,
                                                         repeats, cfg)
        return params

    # ------------------------------------------------------------------
    def _embed(self, params, tokens):
        cfg = self.cfg
        x = F.embedding(tokens, params["embed"])
        if cfg.scale_embedding:
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                                 device=x.device)
        return x

    def _logits(self, params, x):
        cfg = self.cfg
        x = rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
        table = params["embed"].T if cfg.tie_embeddings else params["unembed"]
        logits = x @ table.to(x.dtype)
        return _softcap(logits, cfg.final_softcap)

    # ------------------------------------------------------------------
    def forward(self, params, tokens):
        """Full-sequence forward to hidden states; returns (x, aux), aux
        the MoE load-balance loss summed over layers as a float32 scalar
        tensor on the model's device (zero without MoE layers)."""
        cfg = self.cfg
        x = self._embed(params, tokens)
        aux = 0.0
        for i, (pattern, repeats) in enumerate(cfg.segments):
            x, _, a = transformer.segment_apply(
                pattern, repeats, cfg, params[f"seg{i}"], x)
            aux = aux + a
        if not torch.is_tensor(aux):
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return x, aux

    # ------------------------------------------------------------------
    def cache_specs(self, batch: int, max_len: int) -> tuple:
        """``TensorSpec`` tree of :meth:`init_cache`'s leaves: each leaf
        has its own type, as in the reference (an RG-LRU ``h`` is float32
        in a bf16 model)."""
        return tuple(
            tuple({n: TensorSpec((repeats,) + s.shape, s.dtype)
                   for n, s in transformer.block_cache_specs(
                       kind, self.cfg, batch, max_len).items()}
                  for kind in pattern)
            for pattern, repeats in self.cfg.segments)

    def cache_shapes(self, batch: int, max_len: int) -> tuple:
        """Shapes of :meth:`init_cache`'s leaves, without allocating."""
        return tree_map(lambda s: s.shape, self.cache_specs(batch, max_len))

    def init_cache(self, batch: int, max_len: int) -> tuple:
        """Zeroed decode cache: tuple over segments of tuple over pattern
        positions of per-block dicts stacked as (repeats, ...): {"k","v"}
        of (repeats, B, L, Hkv, hd) for attention, {"h","conv"} for
        RG-LRU."""
        return zeros_like_specs(self.cache_specs(batch, max_len),
                                self.device)

    def prefill(self, params, tokens, max_len: Optional[int] = None,
                cache=None):
        """Run the prompt; returns (last-token logits, decode cache).

        ``cache``: a preallocated :meth:`init_cache` buffer to seed in
        place (a freshened session cache); a new one is made if None."""
        cfg = self.cfg
        B, S = tokens.shape
        max_len = max_len or S
        if cache is None:
            cache = self.init_cache(B, max_len)
        x = self._embed(params, tokens)
        for i, (pattern, repeats) in enumerate(cfg.segments):
            x, _, _ = transformer.segment_apply(
                pattern, repeats, cfg, params[f"seg{i}"], x,
                seg_caches=cache[i])
        logits = self._logits(params, x[:, -1:])
        return logits, cache

    def decode_step(self, params, cache, token, pos):
        """token: (B,1) int; pos: (B,) int32.  Returns (logits, cache):
        the cache is updated in place and returned."""
        cfg = self.cfg
        x = self._embed(params, token)
        for i, (pattern, repeats) in enumerate(cfg.segments):
            x, _, _ = transformer.segment_apply(
                pattern, repeats, cfg, params[f"seg{i}"], x,
                seg_caches=cache[i], pos=pos, decode=True)
        logits = self._logits(params, x)
        return logits, cache


def make_model(cfg: ModelConfig, device: DeviceLike = "cuda") -> Model:
    return Model(cfg, device=device)
