"""Weights made from the seed, on the device, in a few large calls.

One ``torch.randn`` per stored type, the types in order of their names,
fills a flat buffer from a generator on the device; each leaf is a view
of it in layout order, scaled in place.  The layout is the configuration's
reference's (``layout`` of the module its ``reference`` key names); the
program's own parameter specs must match it leaf for leaf, or the run
stops.
"""
from __future__ import annotations

from types import ModuleType
from typing import Dict

import torch


def make_weights(ref: ModuleType, m: dict, dtype: torch.dtype, seed: int,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """``{key path: tensor}`` for model block ``m`` in the layout of the
    reference ``ref``, drawn from ``seed``."""
    leaves = ref.layout(m, dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    totals: Dict[torch.dtype, int] = {}
    for _, shape, dt, _, _ in leaves:
        totals[dt] = totals.get(dt, 0) + _numel(shape)
    bufs = {dt: torch.randn(n, generator=gen, device=device, dtype=dt)
            for dt, n in sorted(totals.items(), key=lambda kv: str(kv[0]))}
    offsets = {dt: 0 for dt in bufs}
    out = {}
    for path, shape, dt, kind, scale in leaves:
        n = _numel(shape)
        t = bufs[dt][offsets[dt]:offsets[dt] + n].view(shape)
        offsets[dt] += n
        t.mul_(scale)
        if kind == "norm":
            t.add_(1.0)
        out[path] = t
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def check_layout(weights: Dict[str, torch.Tensor], program_specs: Dict) -> None:
    """Raise unless the program's flat parameter specs (key path ->
    object with ``shape`` and ``dtype``) name the same leaves with the
    same shapes and types as ``weights``."""
    mine = {k: (tuple(v.shape), v.dtype) for k, v in weights.items()}
    theirs = {k: (tuple(v.shape), v.dtype) for k, v in program_specs.items()}
    if mine != theirs:
        diff = sorted(set(mine.items()) ^ set(theirs.items()), key=str)
        raise RuntimeError(f"the program's parameter layout differs from "
                           f"the reference's: {diff[:8]}")


def nbytes(weights: Dict[str, torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in weights.values())
