"""Shape/type records for inputs and params (the port's ShapeDtypeStruct)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch


@dataclass(frozen=True)
class TensorSpec:
    """Shape and type of one tensor, and the value a new one is filled
    with (a cache leaf that does not start at zero, such as the mLSTM
    stabiliser ``m``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    fill: float = 0.0


def spec_leaves(specs) -> list:
    """The TensorSpec leaves of a dict/tuple tree, dict keys sorted."""
    if isinstance(specs, TensorSpec):
        return [specs]
    if isinstance(specs, dict):
        return [leaf for k in sorted(specs) for leaf in spec_leaves(specs[k])]
    return [leaf for s in specs for leaf in spec_leaves(s)]


def tensors_like_specs(specs, device):
    """A tree of new tensors on ``device`` shaped like ``specs``, each
    filled with its spec's ``fill``."""
    if isinstance(specs, TensorSpec):
        return torch.full(specs.shape, specs.fill, dtype=specs.dtype,
                          device=device)
    if isinstance(specs, dict):
        return {k: tensors_like_specs(v, device) for k, v in specs.items()}
    return tuple(tensors_like_specs(s, device) for s in specs)
