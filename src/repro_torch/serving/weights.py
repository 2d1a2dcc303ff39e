"""Versioned weight store (``repro/serving/weights.py``): "downloading
the ML model from a server", the paper's canonical redundant overhead.
Weights are real ``.npz`` checkpoints in the reference layout
(``repro_torch.checkpoint``); loading measures real IO, deserialization
and the copy onto the endpoint's device, plus the modeled tier transfer
when the store sits behind a datastore tier.
"""
from __future__ import annotations
# fabriclint: allow-file[clock] -- weight-load seconds are measured
# wall-clock costs fed to the freshen planner.

import os
import threading
import time
from typing import Any, Optional, Tuple

import torch

from repro_torch.checkpoint import load_pytree, save_pytree
from repro_torch.core.network import TIERS, Connection
from repro_torch.device import DeviceLike, resolve_device


class WeightStore:
    def __init__(self, root: str, tier: str = "edge"):
        self.root = root
        self.tier = TIERS[tier]
        os.makedirs(root, exist_ok=True)
        self._versions: dict[str, int] = {}
        self._lock = threading.Lock()
        self.load_count = 0

    def _path(self, name: str) -> str:
        return os.path.join(self.root, f"{name}.npz")

    # ------------------------------------------------------------------
    def publish(self, name: str, params) -> int:
        """Store a new weight version; returns the version number.  The
        file is the reference layout, so the JAX package loads it too."""
        with self._lock:
            v = self._versions.get(name, 0) + 1
            self._versions[name] = v
        save_pytree(self._path(name), params, metadata={"version": v})
        return v

    def version(self, name: str) -> int:
        with self._lock:
            return self._versions.get(name, 0)

    def load(self, name: str, conn: Optional[Connection] = None,
             device: DeviceLike = "cuda") -> Tuple[Any, float, float]:
        """Returns (params on ``device``, real_seconds,
        modeled_transfer_seconds).  The real seconds include the copy to
        the card and wait for it."""
        dev = resolve_device(device)
        t0 = time.monotonic()
        params = load_pytree(self._path(name), dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        real = time.monotonic() - t0
        nbytes = os.path.getsize(self._path(name))
        conn = conn or Connection(self.tier)
        modeled = conn.transfer(nbytes)
        with self._lock:
            self.load_count += 1
        return params, real, modeled

    def nbytes(self, name: str) -> int:
        return os.path.getsize(self._path(name))
