"""Tiered datastore: the "server hosting the model / external datastore" of
the paper, with three localities (Fig 4: local on-host, edge on-site, remote
off-site).

Objects live on real disk (real IO underneath); access time adds the modeled
connection transfer (repro_torch.core.network) for the chosen tier.  Objects are
versioned so the freshen cache can detect staleness.
"""
from __future__ import annotations

import os
import pickle
import threading
import time
from typing import Any, Callable, Optional, Tuple

from repro_torch.core.network import TIERS, Connection, Tier


class TieredDatastore:
    def __init__(self, root: str, tier: str = "edge", *,
                 sleep_scale: float = 0.0, tls: bool = False):
        self.root = root
        self.tier: Tier = TIERS[tier] if isinstance(tier, str) else tier
        self.sleep_scale = sleep_scale
        self.tls = tls
        os.makedirs(root, exist_ok=True)
        self._versions: dict[str, int] = {}
        self._lock = threading.Lock()
        self.get_count = 0
        self.put_count = 0
        self.modeled_seconds = 0.0

    # ------------------------------------------------------------------
    def connect(self) -> Connection:
        return Connection(self.tier, tls=self.tls,
                          sleep_scale=self.sleep_scale)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key.replace("/", "__") + ".blob")

    def put(self, key: str, value: Any,
            conn: Optional[Connection] = None) -> float:
        data = pickle.dumps(value)
        with open(self._path(key), "wb") as f:
            f.write(data)
        with self._lock:
            self._versions[key] = self._versions.get(key, 0) + 1
            self.put_count += 1
        conn = conn or self.connect()
        t = conn.transfer(len(data))
        with self._lock:
            self.modeled_seconds += t
        return t

    def get(self, key: str, conn: Optional[Connection] = None
            ) -> Tuple[Any, float]:
        """Returns (value, modeled_seconds)."""
        with open(self._path(key), "rb") as f:
            data = f.read()
        conn = conn or self.connect()
        t = conn.transfer(len(data))
        with self._lock:
            self.get_count += 1
            self.modeled_seconds += t
        return pickle.loads(data), t

    def size(self, key: str) -> int:
        return os.path.getsize(self._path(key))

    def version(self, key: str) -> int:
        with self._lock:
            return self._versions.get(key, 0)

    def exists(self, key: str) -> bool:
        return os.path.exists(self._path(key))
