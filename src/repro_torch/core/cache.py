"""The freshen cache (§3.2 "Proactive data fetching"): TTL-, timestamp- and
version-managed storage for prefetched values, runtime-scoped."""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional


@dataclass
class CacheEntry:
    value: Any
    fetched_at: float
    ttl: Optional[float]
    version: Any = None

    def is_fresh(self, now: float, latest_version: Any = None) -> bool:
        if self.ttl is not None and (now - self.fetched_at) > self.ttl:
            return False
        if latest_version is not None and self.version != latest_version:
            return False
        return True


class FreshenCache:
    """Thread-safe key/value cache with per-entry TTL and version stamps.

    The TTL can come from (paper §3.2): a default, a per-function freshen
    config, or a per-resource override — expressed here as the precedence
    ``put(ttl=...)`` > ``resource_ttls[key]`` > ``default_ttl``.
    """

    def __init__(self, default_ttl: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.default_ttl = default_ttl
        self.resource_ttls: dict[str, float] = {}
        self.clock = clock
        self._lock = threading.Lock()
        self._data: dict[str, CacheEntry] = {}
        self.hits = 0
        self.misses = 0
        self.stale_evictions = 0

    def _ttl_for(self, key: str, ttl: Optional[float]):
        if ttl is not None:
            return ttl
        if key in self.resource_ttls:
            return self.resource_ttls[key]
        return self.default_ttl

    def put(self, key: str, value: Any, *, ttl: Optional[float] = None,
            version: Any = None):
        with self._lock:
            self._data[key] = CacheEntry(value, self.clock(),
                                         self._ttl_for(key, ttl), version)

    def get(self, key: str, latest_version: Any = None):
        """Returns (hit: bool, value)."""
        with self._lock:
            e = self._data.get(key)
            if e is None:
                self.misses += 1
                return False, None
            if not e.is_fresh(self.clock(), latest_version):
                self.stale_evictions += 1
                self.misses += 1
                del self._data[key]
                return False, None
            self.hits += 1
            return True, e.value

    def get_or_fetch(self, key: str, fetch: Callable[[], Any], *,
                     ttl: Optional[float] = None,
                     version_fn: Optional[Callable[[], Any]] = None):
        latest = version_fn() if version_fn else None
        hit, val = self.get(key, latest)
        if hit:
            return val
        val = fetch()
        self.put(key, val, ttl=ttl, version=latest)
        return val

    def stats(self):
        return {"hits": self.hits, "misses": self.misses,
                "stale_evictions": self.stale_evictions,
                "size": len(self._data)}
