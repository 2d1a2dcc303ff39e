"""Measured-constant network model (the simulation carve-out, DESIGN.md §2).

The paper's evaluation places a file server at three localities (Fig 4) and
warms TCP congestion windows (Figs 5–6).  This container has one host and no
WAN, so connections are modeled explicitly:

* per-tier latency (RTT) and bandwidth, parameterized from the paper's setup
  (local on-host, edge on-site 10 Gbps LAN, remote ~50 ms away);
* TCP behaviour: 3-way handshake (1 RTT), optional TLS (+2 RTT), slow start
  from IW=10 MSS doubling per RTT up to the bandwidth-delay product, and the
  Linux idle-decay the paper cites (RFC 2861: CWND collapses back toward the
  initial window after an idle timeout);
* ``warm()`` — the freshen action — performs a dummy transfer that grows the
  CWND so a subsequent real transfer skips slow start (the paper's
  ``warm_cwnd`` mechanism half; the policy half lives in the engine).

``transfer()`` returns the modeled seconds and (optionally) sleeps a scaled
fraction so concurrency tests exercise real interleavings.
"""
from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

MSS = 1460.0                      # bytes
INITIAL_CWND = 10                 # segments (Linux default IW10)


@dataclass(frozen=True)
class Tier:
    name: str
    rtt: float                    # seconds (round trip)
    bandwidth: float              # bytes/sec
    idle_timeout: float = 1.0     # seconds before CWND decay (RFC 2861)


# Parameterized from the paper's CloudLab setup (§4)
TIERS = {
    "local": Tier("local", rtt=0.0002, bandwidth=5e9),
    "edge": Tier("edge", rtt=0.0012, bandwidth=1.25e9),     # 10 Gbps LAN
    "remote": Tier("remote", rtt=0.050, bandwidth=1.25e8),  # ~50 ms, 1 Gbps
}


class Connection:
    """A TCP(-ish) connection with explicit congestion-window state."""

    def __init__(self, tier: Tier, *, tls: bool = False,
                 clock: Callable[[], float] = time.monotonic,
                 sleep_scale: float = 0.0,
                 sleeper: Callable[[float], None] = time.sleep):
        self.tier = tier
        self.tls = tls
        self.clock = clock
        self.sleep_scale = sleep_scale
        self.sleeper = sleeper
        self._lock = threading.RLock()
        self.established = False
        self.cwnd = float(INITIAL_CWND)          # segments
        self.last_activity = -math.inf
        self.establish_count = 0
        self.transfer_count = 0

    # ------------------------------------------------------------------
    def _maybe_sleep(self, seconds: float):
        if self.sleep_scale > 0:
            self.sleeper(seconds * self.sleep_scale)

    def _bdp_segments(self) -> float:
        return max(INITIAL_CWND,
                   self.tier.bandwidth * self.tier.rtt / MSS)

    def _decay_if_idle(self):
        idle = self.clock() - self.last_activity
        if idle > self.tier.idle_timeout:
            # RFC 2861: halve per idle RTO; model as full reset to IW
            self.cwnd = float(INITIAL_CWND)

    # ------------------------------------------------------------------
    def is_alive(self) -> bool:
        with self._lock:
            if not self.established:
                return False
            # connections time out after long idleness
            return (self.clock() - self.last_activity) < 60.0

    def keepalive(self) -> float:
        """TCP keepalive probe: costs one RTT, refreshes liveness."""
        with self._lock:
            t = self.tier.rtt
            self._maybe_sleep(t)
            if self.established:
                self.last_activity = self.clock()
            return t

    def establish(self) -> float:
        """3-way handshake (+TLS).  Returns modeled seconds."""
        with self._lock:
            t = self.tier.rtt                    # SYN/SYN-ACK before data
            if self.tls:
                t += 2 * self.tier.rtt           # TLS 1.2 handshake
            self._maybe_sleep(t)
            self.established = True
            self.cwnd = float(INITIAL_CWND)
            self.last_activity = self.clock()
            self.establish_count += 1
            return t

    def transfer(self, nbytes: float) -> float:
        """Model a transfer; grows CWND; returns modeled seconds."""
        with self._lock:
            t = 0.0
            if not self.established:
                t += self.establish()
            self._decay_if_idle()
            bdp = self._bdp_segments()
            remaining = nbytes / MSS             # segments to send
            cwnd = self.cwnd
            # slow start: one cwnd-worth per RTT, doubling, until BDP
            while remaining > 0 and cwnd < bdp:
                sent = min(cwnd, remaining)
                remaining -= sent
                t += self.tier.rtt
                cwnd = min(cwnd * 2, bdp)
            if remaining > 0:                    # line-rate at full window
                t += remaining * MSS / self.tier.bandwidth + self.tier.rtt / 2
            self.cwnd = cwnd
            self.last_activity = self.clock()
            self.transfer_count += 1
            self._maybe_sleep(t)
            return t

    def warm(self, target_bytes: float = 4 * 1024 * 1024) -> float:
        """The freshen warming action: dummy transfer to open the window."""
        return self.transfer(target_bytes)
