"""The trace data model: invocation events, function profiles, and loaders.

Two sources produce the same ``Trace`` object:

* **Azure Functions trace format** (``Trace.from_azure_csv``) — the public
  Azure Functions 2019 dataset shape: one CSV of per-function
  minute-bucketed invocation counts (``HashFunction``, ``Trigger``, columns
  ``"1"``..``"1440"``) plus an optional per-function duration-percentile
  CSV (``Average`` / ``percentile_Average_50`` / ... in **milliseconds**)
  and an optional memory CSV (``AverageAllocatedMb``).  Minute buckets are
  expanded to per-invocation timestamps (evenly spaced within the bucket,
  or jittered when an ``rng`` is supplied).
* **Synthetic archetypes** (``Trace.periodic`` / ``Trace.bursty`` /
  ``Trace.rare`` and ``Trace.merge``) — the invocation patterns the paper
  names as prediction opportunities, with exact timestamps, for tests and
  benchmarks.

All constructors tolerate messy input: events are sorted (out-of-order
timestamps are legal), zero-count and zero-duration rows are kept but
produce no/zero-cost events, and an empty trace is a valid trace.
"""
from __future__ import annotations

import csv
import math
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class InvocationEvent:
    """One invocation arrival in trace time (seconds from trace start)."""
    fn: str
    t: float
    duration: float = 0.0                    # expected service seconds (p50)
    chain: Optional[Tuple[str, ...]] = None  # orchestration chain rooted here


@dataclass
class FunctionProfile:
    """Per-function aggregate view: minute-bucketed counts + percentiles."""
    name: str
    counts: List[int] = field(default_factory=list)  # invocations per minute
    trigger: str = "http"
    duration_p50: float = 0.0      # seconds
    duration_p95: float = 0.0      # seconds
    memory_mb: float = 0.0

    @property
    def invocations(self) -> int:
        return sum(self.counts)

    @property
    def peak_per_minute(self) -> int:
        return max(self.counts) if self.counts else 0


def _bucket_columns(fieldnames: Sequence[str]) -> List[str]:
    """The minute-bucket columns are exactly the integer-named ones."""
    return [c for c in fieldnames if c.strip().isdigit()]


def _fn_name(row: Dict[str, str]) -> str:
    for key in ("HashFunction", "function", "fn", "name"):
        if row.get(key):
            return row[key]
    raise ValueError(f"trace row has no function name column: {list(row)}")


def load_azure_invocations(path: str) -> Dict[str, FunctionProfile]:
    """Parse an Azure-format invocations-per-minute CSV into profiles.

    Columns: any of HashOwner/HashApp (ignored), HashFunction (the key),
    Trigger, and integer-named minute buckets ("1".."1440").  Missing or
    blank bucket cells count as zero.
    """
    profiles: Dict[str, FunctionProfile] = {}
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        buckets = _bucket_columns(reader.fieldnames or [])
        buckets.sort(key=int)
        for row in reader:
            name = _fn_name(row)
            counts = [int(float(row[c])) if row.get(c, "").strip() else 0
                      for c in buckets]
            prof = profiles.setdefault(name, FunctionProfile(name))
            if prof.counts:
                # repeated rows for one function (e.g. several owners):
                # fold counts together, padding to the longer horizon
                if len(counts) > len(prof.counts):
                    prof.counts.extend([0] * (len(counts) - len(prof.counts)))
                for i, c in enumerate(counts):
                    prof.counts[i] += c
            else:
                prof.counts = counts
            prof.trigger = row.get("Trigger", prof.trigger) or prof.trigger
    return profiles


def load_azure_durations(path: str) -> Dict[str, Tuple[float, float]]:
    """Parse an Azure-format duration-percentile CSV.

    Returns fn -> (p50_seconds, p95_seconds).  Azure publishes milliseconds
    in ``percentile_Average_50`` / ``percentile_Average_95`` (falling back
    to ``Average`` when percentile columns are absent).  Zero-duration rows
    are legal and preserved as 0.0.
    """
    out: Dict[str, Tuple[float, float]] = {}
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            name = _fn_name(row)

            def ms(col: str, default: float = 0.0) -> float:
                v = row.get(col, "")
                return float(v) if str(v).strip() else default

            avg = ms("Average")
            p50 = ms("percentile_Average_50", avg)
            p95 = ms("percentile_Average_95", p50)
            out[name] = (p50 / 1e3, p95 / 1e3)
    return out


def load_azure_memory(path: str) -> Dict[str, float]:
    """Parse an Azure-format memory CSV: fn (or app) -> AverageAllocatedMb."""
    out: Dict[str, float] = {}
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            name = row.get("HashFunction") or row.get("HashApp") or ""
            if not name:
                continue
            v = row.get("AverageAllocatedMb", "")
            out[name] = float(v) if str(v).strip() else 0.0
    return out


class Trace:
    """An ordered invocation schedule plus per-function profiles."""

    def __init__(self, events: Iterable[InvocationEvent],
                 profiles: Optional[Dict[str, FunctionProfile]] = None,
                 name: str = "trace"):
        # tolerate out-of-order input: trace files are frequently shuffled
        self._events: List[InvocationEvent] = sorted(events, key=lambda e: e.t)
        self.name = name
        self.profiles: Dict[str, FunctionProfile] = profiles or {}
        for ev in self._events:
            self.profiles.setdefault(ev.fn, FunctionProfile(ev.fn))

    # -- basic views ----------------------------------------------------
    def events(self) -> List[InvocationEvent]:
        return list(self._events)

    def __len__(self) -> int:
        return len(self._events)

    @property
    def functions(self) -> List[str]:
        return sorted(self.profiles)

    @property
    def duration(self) -> float:
        """Trace horizon in trace seconds (0.0 for an empty trace)."""
        return self._events[-1].t if self._events else 0.0

    def interarrivals(self, fn: str) -> List[float]:
        """Per-function inter-arrival gaps (empty for <2 invocations)."""
        ts = [e.t for e in self._events if e.fn == fn]
        return [b - a for a, b in zip(ts, ts[1:])]

    def scaled(self, factor: float) -> "Trace":
        """A copy with every timestamp and duration (event and profile
        percentiles) multiplied by ``factor`` — trace-time compression or
        dilation.  Profiles are copied, never shared with the original;
        ``counts`` keep the original minute-bucket view (the bucket width
        is defined in original trace time)."""
        evs = [InvocationEvent(e.fn, e.t * factor, e.duration * factor,
                               e.chain) for e in self._events]
        profiles = {
            name: FunctionProfile(p.name, list(p.counts), p.trigger,
                                  p.duration_p50 * factor,
                                  p.duration_p95 * factor, p.memory_mb)
            for name, p in self.profiles.items()}
        return Trace(evs, profiles, name=self.name)

    # -- constructors ---------------------------------------------------
    @classmethod
    def from_azure_csv(cls, invocations_path: str,
                       durations_path: Optional[str] = None,
                       memory_path: Optional[str] = None,
                       rng=None, minutes: Optional[int] = None,
                       name: str = "azure") -> "Trace":
        """Load the Azure Functions trace format and expand minute buckets
        into per-invocation timestamps.

        A bucket of count ``c`` at minute ``m`` yields ``c`` events evenly
        spaced inside ``[60*m, 60*(m+1))`` — deterministic by default, or
        uniformly jittered when ``rng`` (a numpy Generator) is given.
        ``minutes`` truncates the horizon.
        """
        profiles = load_azure_invocations(invocations_path)
        durations = (load_azure_durations(durations_path)
                     if durations_path else {})
        memory = load_azure_memory(memory_path) if memory_path else {}
        events: List[InvocationEvent] = []
        for prof in profiles.values():
            p50, p95 = durations.get(prof.name, (0.0, 0.0))
            prof.duration_p50, prof.duration_p95 = p50, p95
            prof.memory_mb = memory.get(prof.name, 0.0)
            horizon = (len(prof.counts) if minutes is None
                       else min(minutes, len(prof.counts)))
            for m in range(horizon):
                c = prof.counts[m]
                if c <= 0:
                    continue
                if rng is not None:
                    offsets = sorted(rng.uniform(0.0, 60.0, size=c))
                else:
                    offsets = [(i + 0.5) * 60.0 / c for i in range(c)]
                events.extend(InvocationEvent(prof.name, 60.0 * m + off, p50)
                              for off in offsets)
        return cls(events, profiles, name=name)

    @classmethod
    def periodic(cls, fn: str, period: float, invocations: int,
                 duration: float = 0.0, phase: float = 0.0,
                 jitter: float = 0.0, rng=None,
                 chain: Optional[Sequence[str]] = None) -> "Trace":
        """Strictly periodic arrivals — the timer-trigger archetype (the
        dominant pattern in the Azure dataset).  ``jitter`` adds uniform
        noise of +/- that many seconds per tick when ``rng`` is given."""
        evs = []
        ch = tuple(chain) if chain else None
        for k in range(invocations):
            t = phase + k * period
            if jitter and rng is not None:
                t += float(rng.uniform(-jitter, jitter))
            evs.append(InvocationEvent(fn, max(0.0, t), duration, ch))
        return cls(evs, name=f"periodic-{fn}")

    @classmethod
    def bursty(cls, fn: str, bursts: int, burst_size: int, gap: float,
               rate: float, duration: float = 0.0, rng=None,
               phase: float = 0.0) -> "Trace":
        """Bursts of Poisson arrivals separated by idle gaps — the
        queue-trigger archetype that stresses scale-up and keep-alive."""
        evs, t = [], phase
        for _ in range(bursts):
            for _ in range(burst_size):
                step = (float(rng.exponential(1.0 / rate)) if rng is not None
                        else 1.0 / rate)
                t += step
                evs.append(InvocationEvent(fn, t, duration))
            t += gap
        return cls(evs, name=f"bursty-{fn}")

    @classmethod
    def rare(cls, fn: str, invocations: int, horizon: float,
             duration: float = 0.0, rng=None) -> "Trace":
        """A handful of arrivals across a long horizon — the cold-start
        worst case where keep-alive cannot help and only prediction can."""
        if rng is not None:
            ts = sorted(float(x) for x in rng.uniform(0.0, horizon,
                                                      size=invocations))
        else:
            ts = [horizon * (i + 1) / (invocations + 1)
                  for i in range(invocations)]
        return cls([InvocationEvent(fn, t, duration) for t in ts],
                   name=f"rare-{fn}")

    @classmethod
    def merge(cls, traces: Sequence["Trace"], name: str = "merged") -> "Trace":
        """Interleave several traces into one schedule (events re-sorted)."""
        events: List[InvocationEvent] = []
        profiles: Dict[str, FunctionProfile] = {}
        for tr in traces:
            events.extend(tr.events())
            profiles.update(tr.profiles)
        return cls(events, profiles, name=name)
