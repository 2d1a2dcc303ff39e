"""Instances the pools cold-started for the window's arrivals (the pools'
``cold_starts`` counters, before the window and after its drain)."""


def read(run):
    c = run["counters"]
    return float(c["cold_starts"]) if "cold_starts" in c else None
