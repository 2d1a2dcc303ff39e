"""Bytes over seconds of every ``WeightStore.load`` that began after the
window opened, each timed by the store itself (its returned seconds,
which include the copy onto the card), as the harness's store subclass
keeps them."""


def read(run):
    loads = run["counters"].get("loads") or []
    secs = sum(real for _, real in loads)
    if not loads or secs <= 0:
        return None
    return sum(nb for nb, _ in loads) / secs / 1e9
