"""Mean of the pools' live instance count over the window, sampled by
the harness every 50 ms."""


def read(run):
    return run["counters"].get("live_instances")
