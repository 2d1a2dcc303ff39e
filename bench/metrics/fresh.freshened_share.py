"""Share of the timer functions' invokes in the window that found every
plan entry already done by freshen: invokes that ran no entry inline and
waited for none.  Each timer invoke's cost is read from its pool's
lifetime ``FreshenState`` counters (``inline`` and ``waits``;
``InstancePool.freshen_stats``) at its send and at its answer: a timer's
ticks never overlap, and freshen's own work counts apart."""


def read(run):
    c = run["counters"]
    n = c.get("timer_invokes")
    if not n:
        return None
    return 100.0 * c["timer_freshened"] / n
