"""idle_pct.step: 100 x (1 - the union of the card's device operations /
the traced window), from the profiler's trace."""


def read(run):
    return None if run.trace is None else run.trace.idle_pct()
