"""Share of the traced sub-window in which no kernel, copy or fill ran on
the card (the records' intervals merged). Taken with the profiler on,
which slows the host's dispatch: it reads higher than in an untraced
run."""

from portbench.trace import busy_s

UNIT = "%"


def read(trace):
    if trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - busy_s(trace) / trace.window_s)
