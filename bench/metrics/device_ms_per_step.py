"""Device time a decode step (ms): the union of every kernel, copy and set
on the card in the traced window (prefills' work included), over the ticks
that started inside it."""

#: The system whose run this reader reads (``record.LMRun``).
SYSTEM = "lm"


def read(run):
    ticks = run.window_ticks()
    if run.trace is None or not ticks:
        return None
    return 1e3 * run.trace.busy_s / len(ticks)
