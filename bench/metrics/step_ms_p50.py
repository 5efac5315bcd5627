"""Median host wall time of ``SlotServer.tick`` (ms), every tick that
started inside the window: one batched decode step of every slot, its
token read back to the host."""

from benchlib.record import percentile

#: The system whose run this reader reads (``record.LMRun``).
SYSTEM = "lm"


def read(run):
    p50 = percentile([k.t1 - k.t0 for k in run.window_ticks()], 50)
    return None if p50 is None else p50 * 1e3
