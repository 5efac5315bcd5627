"""95th percentile, over every request answered inside the window, of the
time from its submit to its answer in the client's hands (ms)."""

from benchlib.record import percentile


def read(run):
    p95 = percentile([r.latency_s for r in run.completed()], 95)
    return None if p95 is None else p95 * 1e3
