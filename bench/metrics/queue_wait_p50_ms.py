"""Median wait of a request from its submit to the start of the flush that
served it (ms): the front end's own ``queue_s`` stamp, every request
answered inside the window."""

from benchlib.record import percentile


def read(run):
    p50 = percentile([r.queue_s for r in run.completed()], 50)
    return None if p50 is None else p50 * 1e3
