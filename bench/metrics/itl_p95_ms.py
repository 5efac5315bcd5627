"""95th percentile of the gap between consecutive output tokens of one
request (ms), over every gap that ends inside the window: a tick, and any
prefill of another slot's request that the tick waited behind."""

from benchlib.record import percentile

#: The system whose run this reader reads (``record.LMRun``).
SYSTEM = "lm"


def read(run):
    gaps = [b - a for s in run.streams for a, b in zip(s.token_times, s.token_times[1:])
            if run.inside(b)]
    p95 = percentile(gaps, 95)
    return None if p95 is None else p95 * 1e3
