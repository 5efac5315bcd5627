"""The request tail where the host paces the service (ms): as the
end-to-end ``request_p95_ms``, read in the traced run of a host-bound cell."""

from benchlib.record import percentile


def read(run):
    p95 = percentile([r.latency_s for r in run.completed()], 95)
    return None if p95 is None else p95 * 1e3
