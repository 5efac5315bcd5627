"""Output tokens that reached their clients inside the window (a
request's first token when ``add_request`` returned, each later one when
its ``tick`` returned), over the window's seconds."""

#: The system whose run this reader reads (``record.LMRun``).
SYSTEM = "lm"


def read(run):
    return sum(run.inside(t) for s in run.streams for t in s.token_times) / run.window_s
