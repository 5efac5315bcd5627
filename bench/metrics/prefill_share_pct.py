"""Share of the window spent in ``SlotServer.add_request`` (%): the
prefills' host spans, cut at the window's edges, over its seconds."""

#: The system whose run this reader reads (``record.LMRun``).
SYSTEM = "lm"


def read(run):
    inside = sum(max(0.0, min(p.t1, run.t_end) - max(p.t0, run.t_start)) for p in run.prefills)
    return 100.0 * inside / run.window_s
