"""Host time the front end's worker spent between flushes a flush (ms): on
the worker's thread, from the end of each ``frontend.flush`` span in the
traced window to the start of the next ``frontend.admit`` or the window's
end (delivering the answers, waiting for arrivals, selecting the next
batch), over the window's front-end flushes."""

import bisect
from collections import defaultdict

from benchlib.spans import FLUSH, window

ADMIT = "frontend.admit"


def read(run):
    w = window(run)
    if w is None:
        return None
    admits = defaultdict(list)
    for s in w.recorded:
        if s.name == ADMIT:
            admits[s.thread].append(s.t0)
    for starts in admits.values():
        starts.sort()
    gap = 0.0
    for f in w.spans:
        if f.name == FLUSH:
            starts = admits[f.thread]
            i = bisect.bisect_left(starts, f.t1)
            end = starts[i] if i < len(starts) else run.trace.t_end
            gap += max(min(end, run.trace.t_end) - f.t1, 0.0)
    return 1e3 * gap / w.flushes
