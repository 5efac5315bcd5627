"""Share of the pow-2 frame buckets that the frame executables ran over
(%): 100 x the growth of ``FleetStats.canvas_px`` over that of
``bucket_px`` across the traced window.  The port's ``fleet.launch`` span
of a frame dispatch carries both counters as they stood at the launch
(``canvas_px=``, ``bucket_px=``); the first and the last such span in the
window are the two snapshots.  A port without those counters, or a window
with fewer than two such launches, gives nothing to read."""

from benchlib.spans import window

LAUNCH = "fleet.launch"


def read(run):
    w = window(run)
    if w is None:
        return None
    marks = sorted((s.t0, s.ids["canvas_px"], s.ids["bucket_px"]) for s in w.spans
                   if s.name == LAUNCH and "bucket_px" in s.ids)
    if len(marks) < 2:
        return None
    (_, canvas0, bucket0), (_, canvas1, bucket1) = marks[0], marks[-1]
    if bucket1 <= bucket0:
        return None
    return 100.0 * (canvas1 - canvas0) / (bucket1 - bucket0)
