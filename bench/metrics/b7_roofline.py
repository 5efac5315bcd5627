"""B7's share of its roofline (%): over the ticks that lie wholly inside
the traced window, their least bytes (``bench/bounds/b7.py``) over the
card's memory rate, over the device time of the B7 kernels that started
within them."""

import bisect

from benchlib.spec import load_json, load_module

#: The system whose run this reader reads (``record.LMRun``).
SYSTEM = "lm"


def read(run):
    if run.trace is None:
        return None
    bound = load_module("bounds", "b7")
    t0, t1 = run.trace.t_start, run.trace.t_end
    ticks = sorted((k for k in run.ticks if t0 <= k.t0 and k.t1 <= t1), key=lambda k: k.t0)
    starts = [k.t0 for k in ticks]
    kernel_s, hit = 0.0, set()
    for name, start, end in run.trace.device:
        if not bound.TRACE_NAME.search(name):
            continue
        i = bisect.bisect_right(starts, start) - 1
        if i >= 0 and start <= ticks[i].t1:
            kernel_s += end - start
            hit.add(i)
    if kernel_s <= 0:
        return None
    least = sum(bound.tick_bytes(run.config["model"], ticks[i].active, ticks[i].kv_rows)
                for i in hit) / load_json("bounds", "h100")["hbm_bytes_per_s"]
    return 100.0 * least / kernel_s
