"""A kernel's share of its roofline, from the trace and a bound file.

``bench/bounds/<kernel>.py`` names the kernel's device functions in the
trace (``TRACE_NAME``, a regular expression) and which requests it serves
(``serves(stages)``).  The work of a request is counted from its frame and
its apps alone: the frame's pixels read once and its answer written once,
at the grid's element size, and each app's operations a pixel from
``bench/bounds/app_ops.json``.  The least time is the larger of the bytes
over the card's memory rate and the operations over its scalar peak
(``bench/bounds/h100.json``).  So a change to the canvas, the tiling or the
mapping moves the share, never the yardstick.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

from benchlib.spec import load_json, load_module
from benchlib.system import itemsize


def request_work(stages: Sequence[str], hw: Tuple[int, int], dtype: str) -> Tuple[float, float]:
    """``(bytes, operations)`` of one request."""
    ops = load_json("bounds", "app_ops")["ops_per_pixel"]
    pixels = hw[0] * hw[1]
    return 2 * pixels * itemsize(dtype), pixels * sum(ops[app] for app in stages)


def least_s(bytes_moved: float, ops: float) -> float:
    peaks = load_json("bounds", "h100")
    return max(bytes_moved / peaks["hbm_bytes_per_s"], ops / peaks["scalar_ops_per_s"])


def share_pct(run, kernel: str) -> Optional[float]:
    """100 x (the least time of the traced requests ``kernel`` served) /
    (its device time in the trace); ``None`` where the trace holds no
    launch of it or it served nothing."""
    if run.trace is None:
        return None
    bound = load_module("bounds", kernel)
    kernel_s = run.trace.device_s(bound.TRACE_NAME)
    served = [r for r in run.traced() if bound.serves(r.key.split("+"))]
    if kernel_s <= 0 or not served:
        return None
    total_bytes = total_ops = 0.0
    for r in served:
        b, o = request_work(r.key.split("+"), r.hw, run.dtype)
        total_bytes += b
        total_ops += o
    return 100.0 * least_s(total_bytes, total_ops) / kernel_s
