"""The device trace of the measured window (``--trace 1``).

``torch.profiler`` with CUDA activity records every kernel, copy and set
the card ran, whichever thread issued it.  The window is one
``record_function`` range on the driving thread; its start on the
profiler's clock and on ``perf_counter`` pin the two clocks together, so
the trace's device intervals and the host's own stamps (requests, the
flush spans below) share one time line.

The profiler records host operators of the thread that started it only,
and the port's work runs on another thread (the front end's worker, or
the load's).  So each system hands the trace its own host spans, each
``(label, start, end)`` on ``perf_counter``: the image service wraps the
fleet's public ``flush`` for the traced run (:class:`CallSpans`), a
served model gives its load's ticks and prefills.  An idle gap on the
card is named by the CUDA runtime call the host was in (the profiler
records those from every thread), else by the host span that covers most
of it, else by the system's name for the time between its spans.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import List, Optional, Tuple

from benchlib.record import Trace

WINDOW = "bench.window"
TOP = 10


def _is_device(event) -> bool:
    return "CUDA" in str(getattr(event, "device_type", ""))


def union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Overlapping intervals merged, in order."""
    merged: List[Tuple[float, float]] = []
    for start, end in sorted(spans):
        if merged and start <= merged[-1][1]:
            if end > merged[-1][1]:
                merged[-1] = (merged[-1][0], end)
        else:
            merged.append((start, end))
    return merged


def gaps(busy: List[Tuple[float, float]], t0: float, t1: float) -> List[Tuple[float, float]]:
    """The parts of ``[t0, t1]`` that ``busy`` (merged, in order) leaves free."""
    out, at = [], t0
    for start, end in busy:
        if start > at:
            out.append((at, start))
        at = max(at, end)
    if t1 > at:
        out.append((at, t1))
    return out


def short(name: str, limit: int = 120) -> str:
    """A device operation's name without its return type, anonymous
    namespaces and parameter list: ``vcgra_tile_kernel<int, true, true,
    false>`` for the whole demangled signature."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0 and name[i - 1] != " ":
            name = name[:i]
            break
    return name[:limit]


def overlap(a: Tuple[float, float], b: Tuple[float, float]) -> float:
    return max(0.0, min(a[1], b[1]) - max(a[0], b[0]))


def overlaps_by_gap(gap_list, spans):
    """For each gap (disjoint, in order), the seconds each named span
    covers of it: ``[{name: seconds}]``."""
    starts = [g[0] for g in gap_list]
    out = [defaultdict(float) for _ in gap_list]
    for name, start, end in spans:
        i = max(bisect.bisect_right(starts, start) - 1, 0)
        while i < len(gap_list) and gap_list[i][0] < end:
            share = overlap(gap_list[i], (start, end))
            if share > 0:
                out[i][name] += share
            i += 1
    return out


#: The image service's names for an idle gap inside and outside a flush.
IN_FLUSH = "host in fleet.flush, no CUDA call"
BETWEEN_FLUSHES = "host between flushes"


def name_gaps(gap_list, runtime, host, between: str) -> List[str]:
    """What the host was doing while the card idled over each gap: the
    CUDA runtime call that covers most of it, else the host span
    (``(label, start, end)``) whose label covers most of it, else
    ``between``."""
    calls = overlaps_by_gap(gap_list, runtime)
    inside = overlaps_by_gap(gap_list, host)
    names = []
    for gap, by_call, by_span in zip(gap_list, calls, inside):
        half = 0.5 * (gap[1] - gap[0])
        call = max(by_call.items(), key=lambda kv: kv[1], default=(None, 0.0))
        span = max(by_span.items(), key=lambda kv: kv[1], default=(None, 0.0))
        if call[0] is not None and call[1] >= half:
            names.append(f"host in {call[0]}")
        elif span[0] is not None and span[1] >= half:
            names.append(span[0])
        else:
            names.append(between)
    return names


def idle_names(gap_list, runtime, flushes) -> List[str]:
    """:func:`name_gaps` with the image service's flush spans ``(start,
    end)``."""
    return name_gaps(gap_list, runtime, [(IN_FLUSH, s, e) for s, e in flushes],
                     BETWEEN_FLUSHES)


class CallSpans:
    """``obj.<attr>`` wrapped to record a ``perf_counter`` span a call,
    labelled ``label``, until :meth:`close`."""

    def __init__(self, obj, attr: str, label: str):
        self.spans: List[Tuple[str, float, float]] = []
        self._obj, self._attr = obj, attr
        self._real = getattr(obj, attr)
        real = self._real

        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return real(*args, **kwargs)
            finally:
                self.spans.append((label, t0, time.perf_counter()))

        setattr(obj, attr, call)

    def close(self) -> None:
        setattr(self._obj, self._attr, self._real)


class Profiled:
    """The measured window under ``torch.profiler``: ``with`` it around
    the window; ``open()`` marks the window's start inside the profiler
    and returns it on ``perf_counter``; :meth:`reduce` reads the trace.
    ``host``: the system's host spans, an object with ``spans`` (``(label,
    start, end)``) and ``close()``, closed on exit; ``between``: the name
    of an idle gap outside them."""

    def __init__(self, host, between: str):
        self.host = host
        self.between = between
        self._stack = contextlib.ExitStack()
        self._range = None
        self.t_start = self.t_end = None

    def __enter__(self) -> "Profiled":
        from torch.profiler import ProfilerActivity, profile

        self.prof = self._stack.enter_context(
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
        return self

    def open(self) -> float:
        from torch.profiler import record_function

        self._range = record_function(WINDOW)
        self._range.__enter__()
        self.t_start = time.perf_counter()
        return self.t_start

    def close_window(self) -> float:
        self.t_end = time.perf_counter()
        self._range.__exit__(None, None, None)
        return self.t_end

    def __exit__(self, *exc) -> None:
        self._stack.close()
        self.host.close()

    def reduce(self) -> Optional[Trace]:
        """The window's device intervals on ``perf_counter``, their union,
        and the breakdown: the device operations that took the most time
        and the card's idle time by what the host was doing."""
        events = self.prof.events()
        windows = [e for e in events if e.name == WINDOW and not _is_device(e)]
        if not windows:
            return None
        w0_us, w1_us = windows[0].time_range.start, windows[0].time_range.end
        # perf_counter = us / 1e6 + shift, pinned at the window's start.
        shift = self.t_start - w0_us / 1e6
        t0, t1 = self.t_start, self.t_start + (w1_us - w0_us) / 1e6
        device, runtime = [], []
        for e in events:
            start, end = e.time_range.start / 1e6 + shift, e.time_range.end / 1e6 + shift
            if _is_device(e):
                if e.name != WINDOW and end > t0 and start < t1:
                    device.append((e.name, max(start, t0), min(end, t1)))
            elif e.name.startswith(("cuda", "cu")) and end > t0 and start < t1:
                runtime.append((e.name, start, end))
        busy = union([(s, e) for _, s, e in device])
        busy_s = sum(e - s for s, e in busy)
        by_op = defaultdict(float)
        for name, start, end in device:
            by_op[short(name)] += end - start
        idle = defaultdict(float)
        host = [s for s in self.host.spans if s[2] > t0 and s[1] < t1]
        free = gaps(busy, t0, t1)
        for gap, name in zip(free, name_gaps(free, runtime, host, self.between)):
            idle[name] += gap[1] - gap[0]
        breakdown = {
            "device_ops": sorted(([n, s] for n, s in by_op.items()), key=lambda x: -x[1])[:TOP],
            "idle_gaps": sorted(([n, s] for n, s in idle.items()), key=lambda x: -x[1])[:TOP],
        }
        return Trace(t0, t1, device, busy_s, breakdown)
