"""The port's own host spans over the traced window, for the readers of
per-flush span metrics.

The port records its spans (``repro_torch.runtime.spans``) only while
``torch.profiler`` runs, which is the ``--trace 1`` window.  A port
without that recorder, a run without a trace, or a window with no
front-end flush gives nothing to read.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

FLUSH = "frontend.flush"


class Window(NamedTuple):
    recorder: object   # the port's ``repro_torch.runtime.spans``
    recorded: list     # every span the port kept
    spans: list        # those that start inside the traced window, cut at its end
    flushes: int       # front-end flushes among them


def window(run) -> Optional[Window]:
    """The spans that start inside the traced window, each cut at the
    window's end: the profiler's own teardown, just after the window,
    holds the worker for a second or more, and the span open at the end
    would carry that stall."""
    if run.trace is None:
        return None
    try:
        from repro_torch.runtime import spans as recorder
    except ImportError:
        return None
    t0, t1 = run.trace.t_start, run.trace.t_end
    recorded = recorder.snapshot()
    spans = [s._replace(t1=min(s.t1, t1)) for s in recorded if t0 <= s.t0 <= t1]
    flushes = sum(s.name == FLUSH for s in spans)
    return Window(recorder, recorded, spans, flushes) if flushes else None


def self_ms_per_flush(run, name: str) -> Optional[float]:
    """Self time of the spans called ``name`` in the window, a flush (ms)."""
    w = window(run)
    return None if w is None else 1e3 * w.recorder.self_time(w.spans, name) / w.flushes


def ms_per_flush(run, name: str) -> Optional[float]:
    """Duration of the spans called ``name`` in the window, a flush (ms)."""
    w = window(run)
    if w is None:
        return None
    return 1e3 * sum(s.t1 - s.t0 for s in w.spans if s.name == name) / w.flushes
