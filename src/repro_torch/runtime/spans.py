"""Host spans of the serving path, recorded only while ``torch.profiler``
runs in the process.

A span is ``(name, t0, t1, thread, span_id, parent, ids)``: ``t0``/``t1``
on ``time.perf_counter()`` (the clock a traced benchmark pins the
profiler's device intervals to), the recording thread, the enclosing span
on that thread (so a reader can compute self time), and small ids that tie
the spans of one flush together (``flush=``, and ``trigger=`` on the
launch).

The profiler records host operators of the thread that started it only,
and the front end's flushes run on its worker thread.  The gate here reads
``torch.autograd.profiler._is_profiler_enabled``, a module global that
flips for every thread, where ``torch.autograd._profiler_enabled()`` is
thread-local.  With no profiler open a span site costs that one read and
records nothing.  Spans land in a bounded ring; :func:`snapshot` copies it.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Dict, Iterable, List, NamedTuple, Optional

from torch.autograd import profiler as _profiler

#: Spans kept: a 10-s window of ~100 flushes at ~25 spans each fits many times.
RING = 1 << 17

_ring: "collections.deque[Span]" = collections.deque(maxlen=RING)
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()


class Span(NamedTuple):
    name: str
    t0: float
    t1: float
    thread: int
    span_id: int
    parent: Optional[int]
    ids: Dict[str, object]

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


def _stack() -> List[int]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _append(span: Span) -> None:
    with _lock:
        _ring.append(span)


class _Open:
    """One span being recorded: pushed on its thread's stack on entry,
    stamped and put in the ring on exit."""

    __slots__ = ("name", "ids", "t0", "span_id", "parent")

    def __init__(self, name: str, ids: Dict[str, object]):
        self.name, self.ids = name, ids

    def __enter__(self) -> "_Open":
        stack = _stack()
        self.parent = stack[-1] if stack else None
        self.span_id = next(_ids)
        stack.append(self.span_id)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter()
        _stack().pop()
        _append(Span(self.name, self.t0, t1, threading.get_ident(), self.span_id,
                     self.parent, self.ids))


class _Off:
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> None:
        return None


_OFF = _Off()


def span(name: str, **ids):
    """``with span("fleet.embed", flush=3): ...`` records the block as one
    span while a profiler is open, and does nothing otherwise."""
    if not getattr(_profiler, "_is_profiler_enabled", False):
        return _OFF
    return _Open(name, ids)


def snapshot() -> List[Span]:
    """A copy of the ring, oldest first."""
    with _lock:
        return list(_ring)


def clear() -> None:
    with _lock:
        _ring.clear()


def self_time(spans: Iterable[Span], name: str) -> float:
    """Seconds of the spans called ``name`` that none of their children
    (among ``spans``) cover."""
    spans = list(spans)
    children: Dict[int, float] = collections.defaultdict(float)
    for s in spans:
        if s.parent is not None:
            children[s.parent] += s.seconds
    return sum(s.seconds - children.get(s.span_id, 0.0) for s in spans if s.name == name)
