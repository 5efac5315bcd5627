"""The futures-based service surface shared by every Pixie image front-end.

Twin of the reference package's ``serve/service.py``.  ``submit(...)``
returns a :class:`JobHandle` the caller polls (``done()``) or blocks on
(``result(timeout=...)``); every front-end implements the same surface
(:class:`ImageService`), so a client written against handles is
indifferent to what drives the dispatch.

This module also owns the serving telemetry: :class:`LatencyStats` keeps
windowed per-request ``queue_s`` / ``flush_s`` / ``total_s`` samples
(p50/p95/p99) plus cumulative deadline-miss and shed counters, riding
alongside the fleet's :class:`~repro_torch.runtime.fleet.FleetStats`; and the
typed exception hierarchy every serving failure derives from:

    ServiceError                the base clients catch wholesale
    +-- AdmissionError          shed before a ticket existed (backpressure)
    +-- DispatchError           admitted, then lost/failed after submit
    |   +-- QuarantinedError    isolated by bisection quarantine
    |                           (carries .ticket / .app / .cause)
    +-- JobTimeout              result(timeout=) or per-request hard
                                timeout expired (also a TimeoutError)

``DispatchError``/``QuarantinedError``/``JobTimeout`` are *defined* in
:mod:`repro_torch.runtime.resilience` (the runtime layer raises them;
serve imports runtime, never the reverse) and re-exported here as the
public serving surface.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core import applications as app_lib
from repro_torch.core.dfg import DFG
from repro_torch.core.grid import GridSpec
from repro_torch.runtime.resilience import (  # noqa: F401  (re-exported surface)
    DispatchError, JobTimeout, QuarantinedError, ServiceError,
)


class AdmissionError(ServiceError):
    """A request was shed by admission control: the service's bounded
    arrival queue was full.  Typed (rather than a bare queue.Full or --
    worse -- unbounded growth) so clients can distinguish overload
    shedding from bad requests and apply their own retry/backoff."""

    def __init__(self, queued: int, bound: int):
        self.queued = queued
        self.bound = bound
        super().__init__(
            f"request shed by admission control: {queued} requests already "
            f"queued (max_queue={bound}); retry with backoff or raise the "
            f"bound"
        )


@dataclasses.dataclass
class ImageJob:
    """The completed record of one served frame.

    ``queue_s`` is the wait from submit until its flush *started*;
    ``flush_s`` is the wall duration of the flush that served it (shared
    by every job in that flush); ``latency_s`` is the end-to-end total.
    The old single ``latency_s``-stamped-after-flush conflated the two --
    every job in a batch inherited the full flush time inside its queue
    wait -- so schedulers could not tell queueing delay from execution.
    """

    ticket: int
    app: str
    output: np.ndarray
    queue_s: float
    flush_s: float
    latency_s: float
    priority: int = 0
    deadline_s: Optional[float] = None   # relative SLO the submitter asked for
    deadline_missed: bool = False
    flush_seq: int = 0                   # which service flush served it


class JobHandle:
    """Future for one submitted frame: the one-call replacement for the
    ``tick``/``take`` protocol.

    ``done()`` is a non-blocking poll; ``result(timeout=...)`` blocks until
    the frame is served (raising ``TimeoutError`` on expiry) and returns
    the output array; ``job(timeout=...)`` returns the full
    :class:`ImageJob` record including the latency split.  A synchronous
    front-end wires ``kick`` to its own flush so ``result()`` on an
    undispatched handle drives the dispatch itself; the streaming
    front-end leaves it unset and lets the worker thread resolve handles.
    """

    def __init__(self, ticket: int, app: str, *, kick=None):
        self.ticket = ticket
        self.app = app
        self._event = threading.Event()
        self._job: Optional[ImageJob] = None
        self._exc: Optional[BaseException] = None
        self._kick = kick

    def done(self) -> bool:
        """Has the frame been served (or the request failed)?"""
        return self._event.is_set()

    def job(self, timeout: Optional[float] = None) -> ImageJob:
        """The full :class:`ImageJob` record (blocks like :meth:`result`)."""
        if not self._event.is_set() and self._kick is not None:
            self._kick()
        if not self._event.wait(timeout):
            raise JobTimeout(
                f"ticket {self.ticket} ({self.app!r}) not served within "
                f"{timeout} s"
            )
        if self._exc is not None:
            raise self._exc
        return self._job

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """The output frame; blocks until served.  ``timeout=None`` waits
        forever, a float raises :class:`JobTimeout` (a ``TimeoutError``
        subclass) on expiry."""
        return self.job(timeout).output

    # -- resolution (called by the owning front-end) ------------------------
    # First resolution wins: the streaming supervisor may race a crash
    # reconciliation against a dispatch that already completed the handle,
    # and a late _fail must never overwrite a delivered result.

    def _complete(self, job: ImageJob) -> None:
        if self._event.is_set():
            return
        self._job = job
        self._event.set()

    def _fail(self, exc: BaseException) -> None:
        if self._event.is_set():
            return
        self._exc = exc
        self._event.set()

    def __repr__(self) -> str:
        state = "done" if self.done() else "pending"
        return f"JobHandle(ticket={self.ticket}, app={self.app!r}, {state})"


def _percentiles(samples: Sequence[float]) -> Dict[str, float]:
    if not samples:
        return {"p50": 0.0, "p95": 0.0, "p99": 0.0, "mean": 0.0, "max": 0.0}
    arr = np.asarray(samples, dtype=np.float64)
    p50, p95, p99 = np.percentile(arr, [50.0, 95.0, 99.0])
    return {
        "p50": float(p50), "p95": float(p95), "p99": float(p99),
        "mean": float(arr.mean()), "max": float(arr.max()),
    }


class LatencyStats:
    """Windowed per-request latency percentiles + SLO accounting.

    Per-request samples are split three ways (see :class:`ImageJob`):
    ``queue_s`` (submit -> flush start), ``flush_s`` (flush duration) and
    ``total_s`` (submit -> served).  Samples live in bounded deques (a
    long-running server must not grow without bound) while the SLO
    counters -- ``completed``, ``deadline_misses``, ``with_deadline``,
    ``shed`` -- are cumulative.  Thread-safe: the streaming worker records
    while clients read summaries.
    """

    def __init__(self, window: int = 65536):
        self._lock = threading.Lock()
        self.window = int(window)
        self._queue_s: deque = deque(maxlen=self.window)
        self._flush_s: deque = deque(maxlen=self.window)
        self._total_s: deque = deque(maxlen=self.window)
        self.completed = 0
        self.with_deadline = 0
        self.deadline_misses = 0
        self.shed = 0
        self.failed = 0

    def record(self, queue_s: float, flush_s: float, total_s: float,
               deadline_s: Optional[float] = None) -> None:
        with self._lock:
            self._queue_s.append(queue_s)
            self._flush_s.append(flush_s)
            self._total_s.append(total_s)
            self.completed += 1
            if deadline_s is not None:
                self.with_deadline += 1
                if total_s > deadline_s:
                    self.deadline_misses += 1

    def record_shed(self) -> None:
        with self._lock:
            self.shed += 1

    def record_failure(self) -> None:
        """One admitted request that failed post-submit (quarantined,
        lost to a crash, or hard-timed-out) -- the availability
        denominator the chaos bench reports against."""
        with self._lock:
            self.failed += 1

    def reset(self) -> None:
        """Clear samples AND counters (benches call this after warmup so
        compile-time flushes don't pollute the measured percentiles)."""
        with self._lock:
            self._queue_s.clear()
            self._flush_s.clear()
            self._total_s.clear()
            self.completed = 0
            self.with_deadline = 0
            self.deadline_misses = 0
            self.shed = 0
            self.failed = 0

    def summary(self) -> Dict[str, Any]:
        """p50/p95/p99/mean/max per latency component + the SLO counters
        (the serving bench writes this dict into BENCH_serving.json)."""
        with self._lock:
            return {
                "completed": self.completed,
                "failed": self.failed,
                "shed": self.shed,
                "with_deadline": self.with_deadline,
                "deadline_misses": self.deadline_misses,
                "queue_s": _percentiles(self._queue_s),
                "flush_s": _percentiles(self._flush_s),
                "total_s": _percentiles(self._total_s),
            }


def resolve_app(registry: Dict[str, Any], app: Union[str, DFG]):
    """Resolve a submitted app spec against a front-end registry into
    ``(name, work)`` where ``work`` is what the fleet receives.

    Library-default entries pass the NAME through so the fleet's
    (name, grid) config cache applies -- no per-request DFG rebuild +
    structural hash (~0.1 ms/request on the serving hot path).  Custom
    registry factories still build: the fleet only knows the library by
    name.  Shared by the synchronous and streaming front-ends so both
    validate unknown apps on the *submitter's* thread.
    """
    if isinstance(app, str):
        if app not in registry:
            raise KeyError(
                f"unknown app {app!r}; known: {sorted(registry)}"
            )
        factory = registry[app]
        work = app if factory is app_lib.ALL_APPS.get(app) else factory()
        return app, work
    return app.name, app


class ImageService:
    """The one service API both front-ends implement: futures all the way.

    Subclasses provide ``submit(app, image, grid=None, ...)`` returning a
    :class:`JobHandle`; ``process`` / ``process_batch`` are rebuilt on
    handles here, so they behave identically whether a worker thread
    (streaming) or the first ``result()`` call (synchronous) drives the
    dispatch.
    """

    def submit(self, app: Union[str, DFG], image: np.ndarray,
               grid: Optional[GridSpec] = None, **kwargs) -> JobHandle:
        raise NotImplementedError

    def process(self, app: Union[str, DFG], image: np.ndarray,
                **kwargs) -> np.ndarray:
        """Synchronous single-frame convenience (still goes through the
        batched path, so repeat calls reuse the compiled overlay)."""
        return self.submit(app, image, **kwargs).result()

    def process_batch(
        self, requests: Sequence[Tuple[Union[str, DFG], np.ndarray]],
        **kwargs,
    ) -> List[np.ndarray]:
        """Many (app, image) pairs; outputs in request order.  On the
        synchronous front-end the first ``result()`` drains the whole
        queue in one dispatch; on the streaming front-end the scheduler
        batches them behind the scenes."""
        handles = [self.submit(app, image, **kwargs) for app, image in requests]
        return [h.result() for h in handles]
