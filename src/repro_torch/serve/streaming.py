"""Threaded continuous-batching streaming front-end with SLO scheduling.

Twin of the reference package's ``serve/streaming.py``, mesh arguments
included (``mesh=MeshSpec(...)`` and the deprecated bare device count
reach the owned fleet).  The synchronous :class:`~repro_torch.serve.fleet_frontend.FleetFrontend` only
dispatches when a caller drives it, so nothing overlaps request arrival
with device execution and nothing bounds tail latency.  Here a worker
thread owns a :class:`~repro_torch.runtime.fleet.PixieFleet` and
continuously batches arrivals (worker thread + bounded queues +
backpressure, adapted from token slots to overlay tiles).

Scheduling model:

* ``submit`` validates on the caller's thread, then enqueues into a
  BOUNDED arrival queue.  A full queue sheds the request with a typed
  :class:`~repro_torch.serve.service.AdmissionError` (admission control:
  reject loudly, never grow without bound).
* Requests carry an optional **deadline** (``deadline_s``, relative
  seconds -- the request's SLO) and a **priority** (higher is served
  first).  The worker drains arrivals into a pending set and launches one
  fleet flush when any of three triggers fires:

    full tile      pending >= target_batch (the fleet's batch tile)
    deadline       the most urgent pending deadline is within
                   est_flush_s + deadline_margin_s of expiring -- launch a
                   PARTIALLY-FILLED tile now rather than miss the SLO
                   waiting for a full one (``FleetStats.
                   partial_tile_dispatches`` counts these)
    linger         the oldest pending request has waited max_linger_s with
                   no new arrivals -- deadline-less traffic must not starve

  The flush-duration estimate is a per-(grid, frame-bucket) EWMA of
  observed flush wall times, seeded pessimistically; keying by the
  fleet's own canvas bucket means a big-frame tenant's slow flushes never
  inflate deadline urgency for small-frame traffic.
* The batch is chosen by (priority desc, arrival order) and capped at
  ``target_batch``; an urgent-deadline request preempts that order.  The
  remainder stays pending for the next trigger -- continuous batching,
  not drain-everything.
* Per-request ``queue_s`` / ``flush_s`` / ``total_s`` land in a
  :class:`~repro_torch.serve.service.LatencyStats` (p50/p95/p99 +
  deadline-miss counters) alongside the fleet's own ``FleetStats``.
* The worker is supervised: a crash fails only the in-flight handles
  (typed ``DispatchError``), accepted work survives, and the worker
  restarts up to ``max_worker_restarts`` times.

The worker thread issues every launch; the fleet runs each flush on its
own device and dispatch stream, set for the worker's thread.  Outputs are
bitwise identical to the synchronous front-end on the same request trace,
in both ingest modes: batch composition never changes values, only
latency.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Dict, List, Optional, Union

import numpy as np

import torch

from repro_torch.core import applications as app_lib
from repro_torch.core.dfg import DFG
from repro_torch.core.grid import GridSpec
from repro_torch.core.tiling import pow2_bucket
from repro_torch.parallel.axes import MeshSpec
from repro_torch.runtime.chaos import FaultInjector
from repro_torch.runtime.fleet import FleetRequest, PixieFleet
from repro_torch.runtime.spans import span
from repro_torch.serve.fleet_frontend import build_fleet, resolve_frontend_mesh
from repro_torch.serve.service import (
    AdmissionError, DispatchError, ImageJob, ImageService, JobHandle,
    JobTimeout, LatencyStats, resolve_app,
)

_STOP = object()   # arrival-queue sentinel: close() wakes the worker with it


@dataclasses.dataclass
class _PendingRequest:
    """One accepted request, between arrival queue and fleet dispatch."""

    seq: int                      # arrival order (FIFO tiebreak)
    name: str
    work: Union[str, DFG, List]   # a list means a pipeline chain of stages
    image: np.ndarray
    grid: Optional[GridSpec]
    priority: int
    t_arrival: float              # perf_counter at submit
    deadline_at: Optional[float]  # absolute perf_counter target, or None
    deadline_s: Optional[float]   # the relative SLO as submitted
    handle: JobHandle


class StreamingFrontend(ImageService):
    """Continuous-batching streaming server over a :class:`PixieFleet`.

    >>> with StreamingFrontend(device="cpu") as svc:
    ...     h = svc.submit("sobel_x", img, deadline_s=0.05, priority=1)
    ...     edge = h.result(timeout=5.0)

    The fleet is owned by the worker thread exclusively -- do not share a
    fleet instance between a streaming front-end and other callers.

    ``target_batch`` defaults to the fleet's ``batch_tile``; ``max_queue``
    bounds accepted-but-unserved requests (arrival queue + pending set)
    and is the admission-control knob; ``autostart=False`` leaves the
    worker stopped until :meth:`start` -- tests use it to stage
    deterministic contention.  Defaults to ``backend="hopper"`` on
    ``device="cuda"`` (which raises when no card is visible) and
    ``ingest="sync"``, like :class:`FleetFrontend`.
    """

    def __init__(
        self,
        fleet: Optional[PixieFleet] = None,
        registry: Optional[Dict[str, object]] = None,
        *,
        target_batch: Optional[int] = None,
        max_queue: int = 256,
        est_flush_s: float = 0.05,
        deadline_margin_s: float = 0.002,
        max_linger_s: float = 0.002,
        backend: Optional[str] = None,
        device: Union[str, torch.device, None] = None,
        mesh: Optional[MeshSpec] = None,
        ingest: Optional[str] = None,
        devices: Optional[int] = None,
        autostart: bool = True,
        faults: Optional[FaultInjector] = None,
        request_timeout_s: Optional[float] = None,
        max_worker_restarts: int = 8,
    ):
        mesh = resolve_frontend_mesh(mesh, devices, "StreamingFrontend")
        self.fleet = build_fleet(fleet, backend, device, ingest, mesh)
        if faults is not None:
            # One injector serves BOTH layers: the fleet's hook points
            # (compile/dispatch/nan_output/transfer_stall) and the
            # worker loop's "worker_death" -- a single seeded schedule.
            self.fleet.install_faults(faults)
        # Per-request hard timeout: a request that has waited this long
        # without being served fails its handle with JobTimeout (the
        # worker sweeps expiries every wakeup, so no client waits on work
        # the server has silently given up on).
        if request_timeout_s is not None and request_timeout_s <= 0:
            raise ValueError(
                f"request_timeout_s must be > 0, got {request_timeout_s}"
            )
        self.request_timeout_s = request_timeout_s
        self.max_worker_restarts = int(max_worker_restarts)
        self.registry = dict(registry) if registry is not None else dict(app_lib.ALL_APPS)
        self.target_batch = int(target_batch or self.fleet.batch_tile)
        if self.target_batch < 1:
            raise ValueError(f"target_batch must be >= 1, got {target_batch}")
        self.max_queue = int(max_queue)
        if self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.deadline_margin_s = float(deadline_margin_s)
        self.max_linger_s = float(max_linger_s)
        # Per-(grid, frame-bucket) EWMAs of observed flush wall times,
        # used by the deadline trigger to decide how late a launch can
        # start and still meet the SLO.  Keyed by the fleet's own pow-2
        # canvas bucket so big-frame tenants never inflate urgency for
        # small-frame traffic; populations the server has not flushed yet
        # fall back to the pessimistic seed (until real flushes are
        # observed the scheduler assumes they are slow and launches
        # early).
        self._est_flush_seed = float(est_flush_s)
        self._est_flush: Dict[tuple, float] = {}
        self.latency = LatencyStats()
        self._queue: "queue.Queue" = queue.Queue(maxsize=self.max_queue)
        self._seq = 0
        self._seq_lock = threading.Lock()
        self._flush_seq = 0
        self._closed = False
        # Lifecycle lock: close() flips _closed and submit() enqueues
        # under the SAME lock, so no submit can slip its request into the
        # queue after close() has begun draining (the race that could
        # strand a handle behind the _STOP sentinel).
        self._lifecycle = threading.Lock()
        self._worker: Optional[threading.Thread] = None
        # Worker state lives on the INSTANCE (not _run locals) so the
        # supervisor can restart a crashed worker without losing accepted
        # work: _pending_reqs survives the crash and is re-served, while
        # _inflight_reqs (mid-dispatch when the worker died) is failed
        # with a typed DispatchError -- no JobHandle ever hangs.
        self._pending_reqs: List[_PendingRequest] = []
        self._inflight_reqs: List[_PendingRequest] = []
        self._stopping = False
        self.worker_restarts = 0
        if autostart:
            self.start()

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "StreamingFrontend":
        """Start the worker thread (idempotent)."""
        if self._closed:
            raise RuntimeError("streaming front-end already closed")
        if self._worker is None:
            self._worker = threading.Thread(
                target=self._run_supervised,
                name="pixie-streaming-worker", daemon=True,
            )
            self._worker.start()
        return self

    def close(self, timeout: Optional[float] = 30.0) -> None:
        """Drain everything already accepted, then stop the worker.
        Safe to call twice; new submits after close are rejected."""
        with self._lifecycle:
            if self._closed:
                return
            self._closed = True
        if self._worker is None:
            # Never started: fail the accepted-but-unserved handles so no
            # client blocks forever on a server that will not run.
            self._drain_failed(RuntimeError("streaming front-end closed before start"))
            return
        self._queue.put(_STOP)   # blocking put: the sentinel must arrive
        self._worker.join(timeout)
        if self._worker.is_alive():
            raise RuntimeError(
                f"streaming worker did not drain within {timeout} s"
            )

    def __enter__(self) -> "StreamingFrontend":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    def _drain_failed(self, exc: BaseException) -> None:
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                return
            if item is not _STOP:
                item.handle._fail(exc)

    # -- client surface -----------------------------------------------------

    def available_apps(self) -> List[str]:
        return sorted(self.registry)

    def submit(
        self,
        app: Union[str, DFG],
        image: np.ndarray,
        grid: Optional[GridSpec] = None,
        *,
        deadline_s: Optional[float] = None,
        priority: int = 0,
        **kwargs,
    ) -> JobHandle:
        """Accept one frame for streaming service.

        ``deadline_s`` is the request's SLO in relative seconds: the
        scheduler will launch a partial tile rather than let it expire
        waiting for a full one, and :class:`LatencyStats` counts it as a
        miss if total latency still exceeds it.  ``priority`` breaks
        batching ties (higher is served first).  ``app`` may be a
        list/tuple of stages -- the chain runs as ONE device-resident
        pipeline dispatch (job named ``"a+b+c"``).  Raises
        :class:`AdmissionError` when the bounded queue is full.
        """
        if kwargs:
            raise TypeError(f"unsupported submit options {sorted(kwargs)}")
        if self._closed:
            raise RuntimeError("streaming front-end is closed")
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        # Cheap validation on the CALLER's thread (unknown app, bad shape)
        # so obviously-bad requests fail to their submitter immediately;
        # mapping/grid validation happens on the worker and fails the
        # handle instead.
        if isinstance(app, (list, tuple)):
            resolved = [resolve_app(self.registry, a) for a in app]
            name = "+".join(n for n, _ in resolved)
            work: Union[str, DFG, List] = [w for _, w in resolved]
        else:
            name, work = resolve_app(self.registry, app)
        image = np.asarray(image)
        if image.ndim != 2:
            raise ValueError(f"image must be [H, W], got shape {image.shape}")
        t_arrival = time.perf_counter()
        with self._seq_lock:
            seq = self._seq
            self._seq += 1
        handle = JobHandle(seq, name)
        pending = _PendingRequest(
            seq=seq, name=name, work=work, image=image, grid=grid,
            priority=int(priority), t_arrival=t_arrival,
            deadline_at=None if deadline_s is None else t_arrival + deadline_s,
            deadline_s=deadline_s, handle=handle,
        )
        # Enqueue ATOMICALLY with the closed check: close() flips _closed
        # under the same lock before it inserts the _STOP sentinel, so an
        # accepted request always precedes the sentinel in the FIFO and is
        # drained -- a submit racing close can no longer strand its handle
        # behind a queue the worker has already finished.
        with self._lifecycle:
            if self._closed:
                raise RuntimeError("streaming front-end is closed")
            try:
                self._queue.put_nowait(pending)
            except queue.Full:
                self.latency.record_shed()
                raise AdmissionError(queued=self._queue.qsize(),
                                     bound=self.max_queue) from None
        return handle

    @property
    def backend(self) -> str:
        return self.fleet.backend

    @property
    def device(self) -> torch.device:
        return self.fleet.device

    @property
    def mesh(self) -> MeshSpec:
        return self.fleet.mesh

    @property
    def devices(self) -> int:
        return self.fleet.devices

    @property
    def ingest(self) -> str:
        return self.fleet.ingest

    @property
    def stats(self):
        """The owned fleet's :class:`FleetStats` (read-only use; the
        worker thread is the writer)."""
        return self.fleet.stats

    @property
    def est_flush_s(self) -> float:
        """Most pessimistic current flush-duration estimate across the
        (grid, frame-bucket) populations the server has flushed (the
        seed before any flush) -- the scalar the serving bench records;
        the deadline trigger itself plans with each request's own
        population estimate (:meth:`_estimate`)."""
        return max(self._est_flush.values(), default=self._est_flush_seed)

    def _flush_key(self, p: _PendingRequest) -> tuple:
        """The EWMA population of one request: its grid and the padded
        canvas bucket its frame lands in -- the SAME pow-2 bucketing the
        fleet's dispatch uses, so requests that share a compiled
        executable shape (and therefore a flush-duration profile) share
        an estimate."""
        grid = p.grid or self.fleet.default_grid
        H, W = p.image.shape
        return (
            grid,
            pow2_bucket(H, self.fleet.min_image_side),
            pow2_bucket(W, self.fleet.min_image_side),
        )

    def _estimate(self, p: _PendingRequest) -> float:
        """Flush-duration estimate for one request's population."""
        return self._est_flush.get(self._flush_key(p), self._est_flush_seed)

    # -- worker -------------------------------------------------------------

    def _run_supervised(self) -> None:
        """The worker's supervisor: :meth:`_run` is the mortal body.  Any
        crash -- a fleet bug, an injected ``worker_death``, even a
        BaseException -- lands here; in-flight jobs are reconciled (failed
        with a typed DispatchError, never stranded), accepted-but-unflushed
        work survives in ``_pending_reqs``, and the loop restarts.  A
        worker that cannot stay alive (``max_worker_restarts`` exceeded)
        surrenders: the front-end closes and every queued handle fails."""
        while True:
            try:
                self._run()
                return
            except BaseException as exc:  # noqa: BLE001 -- routed: in-flight handles fail typed, queued work re-serves after restart
                if not self._reconcile_crash(exc):
                    return

    def _reconcile_crash(self, exc: BaseException) -> bool:
        """Crash bookkeeping; returns False when the supervisor gives up."""
        self.worker_restarts += 1
        lost, self._inflight_reqs = self._inflight_reqs, []
        for p in lost:
            if not p.handle.done():
                self.latency.record_failure()
                p.handle._fail(DispatchError(
                    f"request {p.name!r} (seq {p.seq}) was in flight when "
                    f"the streaming worker crashed ({exc!r}); resubmit"
                ))
        # Their fleet submissions (if any) died with the dispatch: drop
        # them so a restarted worker never re-serves failed tickets.
        self.fleet.cancel_pending()
        if self.worker_restarts <= self.max_worker_restarts:
            return True
        err = DispatchError(
            f"streaming worker died {self.worker_restarts} times "
            f"(max_worker_restarts={self.max_worker_restarts}); "
            f"front-end closed: {exc!r}"
        )
        with self._lifecycle:
            self._closed = True
        for p in self._pending_reqs:
            if not p.handle.done():
                self.latency.record_failure()
                p.handle._fail(err)
        self._pending_reqs = []
        self._drain_failed(err)
        return False

    def _run(self) -> None:
        pending = self._pending_reqs
        while True:
            faults = self.fleet.faults
            if faults is not None:
                # The worker-death hook: fires between dispatches (never
                # mid-flight), so an injected kill exercises the restart
                # path without fabricating lost work.
                faults.fire("worker_death")
            # 1. Pull arrivals: block only as long as the launch triggers
            # allow (deadline slack / linger / hard timeout), then drain
            # without blocking.
            timeout = self._wake_in(pending)
            with span("frontend.wait"):
                try:
                    item = self._queue.get(timeout=timeout)
                    if item is _STOP:
                        self._stopping = True
                    else:
                        pending.append(item)
                    while True:   # opportunistically drain the burst
                        item = self._queue.get_nowait()
                        if item is _STOP:
                            self._stopping = True
                        else:
                            pending.append(item)
                except queue.Empty:
                    pass

            # 2. Launch decision.
            now = time.perf_counter()
            self._expire_timeouts(pending, now)
            trigger = self._trigger(pending, now) if pending else None
            if trigger is not None:
                batch = self._select_batch(pending)
                self._inflight_reqs = batch
                self._dispatch(batch, trigger)
                self._inflight_reqs = []
            if self._stopping and not pending and self._queue.empty():
                return

    def _trigger(self, pending: List[_PendingRequest], now: float) -> Optional[str]:
        """The launch trigger that fires first, in order -- ``drain`` (the
        front end is closing), ``full_tile``, ``deadline``, ``linger`` --
        or None; the flush's span carries it as ``trigger=``."""
        if self._stopping:
            return "drain"
        if len(pending) >= self.target_batch:
            return "full_tile"
        if self._deadline_urgent(pending, now):
            return "deadline"
        if self._lingered(pending, now):
            return "linger"
        return None

    def _expire_timeouts(self, pending: List[_PendingRequest],
                         now: float) -> None:
        """Sweep the per-request hard timeout: expired requests fail
        their own handle with :class:`JobTimeout` and leave the queue."""
        if self.request_timeout_s is None:
            return
        expired = [p for p in pending
                   if now - p.t_arrival > self.request_timeout_s]
        for p in expired:
            pending.remove(p)
            self.latency.record_failure()
            p.handle._fail(JobTimeout(
                f"request {p.name!r} (seq {p.seq}) exceeded the "
                f"per-request hard timeout ({self.request_timeout_s} s) "
                f"while queued"
            ))

    def _wake_in(self, pending: List[_PendingRequest]) -> float:
        """How long the worker may block on the arrival queue before a
        trigger needs re-evaluation."""
        if not pending:
            return 0.1   # idle: wake periodically (sentinel wakes us too)
        now = time.perf_counter()
        horizon = min(
            (p.t_arrival + self.max_linger_s for p in pending),
            default=now,
        ) - now
        slack = min(
            (p.deadline_at - self._estimate(p) - self.deadline_margin_s
             for p in pending if p.deadline_at is not None),
            default=float("inf"),
        ) - now
        return float(min(max(min(horizon, slack), 1e-4), 0.05))

    def _deadline_urgent(self, pending: List[_PendingRequest], now: float) -> bool:
        """Would waiting any longer risk the most urgent pending SLO?
        (The partial-tile trigger: launch when the estimated flush no
        longer fits inside the tightest remaining deadline budget.)
        Each request is judged against ITS population's estimate: a 32^2
        request next to 256^2 traffic keeps its own cheap budget."""
        return any(
            p.deadline_at is not None
            and p.deadline_at - now
            <= self._estimate(p) + self.deadline_margin_s
            for p in pending
        )

    def _lingered(self, pending: List[_PendingRequest], now: float) -> bool:
        return (
            self._queue.empty()
            and now - min(p.t_arrival for p in pending) >= self.max_linger_s
        )

    def _select_batch(self, pending: List[_PendingRequest]) -> List[_PendingRequest]:
        """Pop up to ``target_batch`` requests; the rest stay pending --
        continuous batching, not drain-all.

        Staged order is (priority desc, arrival), but an URGENT request --
        one whose remaining deadline budget no longer covers its
        population's estimated flush -- preempts the staged set
        mid-selection: urgency outranks priority, so a low-priority
        request about to blow its SLO jumps a staged batch of
        high-priority deadline-less work.  Each preemption that actually
        changes the launched composition is counted in
        ``FleetStats.preempted_batches`` (the contention test asserts
        it)."""
        now = time.perf_counter()
        staged = sorted(pending, key=lambda p: (-p.priority, p.seq))

        def urgent(p: _PendingRequest) -> bool:
            return (
                p.deadline_at is not None
                and p.deadline_at - now
                <= self._estimate(p) + self.deadline_margin_s
            )

        pending.sort(key=lambda p: (not urgent(p), -p.priority, p.seq))
        batch = pending[: self.target_batch]
        del pending[: self.target_batch]
        if {p.seq for p in batch} != {p.seq for p in staged[: self.target_batch]}:
            self.fleet.stats.preempted_batches += 1
        return batch

    def _dispatch(self, batch: List[_PendingRequest], trigger: str) -> None:
        """One fleet flush for the selected batch.  Per-request fleet
        submit failures (unmappable app, grid mismatch) fail only their
        own handle -- they can never poison the rest of the batch."""
        seq = self._flush_seq
        tickets: Dict[int, _PendingRequest] = {}
        with span("frontend.admit", flush=seq):
            for p in batch:
                try:
                    if isinstance(p.work, list):
                        req = FleetRequest(pipeline=p.work, image=p.image,
                                           grid=p.grid)
                    else:
                        req = FleetRequest(app=p.work, image=p.image, grid=p.grid)
                    t = self.fleet.submit(req)
                except Exception as exc:    # noqa: BLE001 -- handed to the handle
                    p.handle._fail(exc)
                    continue
                tickets[t] = p
        if not tickets:
            return
        self._flush_seq += 1
        try:
            with span("frontend.flush", flush=seq, trigger=trigger):
                outs = self.fleet.flush()
        except Exception as exc:        # noqa: BLE001 -- handed to the handles
            for p in tickets.values():
                p.handle._fail(exc)
            return
        with span("frontend.deliver", flush=seq):
            self._deliver(tickets, outs, seq)

    def _deliver(self, tickets: Dict[int, _PendingRequest], outs: Dict[int, object],
                 seq: int) -> None:
        """Hand each request of flush ``seq`` its output, or its own
        failure, and feed the flush's wall time to the EWMAs."""
        flush_started = self.fleet.timings.get("flush_started", time.perf_counter())
        flush_s = self.fleet.timings.get("flush_s", 0.0)
        # EWMA update, per population present in this flush: the deadline
        # trigger plans with recent reality for the shapes it just served
        # (a mixed flush credits its wall time to every population in it
        # -- pessimistic for the small ones, and exactly why homogeneous
        # batches keep their own key).
        for key in {self._flush_key(p) for p in tickets.values()}:
            self._est_flush[key] = (
                0.7 * self._est_flush.get(key, self._est_flush_seed)
                + 0.3 * flush_s
            )
        t_done = time.perf_counter()
        failures = self.fleet.pop_failures()
        for ticket, p in tickets.items():
            if ticket not in outs:
                # Quarantined (or otherwise lost) by the resilient flush:
                # fail exactly this handle, typed; batchmates are served.
                exc = failures.get(ticket) or DispatchError(
                    f"ticket {ticket} ({p.name!r}) was not served by its "
                    f"flush and recorded no failure"
                )
                self.latency.record_failure()
                p.handle._fail(exc)
                continue
            self.fleet.discard(ticket)
            queue_s = max(0.0, flush_started - p.t_arrival)
            total_s = t_done - p.t_arrival
            missed = p.deadline_s is not None and total_s > p.deadline_s
            job = ImageJob(
                ticket=p.seq, app=p.name, output=outs[ticket],
                queue_s=queue_s, flush_s=flush_s, latency_s=total_s,
                priority=p.priority, deadline_s=p.deadline_s,
                deadline_missed=missed, flush_seq=seq,
            )
            self.latency.record(queue_s, flush_s, total_s,
                                deadline_s=p.deadline_s)
            p.handle._complete(job)
