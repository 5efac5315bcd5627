"""Synchronous serving front-end for the Pixie fleet.

Twin of the reference package's ``serve/fleet_frontend.py``: clients ask
for *named image operations* ("sobel_x on this frame"), the front-end
queues them, and each flush drains the queue through
:class:`repro_torch.runtime.fleet.PixieFleet` -- one batched overlay
dispatch per grid group, whatever mix of applications is in flight.
Frames ride the fused-ingest path end to end; a list of stages runs as one
device-resident chain.

``submit`` returns a :class:`~repro_torch.serve.service.JobHandle`, and
``result()`` on an undispatched handle drives the flush itself; there is
no worker thread here.  For a server that overlaps arrival with dispatch
and schedules against deadlines, use
:class:`repro_torch.serve.streaming.StreamingFrontend`, which implements
the same API on the same fleet.
"""

from __future__ import annotations

import time
import warnings
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import applications as app_lib
from repro_torch.core.dfg import DFG
from repro_torch.core.grid import GridSpec
from repro_torch.core.ingest import check_ingest
from repro_torch.core.interpreter import check_backend
from repro_torch.parallel.axes import MeshSpec
from repro_torch.runtime.fleet import FleetRequest, PixieFleet
from repro_torch.serve.service import (
    ImageJob, ImageService, JobHandle, LatencyStats, resolve_app,
)


def resolve_frontend_mesh(
    mesh: Optional[MeshSpec], devices: Optional[int], owner: str,
) -> Optional[MeshSpec]:
    """The front-ends' deprecation shim for the bare device-count kwarg:
    folds it into ``mesh=MeshSpec(app=k)`` with a warning, and refuses
    both spellings at once."""
    if devices is None:
        return mesh
    d = int(devices)
    if d < 1:
        raise ValueError(f"devices must be >= 1, got {devices}")
    if mesh is not None:
        raise ValueError(
            "pass mesh=MeshSpec(...) or the deprecated bare device count, "
            "not both"
        )
    warnings.warn(
        f"the bare device-count kwarg of {owner} is deprecated: pass "
        f"mesh=MeshSpec(app={d}) instead",
        DeprecationWarning, stacklevel=3,
    )
    return MeshSpec(app=d)


def build_fleet(
    fleet: Optional[PixieFleet],
    backend: Optional[str],
    device: Union[str, torch.device, None],
    ingest: Optional[str] = None,
    mesh: Optional[MeshSpec] = None,
) -> PixieFleet:
    """Resolve a front-end's fleet: pass-through with axis-conflict checks
    when one is provided, else a fresh fleet on the requested axes
    (defaults: ``backend="hopper"``, ``device="cuda"``, ``ingest="sync"``,
    ``MeshSpec()``).  Shared by the synchronous and streaming front-ends."""
    if backend is not None:
        check_backend(backend)
        if fleet is not None and fleet.backend != backend:
            raise ValueError(
                f"backend={backend!r} conflicts with the provided fleet's "
                f"backend {fleet.backend!r}; configure the PixieFleet instead"
            )
    if device is not None and fleet is not None and fleet.device != torch.device(device):
        raise ValueError(
            f"device={device!r} conflicts with the provided fleet's device "
            f"{str(fleet.device)!r}; configure the PixieFleet instead"
        )
    if mesh is not None and fleet is not None and fleet.mesh != mesh:
        raise ValueError(
            f"mesh={mesh} conflicts with the provided fleet's "
            f"mesh {fleet.mesh}; configure the PixieFleet instead"
        )
    if ingest is not None:
        check_ingest(ingest)
        if fleet is not None and fleet.ingest != ingest:
            raise ValueError(
                f"ingest={ingest!r} conflicts with the provided fleet's "
                f"ingest {fleet.ingest!r}; configure the PixieFleet instead"
            )
    return fleet or PixieFleet(backend=backend or "hopper", device=device or "cuda",
                               mesh=mesh, ingest=ingest or "sync")


class FleetFrontend(ImageService):
    """Queue + drain service loop over a :class:`PixieFleet`.

    >>> svc = FleetFrontend(device="cpu")
    >>> h = svc.submit("sobel_x", img)     # a JobHandle
    >>> edge = h.result()                  # drains the queue in one dispatch

    Defaults to ``backend="hopper"`` (the hand-written kernels) on
    ``device="cuda"``, which raises when no card is visible.  The
    reference's front-end defaults to its eager ``"xla"`` backend instead.
    """

    def __init__(
        self,
        fleet: Optional[PixieFleet] = None,
        registry: Optional[Dict[str, object]] = None,
        max_done: int = 1024,
        backend: Optional[str] = None,
        device: Union[str, torch.device, None] = None,
        ingest: Optional[str] = None,
        mesh: Optional[MeshSpec] = None,
        devices: Optional[int] = None,
    ):
        mesh = resolve_frontend_mesh(mesh, devices, "FleetFrontend")
        self.fleet = build_fleet(fleet, backend, device, ingest, mesh)
        # Name -> DFG factory; defaults to the paper's application library.
        self.registry = dict(registry) if registry is not None else dict(app_lib.ALL_APPS)
        self._arrivals: Dict[int, Tuple[str, float]] = {}
        self._handles: Dict[int, JobHandle] = {}
        # Bounded record of completed jobs (handles keep their own).
        self._done: "OrderedDict[int, ImageJob]" = OrderedDict()
        self.max_done = int(max_done)
        self.latency = LatencyStats()
        self._flush_seq = 0

    def available_apps(self) -> List[str]:
        return sorted(self.registry)

    def submit(
        self,
        app: Union[str, DFG, Sequence[Union[str, DFG]]],
        image: np.ndarray,
        grid: Optional[GridSpec] = None,
        **kwargs,
    ) -> JobHandle:
        """Enqueue one frame; returns a :class:`JobHandle` whose
        ``result()`` drives the flush if it has not happened yet.

        ``app`` may be a list or tuple of stages: the chain runs as ONE
        device-resident pipeline dispatch (stage i's output feeds stage
        i+1's taps) and the job is named ``"a+b+c"``."""
        if kwargs:
            raise TypeError(
                f"unsupported submit options {sorted(kwargs)}; deadline_s/"
                f"priority scheduling needs the streaming front-end "
                f"(repro_torch.serve.StreamingFrontend)"
            )
        if isinstance(app, (list, tuple)):
            resolved = [resolve_app(self.registry, a) for a in app]
            name = "+".join(n for n, _ in resolved)
            ticket = self.fleet.submit(FleetRequest(
                pipeline=[w for _, w in resolved], image=image, grid=grid))
        else:
            name, work = resolve_app(self.registry, app)
            ticket = self.fleet.submit(FleetRequest(app=work, image=image, grid=grid))
        handle = JobHandle(ticket, name, kick=self.flush)
        self._arrivals[ticket] = (name, time.perf_counter())
        self._handles[ticket] = handle
        return handle

    def flush(self) -> List[ImageJob]:
        """Drain the queue: one batched dispatch per grid group.  Resolves
        every pending handle and records the queue/flush latency split.
        Tickets quarantined by the fleet's resilient flush fail their own
        handle with the stored :class:`QuarantinedError`; batchmates are
        served normally."""
        outs = self.fleet.flush()
        for ticket, exc in self.fleet.pop_failures().items():
            self._arrivals.pop(ticket, None)
            self.latency.record_failure()
            handle = self._handles.pop(ticket, None)
            if handle is not None:
                handle._fail(exc)
        flush_started = self.fleet.timings.get("flush_started", time.perf_counter())
        flush_s = self.fleet.timings.get("flush_s", 0.0)
        seq = self._flush_seq
        self._flush_seq += 1
        jobs = []
        for ticket, output in outs.items():
            self.fleet.discard(ticket)  # the job owns the output now
            name, t_arrival = self._arrivals.pop(ticket)
            queue_s = max(0.0, flush_started - t_arrival)
            job = ImageJob(
                ticket, name, output,
                queue_s=queue_s, flush_s=flush_s,
                latency_s=queue_s + flush_s, flush_seq=seq,
            )
            self.latency.record(queue_s, flush_s, job.latency_s)
            self._done[ticket] = job
            handle = self._handles.pop(ticket, None)
            if handle is not None:
                handle._complete(job)
            jobs.append(job)
        while len(self._done) > self.max_done:
            self._done.popitem(last=False)
        return jobs

    # -- deprecated three-call protocol ------------------------------------

    def tick(self) -> List[ImageJob]:
        """Deprecated alias of :meth:`flush` (the old queue/tick/take
        protocol)."""
        warnings.warn(
            "FleetFrontend tick() is deprecated: hold the JobHandle from "
            "submit() and call result() on it, or call flush() to drain "
            "explicitly",
            DeprecationWarning,
            stacklevel=2,
        )
        return self.flush()

    def take(self, ticket: Union[int, JobHandle]) -> np.ndarray:
        """Deprecated ticket redemption (the old queue/tick/take protocol);
        accepts a bare ticket or a handle."""
        warnings.warn(
            "FleetFrontend take() is deprecated: call result() on the "
            "JobHandle returned by submit()",
            DeprecationWarning,
            stacklevel=2,
        )
        if isinstance(ticket, JobHandle):
            ticket = ticket.ticket
        return self._done.pop(ticket).output

    @property
    def backend(self) -> str:
        """Execution backend of the underlying fleet ("torch" or "hopper")."""
        return self.fleet.backend

    @property
    def device(self) -> torch.device:
        return self.fleet.device

    @property
    def mesh(self) -> MeshSpec:
        return self.fleet.mesh

    @property
    def devices(self) -> int:
        """App-axis mesh width of the underlying fleet's dispatch plans."""
        return self.fleet.devices

    @property
    def ingest(self) -> str:
        """Ingest mode of the underlying fleet ("sync" or "async"; async
        jobs carry :class:`~repro_torch.runtime.fleet.LazyOutput`s)."""
        return self.fleet.ingest

    @property
    def stats(self):
        return self.fleet.stats

    @property
    def timings(self):
        """Fleet timings: cumulative host ``pack_s`` plus the last
        ``flush_s`` / ``flush_started``."""
        return self.fleet.timings
