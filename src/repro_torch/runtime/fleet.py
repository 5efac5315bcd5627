"""Pixie fleet: a multi-tenant batched scheduler for VCGRA overlays.

Twin of the reference package's ``runtime/fleet.py``.  Every application
mapped on a grid yields identically-shaped settings, so N *different*
tenants stack (``VCGRAConfig.stack``) into one dispatch of a batched
:class:`~repro_torch.core.plan.OverlayPlan`.  With a
:class:`~repro_torch.parallel.axes.MeshSpec` the plan also shards every
dispatch over local devices: ``MeshSpec(app=k)`` splits the app axis k
ways, ``MeshSpec(app=k, rows=m)`` also row-bands fused frames with a seam
halo exchange (both bitwise the single-device run).  A host with fewer
devices degrades to one device, and ``FleetStats`` says so.

Scheduling model (the reference's, rule for rule):

* requests name an application (a :class:`DFG`, a mapped config or a
  library app name) plus named channels or a whole image, or a chain of
  applications (``pipeline=``) on an image;
* requests are grouped by :class:`GridSpec`; image requests with an ingest
  plan take the **fused** path (the raw frame is embedded into a zero
  canvas and line-buffer formation happens inside the dispatch),
  named-channel requests and image apps without an ingest plan share the
  flush through the pre-packed channel path; chains group by
  ``(grid, "pipe", radii)`` and each group runs as ONE pipeline dispatch
  whose intermediates never leave the device;
* each group is padded to fixed tiles -- the app axis to ``batch_tile``
  (padded slots replay ``configs[0]`` on zero inputs), the canvas sides
  and flat pixel batches to power-of-two buckets -- and outputs are sliced
  back, so results are bitwise identical to unbatched runs;
* mapped configs are cached by DFG structural hash (and library name),
  executables per plan, stacked settings banks per tenant set;
* with ``ingest="async"`` the pipeline double-buffers: frames fill one of
  two pinned host canvases per shape and are copied to the card on a side
  stream, each dispatch's outputs come back in ONE copy into one of two
  pinned output buffers per size and are read lazily (:class:`LazyOutput`,
  copied out of the buffer at the first read), so packing of flush k+1
  overlaps the device work of flush k (``FleetStats.ingest_overlap_s``).

Dispatch is self-healing, rule for rule the reference's ladder for the
faults it routes: transient failures retry with a deterministic backoff, a
failing plan degrades down :func:`~repro_torch.core.plan.fallback_chain`
(``hopper`` -> ``torch``, 2-D mesh -> app-only -> one device, tiled ->
untiled) behind per-plan circuit
breakers, float outputs pass a NaN/Inf guard, and a request no plan can
serve is isolated by bisection and fails only its own ticket
(:class:`QuarantinedError`).  The ladder routes the faults of the chaos
hook points (:class:`InjectedFault`) and poisoned outputs; any other error
of a dispatch -- a kernel that fails to build, load or launch -- raises out
of :meth:`PixieFleet.flush` and is never served around.  A grid wider than
the Hopper kernels hold is refused at submit, to its own submitter.

Banks and canvases live on the fleet's ``device`` (default ``"cuda"``,
which raises when no card is visible); a mesh's shards copy the settings
they need to their own devices once per bank (``parallel.axes.replica``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
import warnings
import weakref
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import applications as app_lib
from repro_torch.core import grid as gridlib
from repro_torch.core import interpreter
from repro_torch.core.bitstream import VCGRAConfig
from repro_torch.core.dfg import DFG
from repro_torch.core.grid import GridSpec
from repro_torch.core.ingest import IngestPlan, ReadinessProbe, check_ingest
from repro_torch.core.pixie import map_app
from repro_torch.core.plan import (
    OverlayExecutable, OverlayPlan, PipelineSpec, compile_plan, fallback_chain,
)
from repro_torch.core.tiling import (
    TILE_AUTO, check_tile_rows, pad_batches, pad_channels, pow2_bucket, round_up, row_band,
)
from repro_torch.parallel.axes import MeshSpec, ShardedFrames, build_mesh, canonical
from repro_torch.parallel.sharding import frame_sharding
from repro_torch.runtime.chaos import FaultInjector, InjectedFault
from repro_torch.runtime.fault_tolerance import HeartbeatMonitor
from repro_torch.runtime.resilience import (
    BreakerBoard, PoisonedOutputError, QuarantinedError, RetryPolicy,
)
from repro_torch.runtime.spans import span


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A dispatch output as a host numpy array; bf16 (which numpy lacks)
    widens exactly to float32."""
    t = t.cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


class LazyOutput:
    """One request's output of an async-ingest dispatch: a window of the
    pooled host buffer the dispatch's outputs are copied into (pinned
    memory on a card).  The first host read -- ``np.asarray(out)``,
    :meth:`numpy` -- waits on that dispatch's :class:`ReadinessProbe`, so
    the device keeps working while the caller packs its next batch, and
    copies the window out into an array of its own, releasing the buffer.
    The fleet forces that copy before it refills the buffer.  Values are
    bitwise the sync path's numpy arrays (bf16 widened exactly to
    float32)."""

    __slots__ = ("_host", "_offset", "shape", "_probe", "_array", "__weakref__")

    def __init__(self, host: torch.Tensor, offset: int, shape: Tuple[int, ...],
                 probe: ReadinessProbe):
        self._host = host
        self._offset = offset
        self.shape = tuple(shape)
        self._probe = probe
        self._array: Optional[np.ndarray] = None

    def ready(self) -> bool:
        """Has the dispatch (and its copy back) completed?"""
        return self._array is not None or self._probe.ready()

    def numpy(self) -> np.ndarray:
        """The output as a numpy array (waits for its dispatch once)."""
        if self._array is None:
            self._probe.wait()
            n = math.prod(self.shape)
            window = self._host[self._offset:self._offset + n].view(self.shape)
            self._array = np.empty(self.shape, dtype=window.numpy().dtype)
            torch.from_numpy(self._array).copy_(window)  # parallel on large outputs
            self._host = self._probe = None
        return self._array

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        if dtype is not None and a.dtype != dtype:
            return a.astype(dtype)
        return a.copy() if copy else a

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        state = "read" if self._array is not None else "pending"
        return f"LazyOutput(shape={self.shape}, {state})"


class LRUCache:
    """Tiny ordered-dict LRU with hit/miss counters (no external deps)."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._d: "OrderedDict[Any, Any]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key: Any) -> Optional[Any]:
        if key in self._d:
            self._d.move_to_end(key)
            self.hits += 1
            return self._d[key]
        self.misses += 1
        return None

    def put(self, key: Any, value: Any) -> List[Any]:
        """Insert; returns the keys evicted to make room."""
        self._d[key] = value
        self._d.move_to_end(key)
        evicted = []
        while len(self._d) > self.capacity:
            k, _ = self._d.popitem(last=False)
            evicted.append(k)
            self.evictions += 1
        return evicted

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key: Any) -> bool:
        return key in self._d


@dataclasses.dataclass
class FleetRequest:
    """One tenant's work item.

    ``app``: a DFG, a pre-mapped VCGRAConfig, or a library app name
    (``repro_torch.core.applications.ALL_APPS``).  ``inputs``: named
    memory-VC channels, or ``image``: an [H, W] array fed through the
    stencil line buffers.  ``grid`` overrides the fleet's default overlay.

    ``pipeline`` (instead of ``app``): an ordered chain of applications --
    stage i's selected output (``out_channels[i]``, default channel 0)
    feeds stage i+1's ingest taps, and the whole chain runs as ONE
    device-resident dispatch.  A single-stage chain demotes to the plain
    fused path at submit.  Pipeline requests take ``image=`` frames only.
    """

    app: Union[DFG, VCGRAConfig, str, None] = None
    inputs: Optional[Dict[str, Any]] = None
    image: Optional[Any] = None
    grid: Optional[GridSpec] = None
    pipeline: Optional[Sequence[Union[DFG, VCGRAConfig, str]]] = None
    out_channels: Optional[Sequence[int]] = None


@dataclasses.dataclass
class FleetStats:
    """Counters of a fleet, named as in the reference's ``FleetStats``."""

    backend: str = "hopper"      # execution backend of every dispatch
    device: str = "cuda"         # device of every dispatch
    devices: int = 1             # app-axis mesh width of every dispatch
    ingest: str = "sync"         # ingest pipelining mode of every dispatch
    # The (app, rows) mesh the fleet was ASKED for vs the one the host
    # granted: build_mesh degrades to the single-device bitwise fallback
    # when the host is short of devices, and the stamp says so.
    mesh_requested: Tuple[int, int] = (1, 1)
    mesh_granted: Tuple[int, int] = (1, 1)
    mesh_degraded: bool = False
    # How async ingest observes completion: "cuda-event" (a torch.cuda.Event
    # polled with query()) or "always-ready" (a CPU fleet, where PyTorch
    # runs synchronously, so the overlap below stays 0); "none" when sync.
    ingest_readiness: str = "none"
    # Host packing time that ran while the previous dispatch was still
    # executing on the device (async ingest only).
    ingest_overlap_s: float = 0.0
    submitted: int = 0
    executed: int = 0
    dispatches: int = 0          # batched overlay launches
    fused_dispatches: int = 0    # of which took the fused-ingest path
    pipeline_dispatches: int = 0  # of which ran a depth > 1 chain
    # Streaming-scheduler preemptions: batches whose composition changed
    # because an urgent-deadline request jumped the (priority, arrival)
    # order -- see StreamingFrontend._select_batch.
    preempted_batches: int = 0
    partial_tile_dispatches: int = 0  # dispatches with fewer requests than the tile
    padded_app_slots: int = 0    # wasted N-axis slots from tile rounding
    map_calls: int = 0           # place/route runs (config-cache misses)
    config_cache_hits: int = 0
    overlay_builds: int = 0      # executables built (per OverlayPlan)
    overlay_cache_hits: int = 0
    stack_bank_hits: int = 0     # stacked settings banks reused across flushes
    canvas_pool_hits: int = 0    # frame canvases reused instead of allocated
    # Canvas reuse of a sharded async fleet, by device: each mesh shard
    # fills and ships its own pooled buffer.  Empty for unsharded fleets.
    canvas_pool_device_hits: Dict[str, int] = dataclasses.field(default_factory=dict)
    # "<plan.key()>|<padded tile>" -> dispatch count.
    dispatch_plans: Dict[str, int] = dataclasses.field(default_factory=dict)
    evicted_plans: List[str] = dataclasses.field(default_factory=list)
    # -- the self-healing ladder ------------------------------------------
    retries: int = 0             # re-dispatch attempts after a transient failure
    quarantined_requests: int = 0  # tickets isolated by bisection and failed
    # Dispatches served by a degraded plan of the fallback chain (hopper ->
    # torch, 2-D mesh -> app-only -> one device, tiled -> untiled) because
    # the primary failed or its breaker was open.  The degraded plan's key is in dispatch_plans.
    fallback_dispatches: int = 0
    guard_failures: int = 0      # outputs rejected by the NaN/Inf guard
    straggler_flushes: int = 0   # flushes the HeartbeatMonitor flagged
    # Every circuit-breaker transition, in order: {"plan", "event", "t",
    # "consecutive_failures"}.  SHARED with the fleet's BreakerBoard.
    breaker_events: List[Dict[str, Any]] = dataclasses.field(default_factory=list)

    def stamp_dispatch(self, plan: OverlayPlan, tile: str) -> None:
        key = f"{plan.key()}|{tile}"
        self.dispatch_plans[key] = self.dispatch_plans.get(key, 0) + 1

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class _PooledBuffer:
    """One reusable host buffer -- a frame canvas or an async output
    buffer -- plus the copy and the lazy outputs still using it.

    ``pending`` probes the async path's last copy out of (canvas) or into
    (output buffer) ``buf``; ``readers`` are the :class:`LazyOutput`
    windows of an output buffer.  :meth:`release` waits on the copy and
    makes every unread window copy its values out, so ``buf`` may be
    refilled; the pool calls it at *reuse* time, two flushes later under
    the depth-2 rotation."""

    buf: torch.Tensor
    pending: Optional[ReadinessProbe] = None
    readers: List["weakref.ref[LazyOutput]"] = dataclasses.field(default_factory=list)

    def release(self) -> None:
        if self.pending is not None:
            self.pending.wait()
            self.pending = None
        for ref in self.readers:
            lazy = ref()
            if lazy is not None:
                lazy.numpy()
        self.readers = []


@dataclasses.dataclass
class _Prepared:
    """A submit-time-validated work item awaiting flush."""

    grid: GridSpec
    cfg: VCGRAConfig
    kind: str                    # "image" (fused ingest) | "channels" | "pipeline"
    payload: Any                 # np [H, W] raw frame | tensor [C, batch]
    hw: Optional[Tuple[int, int]]
    # The depth > 1 chain of kind="pipeline" (depth-1 chains demote to
    # kind="image" at submit, so they share the single-stage plan cache).
    spec: Optional[PipelineSpec] = None


class PixieFleet:
    """Accepts per-app requests and serves them in batched dispatches.

    >>> fleet = PixieFleet(device="cpu")
    >>> t1 = fleet.submit(FleetRequest(app="sobel_x", image=img))
    >>> t2 = fleet.submit(FleetRequest(app="threshold", image=img))
    >>> outs = fleet.flush()          # ONE overlay dispatch for both

    ``backend`` defaults to ``"hopper"`` -- the hand-written kernels, so
    the main path runs them -- where the reference defaults to its eager
    ``"xla"``; ``backend="torch"`` is the port's eager oracle.  ``device``
    defaults to ``"cuda"`` and raises when no card is visible; the CPU is
    used only when asked for (``device="cpu"``), and there the kernel
    wrappers compute their plain PyTorch versions.

    ``mesh`` (a :class:`~repro_torch.parallel.axes.MeshSpec`) shards every
    dispatch over the local devices of the fleet's device type, as the
    reference's does; the bare device-count kwarg is its deprecated
    spelling for ``MeshSpec(app=k)``.  ``faults``, ``retry``, ``breakers``,
    ``heartbeat`` and ``output_guard`` tune the self-healing ladder with
    the reference's defaults and arming rules.  Every dispatch runs on the
    CUDA streams that were current when the fleet was built -- one per
    device of the granted mesh -- whichever thread flushes.
    """

    def __init__(
        self,
        default_grid: Optional[GridSpec] = None,
        batch_tile: int = 8,
        min_pixel_batch: int = 256,
        max_overlays: int = 8,
        max_configs: int = 256,
        max_retained_results: int = 1024,
        backend: str = "hopper",
        tile_rows: Union[int, str, None] = TILE_AUTO,
        device: Union[str, torch.device] = "cuda",
        mesh: Optional[MeshSpec] = None,
        ingest: str = "sync",
        devices: Optional[int] = None,
        faults: Optional[FaultInjector] = None,
        retry: Optional[RetryPolicy] = None,
        breakers: Optional[BreakerBoard] = None,
        heartbeat: Optional[HeartbeatMonitor] = None,
        output_guard: Optional[bool] = None,
    ):
        self.default_grid = default_grid or gridlib.sobel_grid()
        self.backend = interpreter.check_backend(backend)
        self.device = interpreter.check_device(device)
        # Device placement of every dispatch (module docstring); the bare
        # device-count kwarg is the deprecated spelling of MeshSpec(app=k).
        if devices is not None:
            d = int(devices)
            if d < 1:
                raise ValueError(f"devices must be >= 1, got {devices}")
            if mesh is not None:
                raise ValueError(
                    "pass mesh=MeshSpec(...) or the deprecated bare device "
                    "count, not both"
                )
            warnings.warn(
                "the bare device-count kwarg of PixieFleet is deprecated: "
                f"pass mesh=MeshSpec(app={d}) instead",
                DeprecationWarning,
                stacklevel=2,
            )
            mesh = MeshSpec(app=d)
        if mesh is not None and not isinstance(mesh, MeshSpec):
            raise ValueError(f"mesh must be a MeshSpec, got {mesh!r}")
        self.mesh = mesh or MeshSpec()
        # What the host grants, probed once here so the stats never name
        # the requested shape as the effective one.
        granted_mesh = build_mesh(self.mesh, self.device.type)
        granted = self.mesh if granted_mesh is not None else MeshSpec()
        # "sync" packs, dispatches and copies back in strict order; "async"
        # double-buffers (module docstring).  Bitwise-identical; async
        # results are LazyOutput windows instead of eager numpy.
        self.ingest = check_ingest(ingest)
        # The stream every dispatch is issued on (the streaming worker
        # flushes from its own thread), one per device of the granted mesh,
        # and the side streams of async host-to-device copies, made at
        # first use.  A peer copy between two cards orders itself against
        # the current streams of both, so making these current on every
        # mesh device orders each shard's work after its operands.
        self._stream = (torch.cuda.current_stream(self.device)
                        if self.device.type == "cuda" else None)
        self._streams: Dict[torch.device, Any] = {}
        if self._stream is not None:
            home = canonical(self.device)
            mesh_devices = granted_mesh.device_list() if granted_mesh is not None else []
            for d in mesh_devices:
                self._streams[d] = torch.cuda.current_stream(d)
            self._streams[home] = self._stream
        self._copy_streams: Dict[torch.device, Any] = {}
        # The last async dispatch's readiness: overlap accounting polls it
        # when the next pack starts.
        self._inflight: Optional[ReadinessProbe] = None
        # Row tiling of fused dispatches: TILE_AUTO (default), an int, or
        # None.  All values are bitwise-identical (a plan-key axis).
        self.tile_rows = check_tile_rows(tile_rows)
        self.batch_tile = int(batch_tile)
        # App-axis tiles also divide evenly across the mesh, so the plan
        # executable never re-pads (padded_app_slots accounts for ALL
        # padding).
        self._app_tile = math.lcm(self.batch_tile, self.mesh.app)
        self.min_pixel_batch = int(min_pixel_batch)
        # Fused frame canvases bucket H and W separately; the floor keeps
        # the same ~min_pixel_batch pixels per tile as the unfused path.
        self.min_image_side = max(1, int(math.isqrt(self.min_pixel_batch)))
        # Reused zero canvases for fused frame embedding, keyed by padded
        # tile shape (pinned host memory when the fleet runs on a card);
        # two per shape under async ingest, which also pools the host
        # buffers its outputs are copied into, two per size.
        self._canvas_pool = LRUCache(8)
        self._output_pool = LRUCache(8)
        self._overlays = LRUCache(max_overlays)   # keyed by OverlayPlan
        self._configs = LRUCache(max_configs)
        # Stacked settings banks: a repeat flush of the same tenant set
        # skips re-stacking (and re-copying) N configs.
        self._banks = LRUCache(4 * max_overlays)
        readiness = "none"
        if self.ingest == "async":
            readiness = "cuda-event" if self.device.type == "cuda" else "always-ready"
        self.stats = FleetStats(
            self.backend, str(self.device), self.mesh.app, self.ingest,
            mesh_requested=self.mesh.shape(), mesh_granted=granted.shape(),
            mesh_degraded=granted != self.mesh, ingest_readiness=readiness,
        )
        self._pending: List[Tuple[int, _Prepared]] = []
        # Bounded: unredeemed tickets are evicted oldest-first.
        self._results: "OrderedDict[int, Any]" = OrderedDict()
        self.max_retained_results = int(max_retained_results)
        self._next_ticket = 0
        # -- the self-healing ladder -----------------------------------------
        # Transient failures retry with a deterministic backoff, a failing
        # plan degrades down its fallback chain behind a per-plan-key
        # circuit breaker, and a request no plan can serve fails ONLY its
        # own ticket (stored in _failures, raised by result()).
        self.faults = faults
        self.retry = retry or RetryPolicy()
        self.breakers = breakers or BreakerBoard()
        # Flush wall times feed the HeartbeatMonitor; a flagged straggler
        # counts as a breaker failure for every plan it dispatched -- only
        # when the caller armed the fleet (faults=, breakers= or
        # heartbeat=), so host jitter never degrades a vanilla fleet.
        self.heartbeat = heartbeat if heartbeat is not None else HeartbeatMonitor()
        self._straggler_trips_breaker = (
            faults is not None or breakers is not None or heartbeat is not None
        )
        # NaN/Inf output guard (float grids only); on by default exactly
        # when faults are installed, since it forces async outputs eagerly.
        self._guard = bool(faults is not None if output_guard is None else output_guard)
        self._failures: "OrderedDict[int, BaseException]" = OrderedDict()
        # Per-flush scratch: breakers owed a success at flush end, and the
        # memoized fallback chains.
        self._flush_successes: List[Tuple[Any, str]] = []
        self._chain_cache = LRUCache(64)
        self.stats.breaker_events = self.breakers.events
        # pack_s: host-side input preparation, at submit (_prepare) and in
        # the flush up to the launch; flush_s: the most recent flush.
        self.timings: Dict[str, float] = {"pack_s": 0.0}

    @property
    def devices(self) -> int:
        """App-axis mesh width (the reading side of the deprecated bare
        device-count surface)."""
        return self.mesh.app

    # -- caches ---------------------------------------------------------------

    def config_for(self, app: Union[DFG, VCGRAConfig, str], grid: GridSpec) -> VCGRAConfig:
        """Mapped settings for (app, grid); place/route runs at most once
        per distinct DFG structure, and library names also cache on
        (name, grid)."""
        if isinstance(app, str):
            key = (app, grid)
            cfg = self._configs.get(key)
            if cfg is not None:
                self.stats.config_cache_hits += 1
                return cfg
            cfg = self.config_for(app_lib.ALL_APPS[app](), grid)
            self._configs.put(key, cfg)
            return cfg
        if isinstance(app, VCGRAConfig):
            expected = (
                tuple((p,) for p in grid.pes_per_level),
                tuple((p, 2) for p in grid.pes_per_level),
                (grid.num_outputs,),
            )
            if app.config_shapes() != expected:
                raise ValueError(
                    f"config {app.app_name!r} was mapped on grid "
                    f"{app.grid_name!r}, which does not match {grid.name!r}"
                )
            return app
        dfg = app
        key = (dfg.structural_hash(), grid)
        cfg = self._configs.get(key)
        if cfg is not None:
            self.stats.config_cache_hits += 1
            return cfg
        cfg = map_app(dfg, grid)
        cfg.cache_key = f"{key[0]}@{grid.name}"
        self.stats.map_calls += 1
        self._configs.put(key, cfg)
        return cfg

    def plan_for_dispatch(self, grid: GridSpec, *, fused: bool,
                          radius: Optional[int] = None,
                          pipeline: Optional[Tuple[PipelineSpec, ...]] = None,
                          ) -> OverlayPlan:
        """The :class:`OverlayPlan` of one dispatch on this fleet: the
        fleet contributes backend, mesh and tiling, the request group grid,
        fusion and radius (or, for chained dispatches, the per-tenant
        pipeline specs, from which the radius derives).  Unfused dispatches
        project the mesh to its app axis (pre-packed channels carry no row
        structure to band-shard)."""
        if pipeline is not None:
            return OverlayPlan(grid=grid, batched=True, pipeline=pipeline,
                               backend=self.backend, mesh=self.mesh,
                               tile_rows=self.tile_rows)
        return OverlayPlan(
            grid=grid, batched=True, fused=fused, radius=radius,
            backend=self.backend,
            mesh=self.mesh if fused else self.mesh.app_only(),
            tile_rows=self.tile_rows if fused else None,
        )

    def overlay_executable(self, plan: OverlayPlan) -> OverlayExecutable:
        """The executable for ``plan`` through the fleet's LRU: built once
        per distinct plan."""
        fn = self._overlays.get(plan)
        if fn is not None:
            self.stats.overlay_cache_hits += 1
            return fn
        if self.faults is not None:
            # Compile faults fire on cache MISSES only, and a failing build
            # is never cached, exactly like a real deterministic error.
            self.faults.fire("compile", (f"plan:{plan.key()}",))
        fn = compile_plan(plan, self.device.type)
        self.stats.overlay_builds += 1
        for evicted in self._overlays.put(plan, fn):
            self.stats.evicted_plans.append(evicted.key())
        return fn

    # -- request intake -------------------------------------------------------

    def submit(self, request: FleetRequest) -> int:
        """Queue one request; returns a ticket redeemed by :meth:`flush`.
        Mapping and input packing happen HERE, so an unmappable app or a
        missing input raises to its own submitter and never poisons a
        batch of other tenants' work."""
        if request.pipeline is not None:
            if request.app is not None:
                raise ValueError("give app= or pipeline=, not both")
            if request.image is None or request.inputs is not None:
                raise ValueError(
                    "pipeline requests take image= frames (every stage is "
                    "fused ingest), not inputs="
                )
        elif request.app is None:
            raise ValueError("exactly one of app= or pipeline= must be given")
        elif (request.inputs is None) == (request.image is None):
            raise ValueError("exactly one of inputs= or image= must be given")
        prepared = self._prepare(request)
        ticket = self._next_ticket
        self._next_ticket += 1
        self._pending.append((ticket, prepared))
        self.stats.submitted += 1
        return ticket

    def result(self, ticket: int) -> np.ndarray:
        """Redeem a flushed ticket (pops it from the retained results).  A
        quarantined ticket raises its stored :class:`QuarantinedError`."""
        if ticket in self._failures:
            raise self._failures.pop(ticket)
        try:
            return self._results.pop(ticket)
        except KeyError:
            raise KeyError(
                f"no retained result for ticket {ticket}: it was never "
                f"flushed, was already redeemed, or was evicted by the "
                f"retention bound (max_retained_results="
                f"{self.max_retained_results})"
            ) from None

    def discard(self, ticket: int) -> None:
        """Drop a retained result without redeeming it."""
        self._results.pop(ticket, None)

    def pending_count(self) -> int:
        """Requests submitted but not yet flushed (the continuous-batching
        scheduler polls this)."""
        return len(self._pending)

    def cancel_pending(self) -> int:
        """Drop every submitted-but-unflushed request (no results, no
        failures recorded); returns how many were dropped.  The streaming
        supervisor calls this after a worker crash, so a restarted worker
        never re-serves tickets whose handles were already failed."""
        n = len(self._pending)
        self._pending.clear()
        return n

    def pop_failures(self) -> Dict[int, BaseException]:
        """Drain the per-ticket failures of resilient flushes; front-ends
        route each to its own JobHandle.  Tickets not drained here raise
        from :meth:`result`."""
        if not self._failures:
            return {}
        failures = dict(self._failures)
        self._failures.clear()
        return failures

    def install_faults(self, faults: FaultInjector) -> None:
        """Arm an injector after construction (the streaming front-end
        installs its injector into the fleet it owns).  Also arms the
        NaN/Inf guard and the straggler -> breaker coupling, as passing
        ``faults=`` at construction does."""
        self.faults = faults
        self._guard = True
        self._straggler_trips_breaker = True

    def _stacked_bank(self, grid: GridSpec, configs: List[VCGRAConfig],
                      fused: bool = False):
        """Stacked settings tensors on the fleet's device for a tenant
        set, cached across flushes when every config carries a cache
        identity.  Fused banks also carry the stacked ingest plans."""

        def build():
            stacked = VCGRAConfig.stack(configs, device=self.device)
            if not fused:
                return stacked
            ingests = IngestPlan.stack([c.ingest for c in configs], grid.dtype,
                                       device=self.device)
            return stacked, ingests

        keys = tuple(c.cache_key for c in configs)
        if any(k is None for k in keys):
            return build()
        bkey = (grid, keys, fused)
        stacked = self._banks.get(bkey)
        if stacked is not None:
            self.stats.stack_bank_hits += 1
            return stacked
        stacked = build()
        self._banks.put(bkey, stacked)
        return stacked

    def _pooled(self, cache: LRUCache, shape: Tuple[int, ...], dtype: torch.dtype,
                slot: Optional[Tuple[int, int]] = None) -> Tuple[_PooledBuffer, bool]:
        """A host buffer from a reuse pool (pinned when the fleet runs on a
        card, so copies to and from the device are plain DMAs) and whether
        it was reused.  The pool is two deep under async ingest -- flush
        k+1 fills one buffer while flush k's copy of the other may be in
        flight -- and a reused buffer is released here (:meth:`_PooledBuffer.
        release`).  ``slot`` keys a mesh shard's own buffers."""
        key = (shape, dtype) if slot is None else (shape, dtype, slot)
        pool = cache.get(key)
        if pool is None:
            pool = []
            cache.put(key, pool)
        depth = 2 if self.ingest == "async" else 1
        if len(pool) < depth:
            entry = _PooledBuffer(torch.zeros(shape, dtype=dtype,
                                              pin_memory=self.device.type == "cuda"))
            pool.append(entry)
            return entry, False
        entry = pool.pop(0)
        pool.append(entry)
        entry.release()
        return entry, True

    def _canvas(self, shape: Tuple[int, ...], dtype: torch.dtype,
                slot: Optional[Tuple[int, int]] = None,
                device: Optional[torch.device] = None) -> _PooledBuffer:
        """A zeroed host frame canvas from the canvas pool.  A sharded
        async fleet gives each mesh shard (``slot``, on ``device``) its own
        buffers, so one shard's copy in flight never holds up another's
        fill; their reuse is also counted per device."""
        entry, reused = self._pooled(self._canvas_pool, shape, dtype, slot)
        if reused:
            self.stats.canvas_pool_hits += 1
            if device is not None:
                hits = self.stats.canvas_pool_device_hits
                hits[str(device)] = hits.get(str(device), 0) + 1
            entry.buf.zero_()
        return entry

    def _note_overlap(self, pack_started: float) -> None:
        """Credit host pack time to ``ingest_overlap_s`` when it ran while
        the previous async dispatch was still executing; drop the probe
        once it reports completion."""
        if self._inflight is None:
            return
        if self._inflight.ready():
            self._inflight = None
        else:
            self.stats.ingest_overlap_s += time.perf_counter() - pack_started

    def _on_device(self):
        """The fleet's dispatch streams -- one per device of its granted
        mesh -- made current for the calling thread, the fleet's own
        device last (entering a stream also makes its device current)."""
        if self._stream is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        home = canonical(self.device)
        for d, stream in self._streams.items():
            if d != home:
                stack.enter_context(torch.cuda.stream(stream))
        stack.enter_context(torch.cuda.device(self.device))
        stack.enter_context(torch.cuda.stream(self._stream))
        return stack

    def _small_to_device(self, array: np.ndarray) -> torch.Tensor:
        """A small host operand on the device.  Under async ingest on a
        card it goes through pinned memory without blocking the host: a
        blocking copy would wait for the previous dispatch and void the
        overlap."""
        t = torch.from_numpy(array)
        if self.ingest == "async" and self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _prepare(self, request: FleetRequest) -> _Prepared:
        t0 = time.perf_counter()
        grid = request.grid or self.default_grid
        if request.pipeline is not None:
            prepared = self._prepare_pipeline(request, grid)
            self.timings["pack_s"] += time.perf_counter() - t0
            return prepared
        cfg = self.config_for(request.app, grid)
        if request.image is not None:
            image = np.asarray(request.image)
            if image.ndim != 2:
                raise ValueError(f"image must be [H, W], got shape {image.shape}")
            hw = tuple(image.shape)
            if cfg.ingest is not None:
                # Fused path: keep the RAW frame; line-buffer formation
                # happens inside the batched dispatch at flush time.
                prepared = _Prepared(grid, cfg, "image", image, hw)
                self.timings["pack_s"] += time.perf_counter() - t0
                return prepared
            # No ingest plan (a channel is neither tap nor const): pack the
            # taps here so the request still runs on the channel path.
            taps = app_lib.stencil_inputs(torch.as_tensor(image, device=self.device))
            feed = {k: v for k, v in taps.items() if k in cfg.input_order}
        else:
            hw = None
            feed = request.inputs
        x = interpreter.pack_inputs(cfg, feed, grid.dtype, device=self.device)
        if x.dim() != 2:
            raise ValueError(f"fleet needs flat [channels, batch] inputs, got {tuple(x.shape)}")
        prepared = _Prepared(grid, cfg, "channels", pad_channels(x, grid.num_inputs), hw)
        self.timings["pack_s"] += time.perf_counter() - t0
        return prepared

    def _prepare_pipeline(self, request: FleetRequest, grid: GridSpec) -> _Prepared:
        """Validate and map a chained request at submit time.  Every stage
        needs an ingest plan (the chain is fused ingest end to end); a
        depth-1 chain demotes to the plain "image" kind, so it batches and
        caches exactly like an ``app=`` request."""
        chain = list(request.pipeline)
        if not chain:
            raise ValueError("pipeline= must name at least one stage")
        image = np.asarray(request.image)
        if image.ndim != 2:
            raise ValueError(f"image must be [H, W], got shape {image.shape}")
        hw = tuple(image.shape)
        cfgs = [self.config_for(app, grid) for app in chain]
        for cfg in cfgs:
            if cfg.ingest is None:
                raise ValueError(
                    f"pipeline stage {cfg.app_name!r} has no ingest plan "
                    f"(a channel is neither stencil tap nor const); chains "
                    f"need fused-ingest stages end to end"
                )
        spec = PipelineSpec.chain(cfgs, request.out_channels)
        if spec.depth == 1:
            return _Prepared(grid, cfgs[0], "image", image, hw)
        return _Prepared(grid, cfgs[0], "pipeline", image, hw, spec=spec)

    # -- batched execution ----------------------------------------------------

    def _dispatch_fused(self, plan: OverlayPlan, items: List[Tuple[int, _Prepared]],
                        out: Dict[int, Any]) -> None:
        """One fused dispatch: raw frames -> outputs, line buffers inside.

        ``plan`` carries the execution axes: the resilient flush passes the
        fleet's primary plan, or a degraded sibling from
        :func:`~repro_torch.core.plan.fallback_chain` -- same operands,
        same bitwise outputs, another executable.

        Frames are embedded top-left into one zero host canvas
        [n_tile, Hb, Wb] (pow-2-bucketed sides, app axis rounded to
        batch_tile), copied to the device once; the zero canvas right/below
        a frame is read by edge taps exactly like ``stencil_inputs``'s zero
        border, so each [H, W] output slice is bitwise the unbatched one.
        """
        t0 = time.perf_counter()
        fn = self.overlay_executable(plan)
        grid = plan.grid
        n = len(items)
        n_tile = round_up(n, self._app_tile)
        Hb, Wb = self._canvas_sides(plan, items)
        configs = [p.cfg for _, p in items]
        # Tile padding on the app axis: replay config[0] on a zero frame.
        configs += [configs[0]] * (n_tile - n)
        self.stats.padded_app_slots += n_tile - n
        self.stats.partial_tile_dispatches += 1 if n < n_tile else 0
        with span("fleet.bank"):
            stacked, ingests = self._stacked_bank(grid, configs, fused=True)
        frames = self._ship_frames(fn, items, n_tile, Hb, Wb, grid.dtype)
        self._note_overlap(t0)
        self.timings["pack_s"] += time.perf_counter() - t0

        self._pre_dispatch(plan, items)
        with span("fleet.launch"):
            ys = fn(stacked, ingests, frames)
        ys = self._corrupt_outputs(items, ys)
        self.stats.dispatches += 1
        self.stats.fused_dispatches += 1
        with span("fleet.unpack"):
            self._unpack_frames(fn.plan, items, ys, n_tile, Hb, Wb, out)

    def _canvas_sides(self, plan: OverlayPlan,
                      items: List[Tuple[int, _Prepared]]) -> Tuple[int, int]:
        """The canvas ``(Hb, Wb)`` of a frame dispatch: pow-2 buckets of the
        largest frame.  A row-sharded plan rounds Hb to whole
        radius-floored bands, so the sharded ship path and the executable
        agree on the band split and the executable's own row padding is a
        no-op."""
        Hb = pow2_bucket(max(p.hw[0] for _, p in items), self.min_image_side)
        Wb = pow2_bucket(max(p.hw[1] for _, p in items), self.min_image_side)
        if plan.mesh.rows > 1:
            Hb = row_band(Hb, plan.mesh.rows, plan.radius) * plan.mesh.rows
        return Hb, Wb

    def _ship_frames(self, fn: OverlayExecutable, items: List[Tuple[int, _Prepared]],
                     n_tile: int, Hb: int, Wb: int, dtype: torch.dtype):
        """Embed the raw frames top-left into one pooled zero canvas
        ``[n_tile, Hb, Wb]`` and copy it to the fleet's device (on a CPU
        fleet the canvas itself; outputs never alias it).  An async
        dispatch on a granted mesh ships per shard instead
        (:meth:`_ship_sharded_frames`)."""
        if self.ingest == "async" and fn.mesh is not None:
            return self._ship_sharded_frames(fn.mesh, items, n_tile, Hb, Wb, dtype)
        with span("fleet.canvas"):
            entry = self._canvas((n_tile, Hb, Wb), dtype)
        with span("fleet.embed"):
            for i, (_, p) in enumerate(items):
                H, W = p.hw
                entry.buf[i, :H, :W] = torch.from_numpy(np.ascontiguousarray(p.payload))
        with span("fleet.ship"):
            if self.ingest == "sync":
                return entry.buf.to(self.device)
            return self._ship(entry, self.device)

    def _ship(self, entry: _PooledBuffer, device: torch.device) -> torch.Tensor:
        """Async copy of a pooled canvas to ``device``.  On a card the copy
        runs ``non_blocking`` on the device's side stream into memory
        allocated there (and marked as used by the device's dispatch
        stream), the dispatch stream waits on its event, and the canvas
        keeps the event as its pending copy, waited for at reuse."""
        canvas = entry.buf
        if device.type != "cuda":
            return canvas.to(device)
        copy = self._copy_streams.get(device)
        if copy is None:
            copy = self._copy_streams[device] = torch.cuda.Stream(device)
        main = torch.cuda.current_stream(device)
        with torch.cuda.stream(copy):
            frames = torch.empty(canvas.shape, dtype=canvas.dtype, device=device)
            frames.copy_(canvas, non_blocking=True)
            entry.pending = ReadinessProbe(device, copy)
        frames.record_stream(main)
        entry.pending.block(main)
        return frames

    def _ship_sharded_frames(self, mesh, items: List[Tuple[int, _Prepared]], n_tile: int,
                             Hb: int, Wb: int, dtype: torch.dtype) -> ShardedFrames:
        """Per-shard canvas embed and ship for an async dispatch on a
        granted mesh: each ``(app, row-band)`` block of the canvas
        (``parallel.sharding.frame_sharding``) gets its own pooled pinned
        buffer, holding that shard's slice of the tenant frames, and is
        shipped to its own device -- so one shard's copy in flight never
        gates another's fill.  The blocks reach the mesh executable as a
        :class:`~repro_torch.parallel.axes.ShardedFrames`, split as it
        splits, with no further copy.  Bitwise the single-canvas path."""
        sharding = frame_sharding(mesh)
        chunk, band = n_tile // mesh.app, Hb // mesh.rows
        shipped = []
        for b in sharding.blocks(n_tile, Hb):
            with span("fleet.canvas"):
                entry = self._canvas((chunk, band, Wb), dtype, slot=(b.i, b.j),
                                     device=b.device)
            with span("fleet.embed"):
                for k, (_, p) in enumerate(items[b.apps.start:b.apps.stop]):
                    H, W = p.hw
                    h = min(H - b.rows.start, band)
                    if h > 0:
                        rows = p.payload[b.rows.start:b.rows.start + h]
                        entry.buf[k, :h, :W] = torch.from_numpy(np.ascontiguousarray(rows))
            with span("fleet.ship"):
                shipped.append(self._ship(entry, b.device))
        return sharding.assemble((n_tile, Hb, Wb), shipped)

    def _unpack_frames(self, plan: OverlayPlan, items: List[Tuple[int, _Prepared]],
                       ys: torch.Tensor, n_tile: int, Hb: int, Wb: int,
                       out: Dict[int, Any]) -> None:
        """Stamp a frame dispatch and slice each request's ``[H, W]`` (or
        ``[K, H, W]``) output back to the host."""
        self.stats.stamp_dispatch(plan, f"n{n_tile}x{Hb}x{Wb}")
        self.stats.executed += len(items)
        if self.ingest == "async":
            views = []
            for i, (_, p) in enumerate(items):
                H, W = p.hw
                y = ys[i].reshape(-1, Hb, Wb)[:, :H, :W]
                views.append(y[0] if y.shape[0] == 1 else y)
            self._unpack_lazy(items, views, ys.numel(), out)
            return
        for i, (ticket, p) in enumerate(items):
            H, W = p.hw
            y = _to_host(ys[i].reshape(-1, Hb, Wb)[:, :H, :W])
            out[ticket] = y[0] if y.shape[0] == 1 else y

    def _unpack_lazy(self, items: List[Tuple[int, _Prepared]], views: List[torch.Tensor],
                     capacity: int, out: Dict[int, Any]) -> None:
        """Async unpack: every request's output view is gathered into ONE
        buffer, which lands in a pooled host buffer of ``capacity``
        elements (the dispatch's padded output size, so pool keys follow
        the tile buckets) -- on a card through one ``non_blocking`` copy
        into pinned memory -- and is handed out as :class:`LazyOutput`
        windows behind one readiness probe.  bf16 widens exactly to
        float32 on the way."""
        dtype = torch.float32 if views[0].dtype == torch.bfloat16 else views[0].dtype
        sizes = [v.numel() for v in views]
        entry, _ = self._pooled(self._output_pool, (capacity,), dtype)
        host = entry.buf[:sum(sizes)]
        packed = host
        if self.device.type == "cuda":
            packed = torch.empty(host.shape, dtype=dtype, device=self.device)
        offset = 0
        for v, size in zip(views, sizes):
            packed[offset:offset + size].view(v.shape).copy_(v)
            offset += size
        if packed is not host:
            host.copy_(packed, non_blocking=True)
        probe = entry.pending = ReadinessProbe(self.device)
        offset = 0
        for (ticket, _), v, size in zip(items, views, sizes):
            out[ticket] = lazy = LazyOutput(host, offset, tuple(v.shape), probe)
            entry.readers.append(weakref.ref(lazy))
            offset += size
        self._inflight = probe

    def _dispatch_pipeline(self, plan: OverlayPlan, items: List[Tuple[int, _Prepared]],
                           out: Dict[int, Any]) -> None:
        """One chained dispatch: raw frames -> final-stage outputs, every
        intermediate on the device.

        Frames embed, bucket and tile exactly like :meth:`_dispatch_fused`;
        the chain changes the executable (a pipeline plan keyed
        ``pipe{digest}``, whose spec tuple is already padded to the app
        tile) and adds two operands: per-stage settings banks (through the
        same bank cache) and the per-app true frame extents ``hw`` the
        executor re-masks intermediates with.  Padded app slots replay item
        0's chain on a zero frame with ``hw = (Hb, Wb)``."""
        t0 = time.perf_counter()
        fn = self.overlay_executable(plan)
        grid = plan.grid
        n = len(items)
        specs = plan.pipeline
        n_tile = len(specs)
        Hb, Wb = self._canvas_sides(plan, items)
        self.stats.padded_app_slots += n_tile - n
        self.stats.partial_tile_dispatches += 1 if n < n_tile else 0
        stage_settings = []
        with span("fleet.bank"):
            for si in range(specs[0].depth):
                stacked, ingests = self._stacked_bank(
                    grid, [s.stages[si].config for s in specs], fused=True)
                out_ch = self._small_to_device(
                    np.asarray([s.stages[si].out_channel for s in specs], np.int32))
                stage_settings.append((stacked, ingests, out_ch))
            hw = np.full((n_tile, 2), (Hb, Wb), np.int32)
            for i, (_, p) in enumerate(items):
                hw[i] = p.hw
            hw = self._small_to_device(hw)
        frames = self._ship_frames(fn, items, n_tile, Hb, Wb, grid.dtype)
        self._note_overlap(t0)
        self.timings["pack_s"] += time.perf_counter() - t0

        self._pre_dispatch(plan, items)
        with span("fleet.launch"):
            ys = fn(tuple(stage_settings), hw, frames)
        ys = self._corrupt_outputs(items, ys)
        self.stats.dispatches += 1
        self.stats.fused_dispatches += 1
        self.stats.pipeline_dispatches += 1
        with span("fleet.unpack"):
            self._unpack_frames(fn.plan, items, ys, n_tile, Hb, Wb, out)

    def _dispatch_packed(self, plan: OverlayPlan, items: List[Tuple[int, _Prepared]],
                         out: Dict[int, Any]) -> None:
        """One unfused dispatch over packed [channels, batch] inputs
        (named-channel requests and image apps without an ingest plan)."""
        t0 = time.perf_counter()
        fn = self.overlay_executable(plan)
        grid = plan.grid
        n = len(items)
        n_tile = round_up(n, self._app_tile)
        batch = pow2_bucket(max(p.payload.shape[-1] for _, p in items),
                            self.min_pixel_batch)
        configs = [p.cfg for _, p in items]
        # Tile padding on the app axis: replay config[0] on zero pixels.
        configs += [configs[0]] * (n_tile - n)
        self.stats.padded_app_slots += n_tile - n
        self.stats.partial_tile_dispatches += 1 if n < n_tile else 0
        with span("fleet.bank"):
            stacked = self._stacked_bank(grid, configs)
        with span("fleet.embed"):
            xs = pad_batches([p.payload for _, p in items], batch)
            xs += [torch.zeros_like(xs[0])] * (n_tile - n)
            xstack = torch.stack(xs)
        self._note_overlap(t0)
        self.timings["pack_s"] += time.perf_counter() - t0

        self._pre_dispatch(plan, items)
        with span("fleet.launch"):
            ys = fn(stacked, xstack)
        ys = self._corrupt_outputs(items, ys)
        self.stats.dispatches += 1
        self.stats.stamp_dispatch(fn.plan, f"n{n_tile}xb{batch}")
        self.stats.executed += n
        with span("fleet.unpack"):
            if self.ingest == "async":
                views = []
                for i, (_, p) in enumerate(items):
                    y = ys[i, :, : p.payload.shape[-1]]
                    if p.hw is not None:
                        H, W = p.hw
                        y = y[:, : H * W].reshape((-1, H, W))
                        y = y[0] if y.shape[0] == 1 else y
                    views.append(y)
                self._unpack_lazy(items, views, ys.numel(), out)
            else:
                for i, (ticket, p) in enumerate(items):
                    y = _to_host(ys[i, :, : p.payload.shape[-1]])
                    if p.hw is not None:
                        H, W = p.hw
                        y = y[:, : H * W].reshape((-1, H, W))
                        y = y[0] if y.shape[0] == 1 else y
                    out[ticket] = y

    # -- resilient dispatch ---------------------------------------------------

    def _primary_plan(self, key: Tuple, items: List[Tuple[int, _Prepared]]) -> OverlayPlan:
        """The fleet-configured plan of one flush group.  Chain groups bake
        their app-tile-padded spec tuple into the plan (padding is
        executable shape), so the plan is recomputed per work set during
        bisection."""
        grid = key[0]
        if key[1] == "image":
            return self.plan_for_dispatch(grid, fused=True, radius=key[2])
        if key[1] == "pipe":
            specs = [p.spec for _, p in items]
            specs += [specs[0]] * (round_up(len(items), self._app_tile) - len(items))
            return self.plan_for_dispatch(grid, fused=True, pipeline=tuple(specs))
        return self.plan_for_dispatch(grid, fused=False)

    def _dispatch_plan(self, plan: OverlayPlan, kind: str,
                       items: List[Tuple[int, _Prepared]], out: Dict[int, Any]) -> None:
        if kind == "image":
            self._dispatch_fused(plan, items, out)
        elif kind == "pipe":
            self._dispatch_pipeline(plan, items, out)
        else:
            self._dispatch_packed(plan, items, out)

    def _candidates(self, plan: OverlayPlan) -> Tuple[OverlayPlan, ...]:
        """``(primary, *fallback_chain)``, memoized per plan."""
        chain = self._chain_cache.get(plan)
        if chain is None:
            chain = (plan, *fallback_chain(plan))
            self._chain_cache.put(plan, chain)
        return chain

    def _fault_tokens(self, plan: OverlayPlan,
                      items: List[Tuple[int, _Prepared]]) -> List[str]:
        """Context tokens a FaultSpec's ``match=`` is tested against: the
        plan key plus every rider's ticket and app name (bracketed so
        ``<ticket:1>`` never substring-matches ``<ticket:12>``)."""
        tokens = [f"plan:{plan.key()}"]
        for ticket, p in items:
            tokens.append(f"<ticket:{ticket}>")
            tokens.append(f"<app:{p.cfg.app_name}>")
        return tokens

    def _pre_dispatch(self, plan: OverlayPlan, items: List[Tuple[int, _Prepared]]) -> None:
        """Fire the stall and dispatch hook points (one attribute check
        without an injector)."""
        if self.faults is None:
            return
        tokens = self._fault_tokens(plan, items)
        self.faults.fire("transfer_stall", tokens)
        self.faults.fire("dispatch", tokens)

    def _corrupt_outputs(self, items: List[Tuple[int, _Prepared]],
                         ys: torch.Tensor) -> torch.Tensor:
        """Apply armed ``nan_output`` corruption to the dispatch's output
        batch (float grids only: integer fabrics cannot encode NaN, so the
        output guard scopes itself the same way)."""
        if self.faults is None or not ys.dtype.is_floating_point:
            return ys
        slots = self.faults.corrupt_slots(
            [[f"<ticket:{t}>", f"<app:{p.cfg.app_name}>"] for t, p in items])
        if slots:
            ys = ys.clone()
            ys[slots] = float("nan")
        return ys

    def _guard_outputs(self, got: Dict[int, Any],
                       items: List[Tuple[int, _Prepared]]) -> List[Tuple[int, _Prepared]]:
        """The NaN/Inf output guard: pops poisoned tickets out of ``got``
        and returns their work items (the resilient loop re-dispatches
        just those).  Float outputs only; forces async outputs, which is
        why the guard defaults on only when faults are installed."""
        if not self._guard:
            return []
        bad = []
        for ticket, prep in items:
            y = got.get(ticket)
            if y is None:
                continue
            arr = np.asarray(y)
            if np.issubdtype(arr.dtype, np.floating) and not np.isfinite(arr).all():
                bad.append((ticket, prep))
                del got[ticket]
        return bad

    def _quarantine(self, ticket: int, prep: _Prepared,
                    cause: Optional[BaseException]) -> None:
        """Fail ONE isolated request: a QuarantinedError against its ticket
        (raised by result(), drained by front-ends via pop_failures)."""
        self.stats.quarantined_requests += 1
        exc = QuarantinedError(ticket, app=prep.cfg.app_name, cause=cause)
        if cause is not None:
            exc.__cause__ = cause
        self._failures[ticket] = exc
        while len(self._failures) > self.max_retained_results:
            self._failures.popitem(last=False)

    def _dispatch_resilient(self, key: Tuple, items: List[Tuple[int, _Prepared]],
                            out: Dict[int, Any]) -> None:
        """One flush group through the self-healing ladder, in the
        reference's order:

        1. the primary plan, retried with deterministic backoff on
           *transient* failures (``RetryPolicy.should_retry``);
        2. on exhaustion or a non-transient failure -- or when the
           primary's breaker is open -- each plan of the fallback chain in
           turn, each behind its own breaker (the last is tried even when
           its breaker is open, if nothing else was);
        3. outputs through the NaN/Inf guard: clean tickets commit, and
           only the poisoned ones go around again;
        4. if EVERY plan fails the whole work set, bisect: halves recurse
           independently, so only the offending request(s) fail, with
           QuarantinedError.

        The ladder routes :class:`InjectedFault` (the chaos hook points)
        and poisoned outputs.  Any other error of a dispatch -- a kernel
        that cannot be built, loaded or launched, a refused operand --
        raises out of the flush at once and is never served around.
        Breaker successes are deferred to :meth:`_settle_flush`."""
        kind = key[1]
        candidates = self._candidates(self._primary_plan(key, items))
        last_exc: Optional[BaseException] = None
        tried_any = False
        for ci, cand in enumerate(candidates):
            br = self.breakers.breaker(cand.key())
            last_resort = ci == len(candidates) - 1 and not tried_any
            if not br.allow() and not last_resort:
                continue
            tried_any = True
            for attempt in range(self.retry.max_attempts):
                if attempt:
                    self.stats.retries += 1
                    time.sleep(self.retry.backoff_s(attempt - 1))
                got: Dict[int, Any] = {}
                try:
                    self._dispatch_plan(cand, kind, items, got)
                    bad = self._guard_outputs(got, items)
                except InjectedFault as exc:
                    last_exc = exc
                    br.record_failure()
                    if self.retry.should_retry(exc):
                        continue
                    break
                if bad:
                    out.update(got)
                    self.stats.guard_failures += len(bad)
                    br.record_failure("nan_guard")
                    last_exc = PoisonedOutputError(
                        f"{len(bad)}/{len(items)} outputs of plan "
                        f"{cand.key()} failed the NaN/Inf guard"
                    )
                    if len(bad) < len(items):
                        # Survivors committed; the poisoned subset takes
                        # the whole ladder again from the primary.
                        self._dispatch_resilient(key, bad, out)
                        return
                    continue  # whole batch poisoned: burn a retry
                out.update(got)
                self._flush_successes.append((br, cand.key()))
                if ci:  # not the primary (by position in the chain)
                    self.stats.fallback_dispatches += 1
                return
        if len(items) == 1:
            ticket, prep = items[0]
            self._quarantine(ticket, prep, last_exc)
            return
        mid = len(items) // 2
        self._dispatch_resilient(key, items[:mid], out)
        self._dispatch_resilient(key, items[mid:], out)

    def _settle_flush(self, dispatched: bool, flush_s: float) -> None:
        """Flush epilogue: feed the wall time to the HeartbeatMonitor and
        settle the deferred breaker successes -- a straggler flush counts
        against every plan it dispatched when the fleet is armed,
        otherwise each plan records its success."""
        straggler = False
        if dispatched and self.heartbeat is not None:
            straggler = self.heartbeat.record(self.stats.dispatches, flush_s)
            if straggler:
                self.stats.straggler_flushes += 1
        punish = straggler and self._straggler_trips_breaker
        for br, _key in self._flush_successes:
            if punish:
                br.record_failure("straggler")
            else:
                br.record_success()
        self._flush_successes = []

    def flush(self, limit: Optional[int] = None) -> Dict[int, Any]:
        """Run pending requests through the self-healing ladder: one
        dispatch per grid group (two when a group mixes fused image
        requests with packed-channel requests), plus one per chain radii
        group.

        ``limit`` dispatches only the oldest ``limit`` pending requests and
        leaves the rest queued.  ``timings`` gets ``flush_started`` and
        ``flush_s``.  Returns {ticket: output}: image requests as [H, W]
        (or [num_outputs, H, W]), channel requests as [num_outputs, batch];
        numpy arrays on the host under sync ingest (bf16 grids as exact
        float32), :class:`LazyOutput` windows of the same values under
        async ingest.  A quarantined ticket is missing from the result and
        raises from :meth:`result` (or is drained by :meth:`pop_failures`);
        any dispatch error other than an injected fault raises.
        """
        if limit is None or limit >= len(self._pending):
            pending, self._pending = self._pending, []
        else:
            if limit < 1:
                raise ValueError(f"flush limit must be >= 1, got {limit}")
            pending, self._pending = self._pending[:limit], self._pending[limit:]
        # Group by (grid, path): fused image groups also key on the stencil
        # radius, which fixes the tap-bank layout of the executable, and
        # chains on their per-stage radii (depth and radii are executable
        # shape; the specs ride the plan as per-tenant settings).
        groups: Dict[Tuple, List[Tuple[int, _Prepared]]] = {}
        for ticket, p in pending:
            if p.kind == "image":
                key = (p.grid, "image", p.cfg.ingest.radius)
            elif p.kind == "pipeline":
                key = (p.grid, "pipe", p.spec.radii)
            else:
                key = (p.grid, "channels")
            groups.setdefault(key, []).append((ticket, p))

        out: Dict[int, Any] = {}
        t0 = time.perf_counter()
        self.timings["flush_started"] = t0
        self._flush_successes = []
        with self._on_device():
            for key, items in groups.items():
                self._dispatch_resilient(key, items, out)
        flush_s = time.perf_counter() - t0
        self.timings["flush_s"] = flush_s
        self._settle_flush(bool(groups), flush_s)
        self._results.update(out)
        while len(self._results) > self.max_retained_results:
            self._results.popitem(last=False)
        return out

    def run_many(self, requests: Sequence[FleetRequest]) -> List[Any]:
        """submit() + flush() convenience; outputs in request order (and
        released from retention).  A quarantined request raises its
        stored failure."""
        tickets = [self.submit(r) for r in requests]
        outs = self.flush()
        failures = self.pop_failures()
        for t in tickets:
            self.discard(t)
        for t in tickets:
            if t in failures:
                raise failures[t]
        return [outs[t] for t in tickets]
