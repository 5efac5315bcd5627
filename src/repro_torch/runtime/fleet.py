"""Pixie fleet: a multi-tenant batched scheduler for VCGRA overlays.

Twin of the reference package's ``runtime/fleet.py`` (one device, sync
ingest).  Every application mapped on a grid yields identically-shaped
settings, so N *different* tenants stack (``VCGRAConfig.stack``) into one
dispatch of a batched :class:`~repro_torch.core.plan.OverlayPlan`.

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
  executables per plan, stacked settings banks per tenant set.

Banks and canvases live on the fleet's ``device`` (default ``"cuda"``,
which raises when no card is visible).  This fleet has no self-healing
ladder: a dispatch error propagates out of :meth:`PixieFleet.flush`.
"""

from __future__ import annotations

import dataclasses
import math
import time
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
from repro_torch.core.ingest import IngestPlan
from repro_torch.core.pixie import map_app
from repro_torch.core.plan import (
    OverlayExecutable, OverlayPlan, PipelineSpec, compile_plan,
)
from repro_torch.core.tiling import (
    TILE_AUTO, check_tile_rows, pad_batches, pad_channels, pow2_bucket, round_up,
)


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A dispatch output as a host numpy array; bf16 (which numpy lacks)
    widens exactly to float32."""
    t = t.cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


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
    submitted: int = 0
    executed: int = 0
    dispatches: int = 0          # batched overlay launches
    fused_dispatches: int = 0    # of which took the fused-ingest path
    pipeline_dispatches: int = 0  # of which ran a depth > 1 chain
    partial_tile_dispatches: int = 0  # dispatches with fewer requests than the tile
    padded_app_slots: int = 0    # wasted N-axis slots from tile rounding
    map_calls: int = 0           # place/route runs (config-cache misses)
    config_cache_hits: int = 0
    overlay_builds: int = 0      # executables built (per OverlayPlan)
    overlay_cache_hits: int = 0
    stack_bank_hits: int = 0     # stacked settings banks reused across flushes
    canvas_pool_hits: int = 0    # frame canvases reused instead of allocated
    # "<plan.key()>|<padded tile>" -> dispatch count.
    dispatch_plans: Dict[str, int] = dataclasses.field(default_factory=dict)
    evicted_plans: List[str] = dataclasses.field(default_factory=list)

    def stamp_dispatch(self, plan: OverlayPlan, tile: str) -> None:
        key = f"{plan.key()}|{tile}"
        self.dispatch_plans[key] = self.dispatch_plans.get(key, 0) + 1


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
    ):
        self.default_grid = default_grid or gridlib.sobel_grid()
        self.backend = interpreter.check_backend(backend)
        self.device = interpreter.check_device(device)
        # Row tiling of fused dispatches: TILE_AUTO (default), an int, or
        # None.  All values are bitwise-identical (a plan-key axis).
        self.tile_rows = check_tile_rows(tile_rows)
        self.batch_tile = int(batch_tile)
        self.min_pixel_batch = int(min_pixel_batch)
        # Fused frame canvases bucket H and W separately; the floor keeps
        # the same ~min_pixel_batch pixels per tile as the unfused path.
        self.min_image_side = max(1, int(math.isqrt(self.min_pixel_batch)))
        # Reused zero canvases for fused frame embedding, keyed by padded
        # tile shape (pinned host memory when the fleet runs on a card).
        self._canvas_pool = LRUCache(8)
        self._overlays = LRUCache(max_overlays)   # keyed by OverlayPlan
        self._configs = LRUCache(max_configs)
        # Stacked settings banks: a repeat flush of the same tenant set
        # skips re-stacking (and re-copying) N configs.
        self._banks = LRUCache(4 * max_overlays)
        self.stats = FleetStats(self.backend, str(self.device))
        self._pending: List[Tuple[int, _Prepared]] = []
        # Bounded: unredeemed tickets are evicted oldest-first.
        self._results: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self.max_retained_results = int(max_retained_results)
        self._next_ticket = 0
        # pack_s: host-side input preparation; dispatch_s: overlay
        # executions incl. output copies; flush_s: the most recent flush.
        self.timings: Dict[str, float] = {"pack_s": 0.0, "dispatch_s": 0.0}

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
        fleet contributes backend and tiling, the request group grid,
        fusion and radius (or, for chained dispatches, the per-tenant
        pipeline specs, from which the radius derives)."""
        if pipeline is not None:
            return OverlayPlan(grid=grid, batched=True, pipeline=pipeline,
                               backend=self.backend, tile_rows=self.tile_rows)
        return OverlayPlan(
            grid=grid, batched=True, fused=fused, radius=radius,
            backend=self.backend,
            tile_rows=self.tile_rows if fused else None,
        )

    def overlay_executable(self, plan: OverlayPlan) -> OverlayExecutable:
        """The executable for ``plan`` through the fleet's LRU: built once
        per distinct plan."""
        fn = self._overlays.get(plan)
        if fn is not None:
            self.stats.overlay_cache_hits += 1
            return fn
        fn = compile_plan(plan)
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
        """Redeem a flushed ticket (pops it from the retained results)."""
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
        """Requests submitted but not yet flushed."""
        return len(self._pending)

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

    def _canvas(self, shape: Tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
        """A zeroed host frame canvas from the reuse pool (pinned when the
        fleet runs on a card, so the copy to the device is a plain DMA)."""
        key = (shape, dtype)
        buf = self._canvas_pool.get(key)
        if buf is None:
            buf = torch.zeros(shape, dtype=dtype,
                              pin_memory=self.device.type == "cuda")
            self._canvas_pool.put(key, buf)
            return buf
        self.stats.canvas_pool_hits += 1
        buf.zero_()
        return buf

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
                        out: Dict[int, np.ndarray]) -> None:
        """One fused dispatch: raw frames -> outputs, line buffers inside.

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
        n_tile = round_up(n, self.batch_tile)
        Hb = pow2_bucket(max(p.hw[0] for _, p in items), self.min_image_side)
        Wb = pow2_bucket(max(p.hw[1] for _, p in items), self.min_image_side)
        configs = [p.cfg for _, p in items]
        # Tile padding on the app axis: replay config[0] on a zero frame.
        configs += [configs[0]] * (n_tile - n)
        self.stats.padded_app_slots += n_tile - n
        self.stats.partial_tile_dispatches += 1 if n < n_tile else 0
        stacked, ingests = self._stacked_bank(grid, configs, fused=True)
        frames = self._ship_frames(items, n_tile, Hb, Wb, grid.dtype)
        self.timings["pack_s"] += time.perf_counter() - t0

        t0 = time.perf_counter()
        ys = fn(stacked, ingests, frames)
        self.stats.dispatches += 1
        self.stats.fused_dispatches += 1
        self._unpack_frames(fn.plan, items, ys, n_tile, Hb, Wb, out)
        self.timings["dispatch_s"] += time.perf_counter() - t0

    def _ship_frames(self, items: List[Tuple[int, _Prepared]], n_tile: int,
                     Hb: int, Wb: int, dtype: torch.dtype) -> torch.Tensor:
        """Embed the raw frames top-left into one pooled zero canvas
        ``[n_tile, Hb, Wb]`` and copy it to the fleet's device (on a CPU
        fleet the canvas itself; outputs never alias it)."""
        canvas = self._canvas((n_tile, Hb, Wb), dtype)
        for i, (_, p) in enumerate(items):
            H, W = p.hw
            canvas[i, :H, :W] = torch.from_numpy(np.ascontiguousarray(p.payload))
        return canvas.to(self.device)

    def _unpack_frames(self, plan: OverlayPlan, items: List[Tuple[int, _Prepared]],
                       ys: torch.Tensor, n_tile: int, Hb: int, Wb: int,
                       out: Dict[int, np.ndarray]) -> None:
        """Stamp a frame dispatch and slice each request's ``[H, W]`` (or
        ``[K, H, W]``) output back to the host."""
        self.stats.stamp_dispatch(plan, f"n{n_tile}x{Hb}x{Wb}")
        self.stats.executed += len(items)
        for i, (ticket, p) in enumerate(items):
            H, W = p.hw
            y = _to_host(ys[i].reshape(-1, Hb, Wb)[:, :H, :W])
            out[ticket] = y[0] if y.shape[0] == 1 else y

    def _dispatch_pipeline(self, plan: OverlayPlan, items: List[Tuple[int, _Prepared]],
                           out: Dict[int, np.ndarray]) -> None:
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
        Hb = pow2_bucket(max(p.hw[0] for _, p in items), self.min_image_side)
        Wb = pow2_bucket(max(p.hw[1] for _, p in items), self.min_image_side)
        self.stats.padded_app_slots += n_tile - n
        self.stats.partial_tile_dispatches += 1 if n < n_tile else 0
        stage_settings = []
        for si in range(specs[0].depth):
            stacked, ingests = self._stacked_bank(
                grid, [s.stages[si].config for s in specs], fused=True)
            out_ch = torch.tensor([s.stages[si].out_channel for s in specs],
                                  dtype=torch.int32).to(self.device)
            stage_settings.append((stacked, ingests, out_ch))
        hw = np.full((n_tile, 2), (Hb, Wb), np.int32)
        for i, (_, p) in enumerate(items):
            hw[i] = p.hw
        hw = torch.from_numpy(hw).to(self.device)
        frames = self._ship_frames(items, n_tile, Hb, Wb, grid.dtype)
        self.timings["pack_s"] += time.perf_counter() - t0

        t0 = time.perf_counter()
        ys = fn(tuple(stage_settings), hw, frames)
        self.stats.dispatches += 1
        self.stats.fused_dispatches += 1
        self.stats.pipeline_dispatches += 1
        self._unpack_frames(fn.plan, items, ys, n_tile, Hb, Wb, out)
        self.timings["dispatch_s"] += time.perf_counter() - t0

    def _dispatch_packed(self, plan: OverlayPlan, items: List[Tuple[int, _Prepared]],
                         out: Dict[int, np.ndarray]) -> None:
        """One unfused dispatch over packed [channels, batch] inputs
        (named-channel requests and image apps without an ingest plan)."""
        t0 = time.perf_counter()
        fn = self.overlay_executable(plan)
        grid = plan.grid
        n = len(items)
        n_tile = round_up(n, self.batch_tile)
        batch = pow2_bucket(max(p.payload.shape[-1] for _, p in items),
                            self.min_pixel_batch)
        configs = [p.cfg for _, p in items]
        xs = pad_batches([p.payload for _, p in items], batch)
        # Tile padding on the app axis: replay config[0] on zero pixels.
        configs += [configs[0]] * (n_tile - n)
        xs += [torch.zeros_like(xs[0])] * (n_tile - n)
        self.stats.padded_app_slots += n_tile - n
        self.stats.partial_tile_dispatches += 1 if n < n_tile else 0
        stacked = self._stacked_bank(grid, configs)
        xstack = torch.stack(xs)
        self.timings["pack_s"] += time.perf_counter() - t0

        t0 = time.perf_counter()
        ys = fn(stacked, xstack)
        self.stats.dispatches += 1
        self.stats.stamp_dispatch(fn.plan, f"n{n_tile}xb{batch}")
        self.stats.executed += n
        for i, (ticket, p) in enumerate(items):
            y = _to_host(ys[i, :, : p.payload.shape[-1]])
            if p.hw is not None:
                H, W = p.hw
                y = y[:, : H * W].reshape((-1, H, W))
                y = y[0] if y.shape[0] == 1 else y
            out[ticket] = y
        self.timings["dispatch_s"] += time.perf_counter() - t0

    def flush(self, limit: Optional[int] = None) -> Dict[int, np.ndarray]:
        """Run pending requests: one dispatch per grid group (two when a
        group mixes fused image requests with packed-channel requests),
        plus one per chain radii group.

        ``limit`` dispatches only the oldest ``limit`` pending requests and
        leaves the rest queued.  ``timings`` gets ``flush_started`` and
        ``flush_s``.  Returns {ticket: output}: image requests as [H, W]
        (or [num_outputs, H, W]), channel requests as [num_outputs, batch],
        all numpy on the host (bf16 grids as exact float32).  A dispatch
        error propagates.
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

        out: Dict[int, np.ndarray] = {}
        t0 = time.perf_counter()
        self.timings["flush_started"] = t0
        for key, items in groups.items():
            if key[1] == "image":
                plan = self.plan_for_dispatch(key[0], fused=True, radius=key[2])
                self._dispatch_fused(plan, items, out)
            elif key[1] == "pipe":
                # The app-tile-padded spec tuple is executable shape, so it
                # is part of the plan.
                specs = [p.spec for _, p in items]
                specs += [specs[0]] * (round_up(len(items), self.batch_tile) - len(items))
                plan = self.plan_for_dispatch(key[0], fused=True, pipeline=tuple(specs))
                self._dispatch_pipeline(plan, items, out)
            else:
                self._dispatch_packed(self.plan_for_dispatch(key[0], fused=False),
                                      items, out)
        self.timings["flush_s"] = time.perf_counter() - t0
        self._results.update(out)
        while len(self._results) > self.max_retained_results:
            self._results.popitem(last=False)
        return out

    def run_many(self, requests: Sequence[FleetRequest]) -> List[np.ndarray]:
        """submit() + flush() convenience; outputs in request order (and
        released from retention)."""
        tickets = [self.submit(r) for r in requests]
        outs = self.flush()
        for t in tickets:
            self.discard(t)
        return [outs[t] for t in tickets]
