"""OverlayPlan: the unified compile/dispatch pipeline for the overlay.

Twin of the reference package's ``core/plan.py`` (the ingest mode
belongs to the fleet, which feeds the dispatch, and is no plan axis here):

  OverlayPlan        a frozen, hashable description of one dispatch: grid
                     structure, fused-vs-channel ingest (+ tap radius),
                     single-vs-batched app axis, execution backend, device
                     placement (a :class:`~repro_torch.parallel.axes.
                     MeshSpec`), the row-tile height and the pipeline axis
                     (a chain of stages per app slot).  It is THE cache
                     key: the fleet's executable LRU and its stats name
                     dispatches by plan.
  compile_plan       plan -> OverlayExecutable.  Looks the executor up in a
                     registry: the eager "torch" cells are registered here
                     (the chain cell specialized per app and stage), the
                     "hopper" kernel cells register themselves from
                     ``repro_torch.kernels.vcgra.ops``.  When the plan asks
                     for a mesh the host can grant, the executor is wrapped
                     to run per shard (``parallel/axes.py``).
  OverlayExecutable  the callable artifact, carrying its plan and its mesh.
  fallback_chain     the self-healing fleet's degradation ladder of a plan.

Device placement: ``MeshSpec(app=k)`` shards the app (N) axis of a batched
plan over k devices -- each tenant's work is independent along N, so the
result is bitwise the single-device one.  ``MeshSpec(app=k, rows=m)``
also shards fused frames into m contiguous pixel-row bands, each band
receiving its neighbours' ``radius`` edge rows (the seam halo) before the
unchanged per-shard executor runs on it; H is padded to whole
radius-floored bands inside the executable and sliced back off.  A host
with fewer devices than the spec degrades to the single-device path
(``OverlayExecutable.mesh`` is then None).  The deprecated bare
device-count kwarg survives as a DeprecationWarning shim meaning
``MeshSpec(app=k)``.

PyTorch runs eagerly, so "compiling" a plan only binds the executor; the
Hopper kernels themselves are built once per process at first launch.
"""

from __future__ import annotations

import dataclasses
import hashlib
import warnings
from functools import partial
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import interpreter
from repro_torch.core.bitstream import VCGRAConfig
from repro_torch.core.grid import GridSpec
from repro_torch.core.specialize import build_specialized_fn, const_value
from repro_torch.core.tiling import check_tile_rows, row_band
from repro_torch.parallel.axes import (
    MeshSpec, build_mesh, shard_apps, shard_apps_rows, shard_pipeline_rows,
)


# -- the pipeline axis ---------------------------------------------------------


def _config_digest(cfg: VCGRAConfig) -> str:
    """Canonical content digest of one stage's settings: grid name,
    opcodes, mux selects, output taps, ingest production rules and const
    coefficients.  sha1 over the reference's bytes in the reference's
    order, so a port key equals the reference key but for the backend."""
    h = hashlib.sha1()
    h.update(cfg.grid_name.encode())
    for ops_lvl in cfg.opcodes:
        h.update(np.asarray(ops_lvl, np.int32).tobytes())
    for sel_lvl in cfg.selects:
        h.update(np.asarray(sel_lvl, np.int32).tobytes())
    h.update(np.asarray(cfg.out_sel, np.int32).tobytes())
    h.update(repr(tuple(cfg.input_order)).encode())
    h.update(
        repr(sorted((str(k), float(v)) for k, v in cfg.const_values.items()))
        .encode()
    )
    ing = cfg.ingest
    if ing is not None:
        h.update(str(int(ing.radius)).encode())
        h.update(np.asarray(ing.tap_sel, np.int32).tobytes())
        h.update(np.asarray(ing.const_vals, np.float64).tobytes())
    return h.hexdigest()


@dataclasses.dataclass(frozen=True, eq=False)
class PipelineStage:
    """One stage of a chain: a mapped app config plus which of its output
    channels feeds the next stage's ingest taps.

    ``config`` must carry an :class:`~repro_torch.core.ingest.IngestPlan`
    (every stage eats a raw frame, the previous stage's intermediate); its
    radius IS the stage's tap radius.  ``out_channel`` on the last stage
    is never read: the chain returns that stage's full ``[K, H*W]``.
    Hash and equality ride a content digest, so stages slot into frozen
    plans without freezing ``VCGRAConfig``."""

    config: VCGRAConfig
    out_channel: int = 0

    def __post_init__(self):
        if self.config.ingest is None:
            raise ValueError(
                f"pipeline stage {self.config.app_name!r} has no ingest "
                "plan (a channel is neither a stencil tap nor a const); "
                "every stage must eat a raw frame"
            )
        object.__setattr__(self, "out_channel", int(self.out_channel))
        if not 0 <= self.out_channel < len(self.config.out_sel):
            raise ValueError(
                f"out_channel={self.out_channel} out of range for "
                f"{self.config.app_name!r} ({len(self.config.out_sel)} "
                "output channels)"
            )
        object.__setattr__(
            self, "_digest",
            hashlib.sha1(
                f"{_config_digest(self.config)}|out{self.out_channel}".encode()
            ).hexdigest(),
        )

    @property
    def digest(self) -> str:
        return self._digest

    @property
    def radius(self) -> int:
        return int(self.config.ingest.radius)

    def at_radius(self, radius: int) -> "PipelineStage":
        """The same stage re-planned against another tap-bank radius
        (:meth:`IngestPlan.at_radius`).  The config's ``cache_key`` gets an
        ``@r{radius}`` suffix so radius-keyed settings banks never alias
        the original."""
        if int(radius) == self.radius:
            return self
        cfg = dataclasses.replace(self.config, ingest=self.config.ingest.at_radius(radius))
        if cfg.cache_key is not None:
            cfg.cache_key = f"{cfg.cache_key}@r{int(radius)}"
        return PipelineStage(cfg, self.out_channel)

    def __hash__(self):
        return hash(self._digest)

    def __eq__(self, other):
        return isinstance(other, PipelineStage) and self._digest == other._digest


@dataclasses.dataclass(frozen=True, eq=False)
class PipelineSpec:
    """A frozen, hashable ordered chain of :class:`PipelineStage`: the
    pipeline axis of ONE app slot.  Stage *i*'s selected output channel
    feeds stage *i+1*'s ingest taps as a raw frame; intermediates never
    leave the device."""

    stages: Tuple[PipelineStage, ...]

    def __post_init__(self):
        stages = tuple(self.stages)
        if not stages:
            raise ValueError("a pipeline needs at least one stage")
        gname = stages[0].config.grid_name
        for s in stages[1:]:
            if s.config.grid_name != gname:
                raise ValueError(
                    "every stage of a pipeline runs on ONE overlay grid "
                    f"(reconfigured between stages): {s.config.grid_name!r} "
                    f"!= {gname!r}"
                )
        object.__setattr__(self, "stages", stages)
        object.__setattr__(self, "_digest", pipeline_digest(stages))

    @property
    def depth(self) -> int:
        return len(self.stages)

    @property
    def radii(self) -> Tuple[int, ...]:
        return tuple(s.radius for s in self.stages)

    @property
    def total_radius(self) -> int:
        """Sum of stage radii: how far one output pixel's provenance
        reaches back through the whole chain (the kernel's halo)."""
        return sum(self.radii)

    @property
    def digest(self) -> str:
        return self._digest

    @staticmethod
    def chain(configs: Sequence[VCGRAConfig],
              out_channels: Optional[Sequence[int]] = None) -> "PipelineSpec":
        """A linear chain from mapped configs (+ optional per-stage
        forwarded output channels, default 0)."""
        cfgs = list(configs)
        chans = list(out_channels) if out_channels is not None else [0] * len(cfgs)
        if len(chans) != len(cfgs):
            raise ValueError(f"{len(chans)} out_channels for {len(cfgs)} stages")
        return PipelineSpec(tuple(PipelineStage(c, ch) for c, ch in zip(cfgs, chans)))

    def __hash__(self):
        return hash(self._digest)

    def __eq__(self, other):
        return isinstance(other, PipelineSpec) and self._digest == other._digest


def pipeline_digest(items: Sequence[Union[PipelineStage, PipelineSpec]]) -> str:
    """sha1 over the digests of ``items`` in order: a spec's digest (over
    its stages) and the ``pipe{...}`` key segment (over a dispatch's
    per-app-slot specs)."""
    h = hashlib.sha1()
    for s in items:
        h.update(s.digest.encode())
    return h.hexdigest()


@dataclasses.dataclass(frozen=True)
class OverlayPlan:
    """A frozen, hashable description of one overlay dispatch.

    * ``grid``       the overlay structure;
    * ``batched``    single app (``[C, batch]`` channels / ``[H, W]``
      frame) vs N stacked tenants (leading app axis on every operand);
    * ``fused``      raw-frame ingest (line buffers formed inside the
      dispatch, tap bank of ``radius``) vs pre-packed channels;
    * ``backend``    "torch" (the eager interpreter, the port's oracle) or
      "hopper" (the hand-written CUDA kernels);
    * ``mesh``       the :class:`MeshSpec` device placement: ``MeshSpec()``
      is one device, ``app`` > 1 shards the app axis (batched plans only),
      ``rows`` > 1 row-bands fused frames with a seam halo exchange
      (batched fused plans only).  The deprecated bare device-count
      kwarg still constructs, with a DeprecationWarning, and means
      ``MeshSpec(app=k)`` -- the same plan, key and cache entry;
    * ``tile_rows``  row tiling of fused dispatches: None, an int or
      ``tiling.TILE_AUTO``.  All values are bitwise-identical; the eager
      twin forms its tap bank per slab, the Hopper kernel's output does
      not depend on it.  Fused plans only;
    * ``pipeline``   one :class:`PipelineSpec` per app slot (all sharing
      depth and per-stage radii, which are executable shape).  A chain
      plan is a batched fused plan whose radius is the largest stage
      radius; depth-1 chains canonicalize to ``pipeline=None`` and the
      stage's radius, so they ARE the single-stage plan (same key, hash
      and cache entry).

    Two dispatches with equal plans share one executable.
    """

    grid: GridSpec
    batched: bool = False
    fused: bool = False
    radius: Optional[int] = None     # tap-bank radius; fused plans only
    backend: str = "torch"
    mesh: MeshSpec = MeshSpec()
    tile_rows: Union[int, str, None] = None  # fused plans only
    pipeline: Optional[Tuple[PipelineSpec, ...]] = None
    #: Deprecated spelling of ``mesh=MeshSpec(app=k)``.  Not a field: it
    #: maps onto ``mesh`` at construction, so both spellings are ONE plan.
    devices: dataclasses.InitVar[Optional[int]] = None

    def __post_init__(self, devices):
        if devices is not None:
            d = int(devices)
            if d < 1:
                raise ValueError(f"devices must be >= 1, got {devices}")
            if self.mesh != MeshSpec():
                raise ValueError(
                    "pass mesh=MeshSpec(...) or the deprecated bare device "
                    "count, not both"
                )
            warnings.warn(
                "the bare device-count kwarg of OverlayPlan is deprecated: "
                f"pass mesh=MeshSpec(app={d}) instead",
                DeprecationWarning,
                stacklevel=3,
            )
            object.__setattr__(self, "mesh", MeshSpec(app=d))
        interpreter.check_backend(self.backend)
        if self.pipeline is not None:
            self._canonicalize_pipeline()
        if self.fused:
            # Canonical key: a fused plan always names its radius.
            object.__setattr__(
                self, "radius", 1 if self.radius is None else int(self.radius)
            )
            if self.radius < 0:
                raise ValueError(f"fused plan needs radius >= 0, got {self.radius}")
        elif self.radius is not None:
            raise ValueError(
                f"radius={self.radius} is meaningless for an unfused plan "
                "(the tap bank only exists on the fused ingest path)"
            )
        if self.tile_rows is not None:
            if not self.fused:
                raise ValueError(
                    f"tile_rows={self.tile_rows!r} is meaningless for an "
                    "unfused plan (pre-packed channels carry no row "
                    "structure to halo-tile)"
                )
            object.__setattr__(self, "tile_rows", check_tile_rows(self.tile_rows))
        if not isinstance(self.mesh, MeshSpec):
            raise ValueError(f"mesh must be a MeshSpec, got {self.mesh!r}")
        if self.mesh.app > 1 and not self.batched:
            raise ValueError(
                "an app-axis mesh width > 1 shards the app (N) axis, which "
                "only batched plans have; set batched=True or app=1"
            )
        if self.mesh.rows > 1 and not (self.batched and self.fused):
            raise ValueError(
                "a rows-axis mesh width > 1 band-shards the pixel rows of "
                "fused frames, which only batched fused plans have (pre-"
                "packed channels carry no row structure); set fused=True "
                "or rows=1"
            )

    def _canonicalize_pipeline(self) -> None:
        specs = tuple(self.pipeline)
        if not specs or not all(isinstance(s, PipelineSpec) for s in specs):
            raise ValueError(
                "pipeline must be a non-empty sequence of PipelineSpec "
                "(one per app slot)"
            )
        ref = specs[0]
        for s in specs[1:]:
            if s.radii != ref.radii:
                raise ValueError(
                    "every app slot of a pipeline dispatch must share "
                    f"the stage structure: radii {s.radii} != {ref.radii} "
                    "(depth and per-stage radii are executable shape)"
                )
        for s in specs:
            for st in s.stages:
                if st.config.grid_name != self.grid.name:
                    raise ValueError(
                        "pipeline stage mapped on grid "
                        f"{st.config.grid_name!r} cannot run on plan "
                        f"grid {self.grid.name!r}"
                    )
        if not self.batched:
            raise ValueError(
                "a pipeline plan is a batched fused dispatch (single "
                "chains run as N=1); set batched=True"
            )
        if self.radius is not None:
            raise ValueError(
                "radius is derived from the pipeline's stages; don't pass both"
            )
        object.__setattr__(self, "fused", True)
        # Depth 1 IS the single-stage batched fused plan; deeper chains
        # name the largest stage radius, their identity rides pipe{...}.
        object.__setattr__(self, "pipeline", specs if ref.depth > 1 else None)
        object.__setattr__(self, "radius", max(ref.radii))

    def key(self) -> str:
        """Compact human-readable identity, in the reference's format with
        the port's backend name, e.g.
        ``sobel-5x9|batched|fused:r1|hopper|dev2|rows2|tile:auto``: the
        device segment names the app-axis width, and the rows segment
        appears only for a 2-D mesh."""
        parts = [
            self.grid.name,
            "batched" if self.batched else "single",
            f"fused:r{self.radius}" if self.fused else "channels",
            self.backend,
            f"dev{self.mesh.app}",
        ]
        if self.pipeline is not None:
            parts.append(f"pipe{pipeline_digest(self.pipeline)[:12]}")
        if self.mesh.rows > 1:
            parts.append(f"rows{self.mesh.rows}")
        if self.tile_rows is not None:
            parts.append(f"tile:{self.tile_rows}")
        return "|".join(parts)


class OverlayExecutable:
    """The executable of one :class:`OverlayPlan`, callable with the
    plan-shaped operands:

      batched=False, fused=False   fn(config_arrays, x)
      batched=False, fused=True    fn(config_arrays, ingest_arrays, image)
      batched=True,  fused=False   fn(stacked_configs, xs)
      batched=True,  fused=True    fn(stacked_configs, stacked_ingests, images)
      pipeline (depth > 1)         fn(stage_settings, hw, images)

    Pipeline operands: ``stage_settings`` is one ``(stacked_configs,
    stacked_ingests, out_ch)`` triple per stage (``out_ch`` int32 [N]);
    ``hw`` is int32 [N, 2] of per-app true ``(rows, cols)`` inside the
    canvas, outside which every intermediate is zeroed.

    ``mesh`` is the :class:`~repro_torch.parallel.axes.Mesh` the dispatch
    is sharded over (1-D for app-only specs, 2-D for row-banded ones), or
    None for the single-device path, including a spec the host could not
    grant.  A mesh executable takes its frames either as one tensor or as
    a :class:`~repro_torch.parallel.axes.ShardedFrames` already split by
    ``parallel.sharding.frame_sharding``, and returns its output on the
    mesh's first device.
    """

    def __init__(self, plan: OverlayPlan, fn: Callable, mesh=None):
        self.plan = plan
        self._fn = fn
        self.mesh = mesh

    def __call__(self, *args):
        return self._fn(*args)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"OverlayExecutable({self.plan.key()})"


def replace_plan(plan: OverlayPlan, **overrides: Any) -> OverlayPlan:
    """``dataclasses.replace`` that is safe for pipeline plans, whose
    ``fused``/``radius`` derive from the stages (passing them back in, as
    a plain ``replace`` does, raises)."""
    if plan.pipeline is not None:
        fields = dict(grid=plan.grid, batched=True, pipeline=plan.pipeline,
                      backend=plan.backend, mesh=plan.mesh, tile_rows=plan.tile_rows)
        fields.update(overrides)
        return OverlayPlan(**fields)
    return dataclasses.replace(plan, **overrides)


def fallback_chain(plan: OverlayPlan) -> Tuple[OverlayPlan, ...]:
    """The graceful-degradation ladder of ``plan``, most- to
    least-capable: each step strips ONE risky axis while keeping the
    request-shaped axes (grid, fusion, radius/pipeline), so any
    step serves the exact same dispatch operands.

      1. ``backend="hopper"`` -> ``"torch"`` (the eager oracle);
      2. 2-D ``MeshSpec(app=a, rows=r)`` -> ``app_only()`` (drop the
         halo-exchanging rows axis);
      3. ``MeshSpec(app=a)`` -> one device;
      4. ``tile_rows`` -> ``None`` (untiled pixel axis).

    Every step is bitwise-equal to the primary
    (the parity the port's tests hold each axis to), so a circuit breaker
    can degrade dispatch by dispatch without changing results, and each
    entry is just another plan-cache key."""
    chain = []
    cur = plan

    def step(**overrides: Any) -> None:
        nonlocal cur
        nxt = replace_plan(cur, **overrides)
        if nxt != cur:
            chain.append(nxt)
            cur = nxt

    if cur.backend != "torch":
        step(backend="torch")
    if cur.mesh.rows > 1:
        step(mesh=cur.mesh.app_only())
    if cur.mesh.app > 1:
        step(mesh=MeshSpec())
    if cur.tile_rows is not None:
        step(tile_rows=None)
    return tuple(chain)


# -- executor registry ---------------------------------------------------------

ExecutorBuilder = Callable[[OverlayPlan], Callable]
_EXECUTOR_BUILDERS: Dict[Tuple[str, bool, bool], ExecutorBuilder] = {}
_PIPELINE_BUILDERS: Dict[str, ExecutorBuilder] = {}
_PIPELINE_STAGE_BUILDERS: Dict[str, ExecutorBuilder] = {}


def register_executor(backend: str, *, batched: bool, fused: bool):
    """Register the executor builder for one (backend, batched, fused)
    cell of the plan matrix.  The builder takes the plan and returns a
    callable with the plan-shaped operands."""

    def deco(builder: ExecutorBuilder) -> ExecutorBuilder:
        _EXECUTOR_BUILDERS[(interpreter.check_backend(backend), batched, fused)] = builder
        return builder

    return deco


def register_pipeline_executor(backend: str):
    """Register the chain executor builder of one backend: it takes a
    depth > 1 pipeline plan and returns ``fn(stage_settings, hw, images)``."""

    def deco(builder: ExecutorBuilder) -> ExecutorBuilder:
        _PIPELINE_BUILDERS[interpreter.check_backend(backend)] = builder
        return builder

    return deco


def register_pipeline_stage(backend: str):
    """Register the per-stage executor builder of one backend's chain on a
    granted mesh: it takes a pipeline plan and returns ``stage_fn(radius,
    configs, ingests, x) -> [N, K, H*W]``, one batched fused step.  On a
    mesh the halo rows of the next stage live on other shards, so the
    chain runs stage by stage (``parallel.axes.shard_pipeline_rows``)
    instead of as one chain executor."""

    def deco(builder: ExecutorBuilder) -> ExecutorBuilder:
        _PIPELINE_STAGE_BUILDERS[interpreter.check_backend(backend)] = builder
        return builder

    return deco


def lift_app_axis(tree):
    """Add a leading N=1 app axis to every tensor of a (nested) tuple:
    the single-app cells ride the batched executors with N=1."""
    if isinstance(tree, tuple):
        return tuple(lift_app_axis(t) for t in tree)
    return tree[None]


@register_executor("torch", batched=False, fused=False)
def _torch_single(plan: OverlayPlan) -> Callable:
    return partial(interpreter.overlay_step, plan.grid)


@register_executor("torch", batched=False, fused=True)
def _torch_single_fused(plan: OverlayPlan) -> Callable:
    if plan.tile_rows is not None:
        batched = partial(
            interpreter.tiled_batched_fused_overlay_step,
            plan.grid, plan.radius, plan.tile_rows,
        )

        def fn(config, ingest, image):
            return batched(lift_app_axis(config), lift_app_axis(ingest), image[None])[0]

        return fn
    return partial(interpreter.fused_overlay_step, plan.grid, plan.radius)


@register_executor("torch", batched=True, fused=False)
def _torch_batched(plan: OverlayPlan) -> Callable:
    return partial(interpreter.batched_overlay_step, plan.grid)


@register_executor("torch", batched=True, fused=True)
def _torch_batched_fused(plan: OverlayPlan) -> Callable:
    if plan.tile_rows is not None:
        return partial(
            interpreter.tiled_batched_fused_overlay_step,
            plan.grid, plan.radius, plan.tile_rows,
        )
    return partial(interpreter.batched_fused_overlay_step, plan.grid, plan.radius)


class _BankChannels:
    """Duck-typed ``[C, pixels]`` channel input for
    :func:`repro_torch.core.specialize.build_specialized_fn`: channels are
    produced lazily from ONE app's tap bank by the stage's *static* ingest
    plan, so only channels the specialized executor fetches are formed --
    dead taps cost nothing, like the dead functional units the specializer
    folds away."""

    def __init__(self, bank: torch.Tensor, ingest, dtype: torch.dtype):
        self._bank = bank            # [T+1, pixels]
        self._ingest = ingest
        self.shape = (int(ingest.tap_sel.shape[0]),) + tuple(bank.shape[1:])
        self.dtype = dtype
        self.device = bank.device

    def __getitem__(self, c: int) -> torch.Tensor:
        t = int(self._ingest.tap_sel[c])
        if t == self._ingest.zero_row:
            # Const (or zero-pad) channel: a 0-d value; the PE ops broadcast
            # it and the specializer's final broadcast widens it.
            return const_value(self._ingest.const_vals[c], self.dtype, self.device)
        return self._bank[t]


@register_pipeline_executor("torch")
def _pipeline_specialized_fn(plan: OverlayPlan) -> Callable:
    """The "torch" chain executor, specialized per (app, stage).

    The plan's :class:`PipelineSpec`s are static, so each (app, stage)
    pair runs through ``specialize.build_specialized_fn``: only the
    configured unit of each live PE, every VC select folded to direct
    wiring -- the reference's single-device XLA chain.  The inter-stage hop
    is a view and a mask; intermediates never leave the device.  Bitwise
    equal to the operand-settings chain that a granted mesh runs
    (``interpreter.pipeline_batched_fused_step`` over
    :func:`_torch_pipeline_stage`): per live PE both compute the same unit
    on the same operands.  The
    executable ignores ``stage_settings`` (its identity lives in the plan)
    and the row tile height."""
    grid = plan.grid
    specs = plan.pipeline
    radii = specs[0].radii
    depth = len(radii)
    stage_fns = [[build_specialized_fn(grid, spec.stages[si].config) for spec in specs]
                 for si in range(depth)]

    def fn(stage_settings, hw, images):
        del stage_settings
        x = images.to(grid.dtype)
        n, H, W = x.shape
        if n != len(specs):
            raise ValueError(
                f"pipeline plan carries {len(specs)} app slots, dispatch has {n} frames")
        valid = interpreter.valid_pixel_mask(hw, H, W)
        ys = None
        for si in range(depth):
            bank = interpreter.form_tap_bank(x, radii[si], grid.dtype)
            ys = torch.stack([
                stage_fns[si][a](_BankChannels(bank[a], specs[a].stages[si].config.ingest,
                                               grid.dtype))
                for a in range(n)
            ])
            del bank
            if si < depth - 1:
                y = torch.stack([ys[a, specs[a].stages[si].out_channel] for a in range(n)])
                x = torch.where(valid, y.reshape(n, H, W), torch.zeros_like(x))
        return ys

    return fn


@register_pipeline_stage("torch")
def _torch_pipeline_stage(plan: OverlayPlan) -> Callable:
    """The "torch" chain's stage on a mesh shard: the eager batched fused
    step, row-tiled when the plan is."""
    if plan.tile_rows is not None:
        def stage(radius, configs, ingests, x):
            return interpreter.tiled_batched_fused_overlay_step(
                plan.grid, radius, plan.tile_rows, configs, ingests, x)

        return stage

    def stage(radius, configs, ingests, x):
        return interpreter.batched_fused_overlay_step(plan.grid, radius, configs, ingests, x)

    return stage


# -- the mesh wrappers ----------------------------------------------------------


def _replay_last(tree, pad: int):
    """Every tensor of a (nested) tuple with its last app slot replayed
    ``pad`` more times along the leading axis."""
    if isinstance(tree, tuple):
        return tuple(_replay_last(t, pad) for t in tree)
    return torch.cat([tree, tree[-1:].expand((pad,) + tuple(tree.shape[1:]))])


def _crop_rows(ys: torch.Tensor, padded_h: int, H: int, W: int) -> torch.Tensor:
    """``[N, K, padded_h * W]`` -> the first ``H`` rows, ``[N, K, H * W]``."""
    n, K = ys.shape[:2]
    return ys.reshape(n, K, padded_h, W)[:, :, :H, :].reshape(n, K, H * W)


def _with_app_padding(fn: Callable, devices: int) -> Callable:
    """Pad the app axis of every operand to a multiple of the mesh width
    by replaying the last app (always a valid config on valid inputs, so
    no DIV by zero), and slice the output back."""

    def padded(*args):
        n = args[-1].shape[0]
        pad = (-n) % devices
        if not pad:
            return fn(*args)
        return fn(*_replay_last(args, pad))[:n]

    return padded


def _with_mesh_padding(fn: Callable, spec: MeshSpec, radius: int) -> Callable:
    """The 2-D twin of :func:`_with_app_padding` for row-banded fused
    dispatch ``fn(configs, ingests, images)`` or chain ``fn(stage_settings,
    hw, images)``: pad the app axis of every operand to a multiple of
    ``spec.app`` (replaying the last app) AND the frames' rows to
    ``row_band(H, rows, radius) * rows`` zero rows, then slice both back
    off the output.  The radius floor of the band keeps every seam exchange
    single-hop; zero pad rows are read only as the bottom border (a chain's
    ``hw`` keeps the true sizes, so its mask zeroes them between stages)
    and their outputs are discarded, so the padding is bitwise exact.
    Sharded frames arrive whole (the fleet rounds its canvas to bands), so
    neither pad applies to them."""
    app, rows = spec.app, spec.rows

    def padded(*args):
        n, H, W = args[-1].shape
        pad_n = (-n) % app
        if pad_n:
            args = _replay_last(args, pad_n)
        band = row_band(H, rows, radius)
        pad_h = band * rows - H
        if pad_h:
            args = (*args[:-1], torch.nn.functional.pad(args[-1], (0, 0, 0, pad_h)))
        ys = fn(*args)
        if pad_h:
            ys = _crop_rows(ys, band * rows, H, W)
        return ys[:n] if pad_n else ys

    return padded


def _compile_pipeline(plan: OverlayPlan, mesh) -> OverlayExecutable:
    """A depth > 1 chain as ONE executable ``fn(stage_settings, hw,
    images)``.  On one device: the backend's chain executor (B3 on
    ``hopper``, the specialized eager chain on ``torch``).  On a granted
    mesh: the operand-settings chain, one batched fused step per stage on
    each shard (B1 on ``hopper``), app-sharded or row-banded with a halo
    exchange per stage.  Every path is bitwise equal to the staged
    oracle."""
    if mesh is None:
        return OverlayExecutable(plan, _PIPELINE_BUILDERS[plan.backend](plan))
    radii = plan.pipeline[0].radii
    stage_fn = _PIPELINE_STAGE_BUILDERS[plan.backend](plan)
    if plan.mesh.rows > 1:
        fn = _with_mesh_padding(shard_pipeline_rows(stage_fn, mesh, radii), plan.mesh, plan.radius)
    else:
        chain = partial(interpreter.pipeline_batched_fused_step, plan.grid, radii, stage_fn)
        fn = _with_app_padding(shard_apps(chain, mesh, 3), plan.mesh.app)
    return OverlayExecutable(plan, fn, mesh=mesh)


def compile_plan(plan: OverlayPlan, kind: str = "cuda") -> OverlayExecutable:
    """THE overlay entry point: plan -> executable.  Importing the kernel
    package (for ``backend="hopper"``) registers its cells; the CUDA
    library itself is built at the first launch, never on import.

    A plan whose mesh asks for more than one device is realized against
    the local devices of ``kind`` (``parallel.axes.build_mesh``; the fleet
    passes its own device's type): granted, the executor is wrapped to run
    per shard -- app-sharded (``shard_apps``) or app x row-band sharded
    with a seam halo exchange (``shard_apps_rows``); not granted, the
    single-device executor serves, bitwise the same."""
    if plan.backend == "hopper":
        import repro_torch.kernels.vcgra.ops  # noqa: F401

    mesh = build_mesh(plan.mesh, kind)
    if plan.pipeline is not None:
        return _compile_pipeline(plan, mesh)
    builder = _EXECUTOR_BUILDERS.get((plan.backend, plan.batched, plan.fused))
    if builder is None:  # pragma: no cover - registry covers the full matrix
        raise ValueError(f"no executor registered for plan {plan.key()}")
    fn = builder(plan)
    if mesh is not None and plan.mesh.rows > 1:
        fn = _with_mesh_padding(shard_apps_rows(fn, mesh, plan.radius), plan.mesh, plan.radius)
    elif mesh is not None:
        fn = _with_app_padding(shard_apps(fn, mesh, 3 if plan.fused else 2), plan.mesh.app)
    return OverlayExecutable(plan, fn, mesh=mesh)
