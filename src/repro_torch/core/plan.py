"""OverlayPlan: the unified compile/dispatch pipeline for the overlay.

Twin of the reference package's ``core/plan.py`` (single device, sync
ingest, no pipeline axis yet):

  OverlayPlan        a frozen, hashable description of one dispatch: grid
                     structure, fused-vs-channel ingest (+ tap radius),
                     single-vs-batched app axis, execution backend and the
                     row-tile height.  It is THE cache key: the fleet's
                     executable LRU and its stats name dispatches by plan.
  compile_plan       plan -> OverlayExecutable.  Looks the executor up in a
                     registry: the eager "torch" cells are registered here,
                     the "hopper" kernel cells register themselves from
                     ``repro_torch.kernels.vcgra.ops``.
  OverlayExecutable  the callable artifact, carrying its plan.

PyTorch runs eagerly, so "compiling" a plan only binds the executor; the
Hopper kernels themselves are built once per process at first launch.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Dict, Optional, Tuple, Union

from repro_torch.core import interpreter
from repro_torch.core.grid import GridSpec
from repro_torch.core.tiling import check_tile_rows


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
    * ``tile_rows``  row tiling of fused dispatches: None, an int or
      ``tiling.TILE_AUTO``.  All values are bitwise-identical; the eager
      twin forms its tap bank per slab, the Hopper kernel's output does
      not depend on it.  Fused plans only.

    Two dispatches with equal plans share one executable.
    """

    grid: GridSpec
    batched: bool = False
    fused: bool = False
    radius: Optional[int] = None     # tap-bank radius; fused plans only
    backend: str = "torch"
    tile_rows: Union[int, str, None] = None  # fused plans only

    def __post_init__(self):
        interpreter.check_backend(self.backend)
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

    def key(self) -> str:
        """Compact human-readable identity, in the reference's format with
        the port's backend name, e.g.
        ``sobel-5x9|batched|fused:r1|hopper|dev1|tile:auto``.  The port
        runs on one device, so the device segment is always ``dev1``."""
        parts = [
            self.grid.name,
            "batched" if self.batched else "single",
            f"fused:r{self.radius}" if self.fused else "channels",
            self.backend,
            "dev1",
        ]
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
    """

    def __init__(self, plan: OverlayPlan, fn: Callable):
        self.plan = plan
        self._fn = fn

    def __call__(self, *args):
        return self._fn(*args)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"OverlayExecutable({self.plan.key()})"


# -- executor registry ---------------------------------------------------------

ExecutorBuilder = Callable[[OverlayPlan], Callable]
_EXECUTOR_BUILDERS: Dict[Tuple[str, bool, bool], ExecutorBuilder] = {}


def register_executor(backend: str, *, batched: bool, fused: bool):
    """Register the executor builder for one (backend, batched, fused)
    cell of the plan matrix.  The builder takes the plan and returns a
    callable with the plan-shaped operands."""

    def deco(builder: ExecutorBuilder) -> ExecutorBuilder:
        _EXECUTOR_BUILDERS[(interpreter.check_backend(backend), batched, fused)] = builder
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


def compile_plan(plan: OverlayPlan) -> OverlayExecutable:
    """THE overlay entry point: plan -> executable.  Importing the kernel
    package (for ``backend="hopper"``) registers its cells; the CUDA
    library itself is built at the first launch, never on import."""
    if plan.backend == "hopper":
        import repro_torch.kernels.vcgra.ops  # noqa: F401

    builder = _EXECUTOR_BUILDERS.get((plan.backend, plan.batched, plan.fused))
    if builder is None:  # pragma: no cover - registry covers the full matrix
        raise ValueError(f"no executor registered for plan {plan.key()}")
    return OverlayExecutable(plan, builder(plan))

