"""Operand shardings over the overlay mesh.

Twin of the reference package's ``parallel/sharding.py``, for now only
its overlay part, :func:`frame_sharding`: which device holds which
``(app, row-band)`` block of a fused dispatch's frame canvas.  The fleet's
sharded async ship path reads it.  The LM's ``ShardingPlan``,
``make_plan`` and ``choose_attn_mode`` (tensor parallelism, ZeRO-1,
FSDP over ``torch.distributed``) come with the LM mesh, ROADMAP Queue A
item 6b.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence, Tuple

import torch

from repro_torch.parallel.axes import Mesh, ShardedFrames


@dataclasses.dataclass(frozen=True)
class Block:
    """One block of a sharded canvas: app shard ``i``'s row band ``j``,
    the canvas slices it covers and the device that holds it."""

    i: int
    j: int
    device: torch.device
    apps: slice
    rows: slice


@dataclasses.dataclass(frozen=True)
class FrameSharding:
    """The layout of a fused canvas ``[N, H, W]`` on a mesh: app-sharded
    on a 1-D ``("app",)`` mesh, app x row-band sharded on a 2-D
    ``("app", "rows")`` mesh -- the split the mesh executables make, so a
    canvas shipped block by block reaches them with no further copy."""

    mesh: Mesh

    def blocks(self, n: int, H: int) -> Iterator[Block]:
        """The blocks of an ``[n, H, W]`` canvas, app-major.  ``n`` must be
        a multiple of the app width and ``H`` of the row width."""
        app, rows = self.mesh.app, self.mesh.rows
        if n % app or H % rows:
            raise ValueError(f"a [{n}, {H}, W] canvas does not split over a {app}x{rows} mesh")
        chunk, band = n // app, H // rows
        for i, row in enumerate(self.mesh.devices):
            for j, d in enumerate(row):
                yield Block(i, j, d, slice(i * chunk, (i + 1) * chunk),
                            slice(j * band, (j + 1) * band))

    def assemble(self, shape: Tuple[int, int, int],
                 tensors: Sequence[torch.Tensor]) -> ShardedFrames:
        """The canvas from its block tensors, given in :meth:`blocks` order."""
        rows = self.mesh.rows
        grid = tuple(tuple(tensors[i * rows:(i + 1) * rows]) for i in range(self.mesh.app))
        return ShardedFrames(grid, tuple(shape))


def frame_sharding(mesh: Mesh) -> FrameSharding:
    """The :class:`FrameSharding` of a fused dispatch's frame operand on
    ``mesh`` (``parallel.axes.build_mesh``)."""
    return FrameSharding(mesh)
