"""Shared padding/bucketing primitives for overlay dispatch tiling.

Twin of the reference package's ``core/tiling.py``.  The plan layer, the
fleet scheduler and the interpreter round to the same tiles from this one
module, so "one executable per padded tile shape" has a single source of
truth.  All padding here is *exact*: padded channels are never referenced
by mux selects, padded pixels are sliced off, and padded app slots replay
an already-valid config whose outputs are discarded.

The row-tile height (``tile_rows``) is a plan axis.  The eager tiled twin
forms its tap bank per ``[tile_rows + 2r, W]`` slab; the Hopper kernel
reads every tap straight from the canvas, so its output (and launch) does
not depend on the tile height.  The budget heuristic below keeps the
reference's constants so ``TILE_AUTO`` resolves to the same heights as
the reference's eager path.
"""

from __future__ import annotations

from typing import List, Sequence, Union

import torch
import torch.nn.functional as F

#: Working-set budget of the reference's row-tile heuristic (bytes).
DEFAULT_VMEM_BUDGET_BYTES = 8 * 1024 * 1024

#: Sentinel ``OverlayPlan.tile_rows`` value: resolve the row-tile height
#: from the budget heuristic per frame shape.
TILE_AUTO = "auto"


def check_tile_rows(tile_rows: Union[int, str, None]) -> Union[int, str, None]:
    """Validate (and canonicalize) a ``tile_rows`` axis value -- ``None``
    (untiled), :data:`TILE_AUTO`, or an int >= 1.  Shared by the plan and
    the fleet so a misconfigured service fails at construction."""
    if tile_rows is None or tile_rows == TILE_AUTO:
        return tile_rows
    try:
        tr = int(tile_rows)
    except (TypeError, ValueError):
        raise ValueError(
            f"tile_rows must be None, {TILE_AUTO!r} or an int >= 1, "
            f"got {tile_rows!r}"
        ) from None
    if tr < 1:
        raise ValueError(f"tile_rows must be >= 1 or {TILE_AUTO!r}, got {tr}")
    return tr


def itemsize(dtype: torch.dtype) -> int:
    """Bytes per element of a torch dtype."""
    return torch.empty((), dtype=dtype).element_size()


def slab_rows_per_budget(
    W: int,
    radius: int,
    *,
    num_inputs: int,
    max_level_width: int,
    itemsize: int,
    budget_bytes: int = DEFAULT_VMEM_BUDGET_BYTES,
) -> int:
    """How many *output* rows of a fused row-tile fit the budget: the tap
    bank (``(2r+1)^2 + 1`` rows), the memory-VC channels and the widest PE
    level, each ``tile_rows * W`` elements, plus two haloed input slabs."""
    taps = (2 * radius + 1) ** 2 + 1
    width = max(W, 1)
    per_row = (taps + num_inputs + max_level_width + 2) * width * itemsize
    budget = int(budget_bytes) - 2 * (2 * radius) * width * itemsize
    return max(1, budget // per_row)


def resolve_tile_rows(
    tile_rows: Union[int, str, None],
    H: int,
    W: int,
    radius: int,
    grid,
    budget_bytes: int = DEFAULT_VMEM_BUDGET_BYTES,
) -> int:
    """Resolve a plan's ``tile_rows`` axis against one frame shape:
    ``None`` is untiled, :data:`TILE_AUTO` asks the budget heuristic, an
    int is taken verbatim; the result is clamped to ``[1, H]``."""
    if tile_rows is None:
        return max(int(H), 1)
    if tile_rows == TILE_AUTO:
        picked = slab_rows_per_budget(
            W, radius,
            num_inputs=grid.num_inputs,
            max_level_width=max(grid.pes_per_level),
            itemsize=itemsize(grid.dtype),
            budget_bytes=budget_bytes,
        )
        return max(1, min(picked, int(H)))
    return max(1, min(int(tile_rows), int(H)))


def num_row_tiles(H: int, tile_rows: int) -> int:
    """Row-tile count for one frame: ``ceil(H / tile_rows)``."""
    return -(-int(H) // int(tile_rows))


def halo_row_slabs(images: torch.Tensor, tile_rows: int, radius: int) -> torch.Tensor:
    """Overlapping row slabs for the eager tiled twin:
    ``[N, H, W] -> [N, T, tile_rows + 2*radius, W]``.

    Rows are zero-padded by ``radius`` top and bottom plus the ragged-tile
    remainder; each slab's first and last ``radius`` rows are the halo --
    real neighbour rows mid-frame, zeros at the frame border, exactly
    ``form_tap_bank``'s border."""
    n, H, W = images.shape
    r = int(radius)
    tr = int(tile_rows)
    T = num_row_tiles(H, tr)
    padded = F.pad(images, (0, 0, r, T * tr - H + r))
    if T == 1:
        return padded[:, None]
    return torch.stack(
        [padded[:, t * tr: t * tr + tr + 2 * r] for t in range(T)], dim=1
    )


def row_band(H: int, rows: int, radius: int = 0) -> int:
    """Rows per shard band of a 2-D ``(app, rows)`` mesh: ``ceil(H / rows)``,
    floored at ``radius`` (and 1).

    The floor keeps the seam halo exchange single-hop: a band's taps reach
    at most ``radius`` rows past it, and
    :func:`repro_torch.parallel.axes.halo_exchange_rows` fetches exactly
    the neighbour band's ``radius`` edge rows, so no band needs rows from
    two bands away.  Frames are padded to ``row_band(...) * rows`` rows
    (``plan._with_mesh_padding``); the zero pad rows are read only as the
    bottom border and their outputs are sliced off."""
    return max(-(-int(H) // int(rows)), int(radius), 1)


def round_up(n: int, tile: int) -> int:
    """Smallest multiple of ``tile`` that is >= ``n``."""
    return ((n + tile - 1) // tile) * tile


def pow2_bucket(n: int, floor: int) -> int:
    """Smallest power-of-two multiple of ``floor`` that is >= ``n``
    (``floor`` itself for small ``n``) -- the fleet's pixel/canvas bucket
    rule, bounding distinct dispatch shapes to O(log max_size)."""
    b = max(floor, 1)
    while b < n:
        b *= 2
    return b


def pad_channels(x: torch.Tensor, num_inputs: int) -> torch.Tensor:
    """Zero-pad the channel axis of ``x: [k, batch]`` up to the grid's
    memory-VC width.  Mux selects never reference the padded rows, so
    batching apps with different input counts on one grid stays exact."""
    k = x.shape[0]
    if k > num_inputs:
        raise ValueError(f"app uses {k} input channels, grid has {num_inputs}")
    if k == num_inputs:
        return x
    return torch.cat([x, x.new_zeros((num_inputs - k,) + tuple(x.shape[1:]))], dim=0)


def pad_batches(xs: Sequence[torch.Tensor], pad_to: int) -> List[torch.Tensor]:
    """Zero-pad every ``[channels, batch]`` input to ``pad_to`` columns."""
    return [
        F.pad(x, (0, pad_to - x.shape[-1])) if x.shape[-1] < pad_to else x
        for x in xs
    ]
