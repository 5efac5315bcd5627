"""Conventional VCGRA execution: the eager overlay interpreter.

Twin of the reference package's ``core/interpreter.py`` and the port's
oracle (``backend="torch"``): a generic datapath whose settings (PE
opcodes, VC mux selects, ingest tap selects) are runtime tensors, so any
application mapped on a grid runs by swapping settings.  Every PE computes
its unit through ``ops.apply_generic`` and every VC is a gather over the
predecessor level, like the settings-register-driven hardware.

PyTorch runs eagerly, so there is nothing to compile; the functions here
take tensors on any device and keep the reference's layouts
(``[num_inputs, batch]`` channels, ``[N, ...]`` stacks) so the tests
compare like with like.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import ops as pe_ops
from repro_torch.core.bitstream import VCGRAConfig
from repro_torch.core.grid import GridSpec
from repro_torch.core.ingest import tap_offsets
from repro_torch.core.tiling import (
    halo_row_slabs,
    num_row_tiles,
    pad_batches,
    resolve_tile_rows,
)

ConfigArrays = Tuple[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...], torch.Tensor]
IngestArrays = Tuple[torch.Tensor, torch.Tensor]  # (tap_sel, const_vals)

#: Execution backends for the overlay executors.  "torch" is this eager
#: interpreter (the port's oracle, twin of the reference's "xla"); "hopper"
#: routes the same stacked settings through the hand-written CUDA kernels
#: (``repro_torch.kernels.vcgra``), twin of the reference's "pallas".
BACKENDS = ("torch", "hopper")


def check_backend(backend: str) -> str:
    """Validate (and return) a backend name; shared by every layer that
    takes the backend axis (plan, fleet, front-end)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    return backend


def check_device(device="cuda") -> torch.device:
    """Resolve the device an entry point runs on.  A CUDA device that the
    process cannot see raises: the port never carries on silently on the
    CPU -- pass ``device="cpu"`` to ask for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    return dev


def pack_inputs(
    config: VCGRAConfig,
    inputs: Dict[str, object],
    dtype: torch.dtype,
    batch_shape: Optional[Tuple[int, ...]] = None,
    device=None,
) -> torch.Tensor:
    """Order named inputs into the memory-interface channel layout
    ``[num_inputs, batch]``; missing names fall back to const defaults.

    When *every* channel is const-valued the batch shape cannot be
    inferred from the inputs -- pass ``batch_shape`` explicitly."""
    cols = []
    for name in config.input_order:
        if name in inputs:
            v = torch.as_tensor(inputs[name], device=device).to(dtype)
            if batch_shape is None:
                batch_shape = tuple(v.shape)
            cols.append(v)
        elif name in config.const_values:
            cols.append(None)  # fill after batch shape known
        else:
            raise KeyError(f"missing input {name!r}")
    if batch_shape is None:
        raise ValueError(
            f"every channel of {config.app_name!r} is const-valued, so the "
            "pixel batch shape cannot be inferred; pass batch_shape= "
            "explicitly (e.g. batch_shape=(n,))"
        )
    cols = [
        torch.full(batch_shape, config.const_values[name], dtype=torch.float64,
                   device=device).to(dtype)
        if c is None
        else torch.broadcast_to(c, batch_shape)
        for c, name in zip(cols, config.input_order)
    ]
    return torch.stack(cols, dim=0)


def overlay_step(
    grid: GridSpec, config: ConfigArrays, x: torch.Tensor
) -> torch.Tensor:
    """One full pass of the batch through the PE-level pipeline.
    ``x``: [num_inputs, batch] -> [num_outputs, batch]."""
    opcodes, selects, out_sel = config
    if len(opcodes) != grid.num_levels:
        raise ValueError(f"{len(opcodes)} opcode levels for a {grid.num_levels}-level grid")
    for lvl in range(grid.num_levels):
        a = x.index_select(0, selects[lvl][:, 0])
        b = x.index_select(0, selects[lvl][:, 1])
        x = pe_ops.apply_generic(opcodes[lvl], a, b)
    return x.index_select(0, out_sel)


def stack_for_dispatch(configs, xs, batch_pad=None):
    """Pad-and-stack step of a multi-tenant dispatch (``Pixie.run_many``):
    zero-pad ragged pixel batches to one length, stack configs and inputs
    along the app axis (on the inputs' device).

    Returns ``(stacked_configs, xstack, batches)`` where ``batches`` are
    the original per-app batch lengths for slicing the outputs back."""
    batches = [x.shape[-1] for x in xs]
    pad_to = batch_pad if batch_pad is not None else max(batches)
    if pad_to < max(batches):
        raise ValueError(f"batch_pad={pad_to} < largest request {max(batches)}")
    stacked = VCGRAConfig.stack(configs, device=xs[0].device)
    return stacked, torch.stack(pad_batches(xs, pad_to)), batches


def _flat_gather(x: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """Per-app row gather ``x[i, sel[i, j]]`` as ONE plain gather over the
    flat ``[N*rows, ...]`` bank: each app's selects are offset by its own
    row block (the reference's flat-bank offset trick)."""
    n, rows = x.shape[:2]
    flat = x.reshape((n * rows,) + tuple(x.shape[2:]))
    offs = torch.arange(n, dtype=sel.dtype, device=sel.device)[:, None] * rows
    g = flat.index_select(0, (sel + offs).reshape(-1))
    return g.reshape((n, -1) + tuple(x.shape[2:]))


def batched_overlay_step(
    grid: GridSpec, configs: ConfigArrays, xs: torch.Tensor
) -> torch.Tensor:
    """N applications through one overlay in a single pass.

    ``configs``: stacked settings (``VCGRAConfig.stack``) with a leading
    app axis N; ``xs``: [N, num_inputs, batch] -> [N, num_outputs, batch].
    """
    opcodes, selects, out_sel = configs
    if len(opcodes) != grid.num_levels:
        raise ValueError(f"{len(opcodes)} opcode levels for a {grid.num_levels}-level grid")
    x = xs
    for lvl in range(grid.num_levels):
        a = _flat_gather(x, selects[lvl][:, :, 0])
        b = _flat_gather(x, selects[lvl][:, :, 1])
        del x
        x = pe_ops.apply_generic(opcodes[lvl], a, b)
        del a, b
    return _flat_gather(x, out_sel)


# -- fused ingest (line buffers inside the dispatch) ---------------------------


def form_tap_bank(images: torch.Tensor, radius: int, dtype: torch.dtype) -> torch.Tensor:
    """Line-buffer formation: raw frames -> the stencil tap bank.

    ``images``: [N, H, W] -> bank [N, T+1, H*W] where row ``t`` holds tap
    ``tap_offsets(radius)[t]`` (zero-padded shift, exactly
    ``applications.stencil_inputs``) and the trailing row is zeros (the
    const/padding producer)."""
    imgs = images.to(dtype)
    n, H, W = imgs.shape
    r = radius
    padded = F.pad(imgs, (r, r, r, r))
    rows = [
        padded[:, r + dj: r + dj + H, r + di: r + di + W].reshape(n, H * W)
        for dj, di in tap_offsets(radius)
    ]
    rows.append(imgs.new_zeros((n, H * W)))
    return torch.stack(rows, dim=1)


def form_tap_bank_slab(slabs: torch.Tensor, radius: int, dtype: torch.dtype) -> torch.Tensor:
    """Line-buffer formation for one row tile: a row-haloed slab
    ``[N, tile_rows + 2*radius, W]`` -> bank [N, T+1, tile_rows*W].  Rows
    are only *column*-padded here because the row halo travels with the
    slab; every bank row is bitwise the ``form_tap_bank`` row restricted
    to the tile's pixels."""
    s = slabs.to(dtype)
    n, S, W = s.shape
    r = radius
    tr = S - 2 * r
    padded = F.pad(s, (r, r))
    rows = [
        padded[:, r + dj: r + dj + tr, r + di: r + di + W].reshape(n, tr * W)
        for dj, di in tap_offsets(radius)
    ]
    rows.append(s.new_zeros((n, tr * W)))
    return torch.stack(rows, dim=1)


def apply_ingest(bank: torch.Tensor, ingest: IngestArrays) -> torch.Tensor:
    """Produce the memory-VC channels of ONE app from its tap bank
    ``[T+1, pixels]``; channels selecting the zero row take their const
    value verbatim (0 for grid-padding channels)."""
    tap_sel, const_vals = ingest
    zero_row = bank.shape[0] - 1
    gathered = bank.index_select(0, tap_sel)
    return torch.where((tap_sel == zero_row)[:, None], const_vals[:, None], gathered)


def fused_overlay_step(
    grid: GridSpec, radius: int, config: ConfigArrays,
    ingest: IngestArrays, image: torch.Tensor,
) -> torch.Tensor:
    """pack + dispatch fused: one raw [H, W] frame -> [num_outputs, H*W]."""
    bank = form_tap_bank(image[None], radius, grid.dtype)[0]
    x = apply_ingest(bank, ingest)
    del bank
    return overlay_step(grid, config, x)


def select_channels_batched(bank: torch.Tensor, ingests: IngestArrays) -> torch.Tensor:
    """Produce every app's memory-VC channels from a batched tap bank
    [N, T+1, pixels] -- the flat-bank offset gather shared by the untiled
    and row-tiled fused executors."""
    tap_sel, const_vals = ingests
    t1 = bank.shape[1]
    gathered = _flat_gather(bank, tap_sel)
    return torch.where((tap_sel == t1 - 1)[..., None], const_vals[..., None], gathered)


def batched_fused_overlay_step(
    grid: GridSpec, radius: int, configs: ConfigArrays,
    ingests: IngestArrays, images: torch.Tensor,
) -> torch.Tensor:
    """N apps on N raw frames in one pass, line buffers included.
    ``images``: [N, H, W] -> [N, num_outputs, H*W]."""
    bank = form_tap_bank(images, radius, grid.dtype)
    x = select_channels_batched(bank, ingests)
    del bank
    return batched_overlay_step(grid, configs, x)


def tiled_batched_fused_overlay_step(
    grid: GridSpec, radius: int, tile_rows, configs: ConfigArrays,
    ingests: IngestArrays, images: torch.Tensor,
) -> torch.Tensor:
    """Row-tiled twin of :func:`batched_fused_overlay_step`: bitwise-equal
    outputs with the tap bank formed per ``[tile_rows + 2*radius, W]``
    slab.  The T row tiles ride the app axis (every operand repeated T
    times); the frame's row axis is zero-padded up to ``T * tile_rows``
    and the padded output rows are sliced back off, so any ``tile_rows``,
    including ones that do not divide H, is exact."""
    imgs = images.to(grid.dtype)
    n, H, W = imgs.shape
    r = radius
    tr = resolve_tile_rows(tile_rows, H, W, r, grid)
    if tr >= H:
        return batched_fused_overlay_step(grid, radius, configs, ingests, imgs)
    T = num_row_tiles(H, tr)
    slabs = halo_row_slabs(imgs, tr, r).reshape(n * T, tr + 2 * r, W)
    bank = form_tap_bank_slab(slabs, radius, grid.dtype)   # [N*T, taps+1, tr*W]

    def rep(t: torch.Tensor) -> torch.Tensor:
        return t.repeat_interleave(T, dim=0)

    opcodes, selects, out_sel = configs
    xs = select_channels_batched(bank, tuple(rep(t) for t in ingests))
    del bank
    ys = batched_overlay_step(
        grid,
        (tuple(rep(o) for o in opcodes), tuple(rep(s) for s in selects), rep(out_sel)),
        xs,
    )
    # [N*T, K, tr*W] -> per-app tile concat along the pixel axis (row-major
    # flattening makes each tile's pixels contiguous), minus the pad rows.
    y = ys.reshape(n, T, -1, tr * W).transpose(1, 2).reshape(n, -1, T * tr * W)
    return y[:, :, : H * W]


# -- pipeline chains (stage i's output feeds stage i+1's taps) -----------------


def valid_pixel_mask(hw: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """``[N, H, W]`` bool mask of each app's true frame region inside a
    padded canvas: ``hw`` is int32 ``[N, 2]`` of per-app ``(rows, cols)``.

    The chain executors zero everything outside it between stages: a
    stage's output on canvas padding is not zero (its taps read real frame
    pixels), but the next stage's border must read zeros, exactly what the
    staged oracle sees when each intermediate is re-embedded into a fresh
    zero canvas."""
    hw = hw.to(torch.int32)
    rows = torch.arange(H, dtype=torch.int32, device=hw.device)
    cols = torch.arange(W, dtype=torch.int32, device=hw.device)
    rows_in = rows[None, :, None] < hw[:, 0][:, None, None]
    cols_in = cols[None, None, :] < hw[:, 1][:, None, None]
    return rows_in & cols_in


def forward_stage_output(ys: torch.Tensor, out_ch: torch.Tensor,
                         valid: torch.Tensor) -> torch.Tensor:
    """Select each app's forwarded output channel from a stage's
    ``[N, K, H*W]`` result (``ys[i, out_ch[i]]``) and zero it outside the
    app's true frame region: the inter-stage hop of the chain.  ``out_ch``
    is int32 ``[N]``; ``valid`` is :func:`valid_pixel_mask`'s ``[N, H, W]``."""
    n, H, W = valid.shape
    idx = out_ch.to(torch.int64)[:, None, None].expand(n, 1, ys.shape[-1])
    y = torch.gather(ys, 1, idx)[:, 0].reshape(n, H, W)
    return torch.where(valid, y, torch.zeros_like(y))


def pipeline_batched_fused_step(
    grid: GridSpec, radii, stage_fn, stage_settings, hw, images,
) -> torch.Tensor:
    """Operand-settings pipeline chain: N per-app stage chains on N raw
    frames, every intermediate a device-resident ``[N, H, W]`` frame.

    ``radii`` are the per-stage tap radii; ``stage_settings`` is one
    ``(stacked_configs, stacked_ingests, out_ch)`` triple per stage, each
    tensor with the leading app axis N.  ``stage_fn(radius, configs,
    ingests, x)`` runs one stage (the plan supplies the batched fused step,
    tiled or not); the last stage returns its full ``[N, K, H*W]`` output
    and its ``out_ch`` entry is never read."""
    x = images.to(grid.dtype)
    n, H, W = x.shape
    valid = valid_pixel_mask(hw, H, W)
    ys = None
    for si, r in enumerate(radii):
        configs, ingests, out_ch = stage_settings[si]
        ys = stage_fn(r, configs, ingests, x)
        if si < len(radii) - 1:
            x = forward_stage_output(ys, out_ch, valid)
    return ys
