"""Wrappers of the Hopper VCGRA kernels, their plan-registry cells and the
single-app entry points ``vcgra_apply`` / ``vcgra_apply_image``.

The kernels:

* ``vcgra_fused_batched`` (B1), ``vcgra_batched`` (B2) and
  ``vcgra_conventional`` (B4), in ``csrc/vcgra.cu``: settings as runtime
  data, one executable for every app mapped on a grid;
* ``vcgra_pipeline_batched`` (B3), in ``csrc/vcgra_pipeline.cu``;
* ``vcgra_specialized`` (B5): one kernel generated per app and compiled
  with NVRTC at load (``specialized.py``, ``csrc/vcgra_specialize.cu``).

Each wrapper checks its operands, allocates the output and launches its
CUDA kernel on PyTorch's current stream, and keeps a launch count in
:data:`LAUNCHES`, raised where (and only where) it launches, so a run can
show that its path went through the kernels.  A wrapper given CPU tensors
computes its plain PyTorch version (``ref.py``) instead -- that is the only
fallback: for CUDA tensors it launches the kernel or raises.

The module registers the ``backend="hopper"`` cells of the plan matrix:
(batched, fused) runs B1, (batched, unfused) runs B2, the single-app cells
ride them with N=1 (as the reference's Pallas cells do), and depth > 1
pipeline plans run B3.  ``vcgra_apply`` runs one app over channel-major
``[C, N]`` through B5 (``mode="specialized"``) or B4
(``mode="conventional"``).
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import applications as apps
from repro_torch.core.bitstream import VCGRAConfig
from repro_torch.core.grid import GridSpec
from repro_torch.core.ingest import IngestPlan
from repro_torch.core.interpreter import apply_ingest, check_device, form_tap_bank, pack_inputs
from repro_torch.core.plan import (
    OverlayPlan, lift_app_axis, register_executor, register_pipeline_executor,
)
from repro_torch.core.tiling import check_tile_rows, pad_channels, resolve_tile_rows
from repro_torch.kernels.build import load_library
from repro_torch.kernels.vcgra import ref
from repro_torch.kernels.vcgra.specialized import THREADS, SpecializedKernel

#: Launches of each kernel since the last :func:`reset_launch_counts`.
LAUNCHES: Dict[str, int] = {
    "vcgra_fused_batched": 0, "vcgra_batched": 0, "vcgra_pipeline_batched": 0,
    "vcgra_conventional": 0, "vcgra_specialized": 0,
}

_DTYPE_CODES = {torch.int32: 0, torch.int16: 1, torch.float32: 2, torch.bfloat16: 3}

#: Grid-axis limit of the launch: the app axis rides ``gridDim.y``.
_MAX_APPS = 65535

#: ``block_n`` of the single-app kernels (B4, B5) is a positive multiple of
#: this, as the reference's lane-aligned blocks are.
LANE = 128
#: Default ``block_n`` of the single-app kernels (B4, B5).
BLOCK_N = 1024


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def pack_settings_batched(grid: GridSpec, stacked_configs):
    """Stacked settings (``VCGRAConfig.stack``: per-level tuples of
    [N, w] / [N, w, 2] plus out_sel [N, K]) -> the dense rectangular banks
    the kernels stage in shared memory:
    ``(ops int32 [N, L, max_w], sel int32 [N, L, max_w, 2], out int32 [N, K])``.
    Pad slots hold Op.NONE / select 0 and are never read (the kernels loop
    the grid's true per-level widths)."""
    opcodes, selects, out_sel = stacked_configs
    max_w = max(grid.pes_per_level)
    ops_d = torch.stack(
        [F.pad(o.to(torch.int32), (0, max_w - o.shape[1])) for o in opcodes], dim=1
    )
    sel_d = torch.stack(
        [F.pad(s.to(torch.int32), (0, 0, 0, max_w - s.shape[1])) for s in selects],
        dim=1,
    )
    return ops_d, sel_d, out_sel.to(torch.int32).contiguous()


@functools.lru_cache(maxsize=None)
def _int32_on(values: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """A small int32 tensor on ``device`` (a grid's per-level PE counts, a
    chain's radii), built once per value tuple and device, not per launch."""
    return torch.tensor(values, dtype=torch.int32, device=device)


def _check(name: str, t: torch.Tensor, shape: Tuple[int, ...],
           dtype: torch.dtype, device: torch.device) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_settings(grid: GridSpec, n: int, settings, device) -> None:
    ops, sel, out_sel = settings
    L, max_w = grid.num_levels, max(grid.pes_per_level)
    _check("ops", ops, (n, L, max_w), torch.int32, device)
    _check("sel", sel, (n, L, max_w, 2), torch.int32, device)
    _check("out_sel", out_sel, (n, grid.num_outputs), torch.int32, device)


#: The widest value vector (max(C, PEs a level)) each kernel holds: B1, B2,
#: B3 and B4 share ``csrc/vcgra_vec.cuh``'s 64.
MAX_VALS = {"vcgra_fused_batched": 64, "vcgra_batched": 64, "vcgra_pipeline_batched": 64,
            "vcgra_conventional": 64}
#: The library each wrapper launches from.
_LIBRARIES = {"vcgra_pipeline_batched": "vcgra_pipeline"}


def check_value_width(kernel: str, grid: GridSpec) -> None:
    """Refuse a grid whose value vector is wider than ``kernel`` holds
    (:data:`MAX_VALS`), before any library is loaded."""
    widest = max(grid.num_inputs, max(grid.pes_per_level))
    limit = MAX_VALS[kernel]
    if widest > limit:
        raise ValueError(
            f"grid {grid.name!r} needs a {widest}-wide value vector; "
            f"{kernel} holds at most {limit}"
        )


def _launch_target(kernel: str, grid: GridSpec, n: int, device: torch.device):
    """The bound library of ``kernel``, after the checks only a launch
    needs."""
    if device.type != "cuda":
        raise ValueError(f"the Hopper kernels run on CUDA tensors, got {device}")
    check_value_width(kernel, grid)
    if n > _MAX_APPS:
        raise ValueError(f"{n} apps in one launch; at most {_MAX_APPS}")
    return load_library(_LIBRARIES.get(kernel, "vcgra"))


def _raise_on_error(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def vcgra_fused_batched(grid: GridSpec, radius: int, settings, ingests,
                        images: torch.Tensor, tile_rows=None) -> torch.Tensor:
    """N raw frames, N tenants, in one call (a small launch that packs each
    app's live settings, then the kernel): the Hopper twin of the
    reference's Pallas ``vcgra_fused_batched``.

    ``settings``: dense banks (:func:`pack_settings_batched`);
    ``ingests``: (tap_sel int32 [N, C], const_vals [N, C] in grid dtype);
    ``images``: [N, H, W], cast to the grid dtype at entry like the eager
    path's ``form_tap_bank``.  Returns [N, num_outputs, H*W] in the grid
    dtype.  ``tile_rows`` is validated and resolved like the reference's;
    the kernel reads each tap straight from the frame, so its output is
    the same for every tile height.  A radius up to
    :data:`WINDOW_MAX_RADIUS` reads its taps from a frame window in shared
    memory, a larger one (up to :data:`FUSED_MAX_RADIUS`) from device
    memory (:func:`fused_launch`).
    """
    frames = images.to(grid.dtype)
    n, H, W = frames.shape
    if int(radius) < 0:
        raise ValueError(f"radius must be >= 0, got {radius}")
    resolve_tile_rows(check_tile_rows(tile_rows), H, W, radius, grid)
    device = frames.device
    tap_sel, consts = ingests
    _check_settings(grid, n, settings, device)
    _check("tap_sel", tap_sel, (n, grid.num_inputs), torch.int32, device)
    _check("const_vals", consts, (n, grid.num_inputs), grid.dtype, device)
    _check("images", frames, (n, H, W), grid.dtype, device)
    if device.type == "cpu":
        return ref.vcgra_fused_batched_ref(grid, radius, settings, ingests, frames)
    lib = _launch_target("vcgra_fused_batched", grid, n, device)
    L, max_w, K, C = grid.num_levels, max(grid.pes_per_level), grid.num_outputs, grid.num_inputs
    threads, _, _ = fused_launch(frames.element_size(), int(radius), C, grid.pes_per_level, K)
    out = torch.empty((n, K, H * W), dtype=grid.dtype, device=device)
    if out.numel() == 0:
        return out
    ops, sel, out_sel = settings
    widths = _int32_on(grid.pes_per_level, device)
    radii = _int32_on((int(radius),), device)
    records = torch.empty((n, record_ints(C, grid.pes_per_level, K)), dtype=torch.int32,
                          device=device)
    rec_consts = torch.empty((n, C), dtype=grid.dtype, device=device)
    with torch.cuda.device(device):
        rc = lib.vcgra_fused_batched(
            _DTYPE_CODES[grid.dtype], frames.data_ptr(), ops.data_ptr(),
            sel.data_ptr(), out_sel.data_ptr(), tap_sel.data_ptr(),
            consts.data_ptr(), radii.data_ptr(), widths.data_ptr(), records.data_ptr(),
            rec_consts.data_ptr(), out.data_ptr(), n, H, W, L, max_w, K, C, int(radius),
            threads, *value_slots(C, grid.pes_per_level),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on_error("vcgra_fused_batched", rc)
    LAUNCHES["vcgra_fused_batched"] += 1
    return out


def vcgra_batched(grid: GridSpec, settings, xs: torch.Tensor) -> torch.Tensor:
    """N tenants over pre-packed channels ``[N, num_inputs, B]`` in one
    call (a small launch that packs each app's live settings, then the
    kernel) -> ``[N, num_outputs, B]``: the Hopper twin of the reference's
    Pallas ``vcgra_batched``.  Only each app's live channels are read.  B
    needs no padding (the kernel masks the ragged last group)."""
    n, C, B = xs.shape
    device = xs.device
    _check_settings(grid, n, settings, device)
    _check("xs", xs, (n, grid.num_inputs, B), grid.dtype, device)
    if device.type == "cpu":
        return ref.vcgra_batched_ref(grid, settings, xs)
    lib = _launch_target("vcgra_batched", grid, n, device)
    L, max_w, K = grid.num_levels, max(grid.pes_per_level), grid.num_outputs
    threads, _ = batched_launch(xs.element_size(), C, grid.pes_per_level, K)
    out = torch.empty((n, K, B), dtype=grid.dtype, device=device)
    if out.numel() == 0:
        return out
    ops, sel, out_sel = settings
    widths = _int32_on(grid.pes_per_level, device)
    records = torch.empty((n, record_ints(C, grid.pes_per_level, K)), dtype=torch.int32,
                          device=device)
    with torch.cuda.device(device):
        rc = lib.vcgra_batched(
            _DTYPE_CODES[grid.dtype], xs.data_ptr(), ops.data_ptr(), sel.data_ptr(),
            out_sel.data_ptr(), widths.data_ptr(), records.data_ptr(), out.data_ptr(),
            n, B, L, max_w, K, C, threads, *value_slots(C, grid.pes_per_level),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on_error("vcgra_batched", rc)
    LAUNCHES["vcgra_batched"] += 1
    return out


#: The largest radius (B3: sum of the stage radii) a frame window in shared
#: memory holds; B1 past it reads its taps from device memory, up to the
#: largest radius whose (2r + 1)^2 + 1 tap-bank rows an int32 ``tap_sel``
#: indexes.  The shared memory one block may take on the H100.
WINDOW_MAX_RADIUS = 16
FUSED_MAX_RADIUS = 23169
MAX_SMEM_BYTES = 232_448


def value_slots(num_inputs: int, widths) -> Tuple[int, int]:
    """The two value banks of B1, B2 and B3, in 16-byte slots a thread:
    bank A holds the input channels and the outputs of levels 1, 3, ...;
    bank B those of levels 0, 2, ...."""
    widths = list(widths)
    return max([num_inputs] + widths[1::2]), max(widths[0::2])


def record_ints(num_inputs: int, widths, K: int) -> int:
    """Ints of one (stage, app) settings record of B1, B2 and B3: the kept
    PEs (two ints each, a row of the widest level per level), the kept taps
    (two ints each), each level's count, the kept consts' and zeros'
    destinations, the K output offsets, three channel counts and the
    forwarded offset, rounded up to 4 ints (16 bytes)."""
    L = len(widths)
    return -(-(2 * L * max(widths) + L + 4 * num_inputs + K + 4) // 4) * 4


def _block(kernel: str, itemsize: int, R: int, buffers: int, num_inputs: int, widths,
           K: int) -> Tuple[int, int]:
    """``(threads, dynamic shared memory bytes)`` of a block of B1, B2, B3
    or B4: the most threads of 128, 64, 32 whose block fits
    :data:`MAX_SMEM_BYTES` (the mirror of ``smem_layout`` in
    ``csrc/vcgra_vec.cuh``: ``buffers`` window buffers of ``(32 + 2R) x
    (32P + 2Rp + 2P)`` elements, P = 16 / itemsize pixels a thread and Rp =
    R rounded up to P, the value banks, the consts and a settings
    record)."""
    widths = list(widths)
    if max([num_inputs] + widths) > MAX_VALS[kernel]:
        raise ValueError(f"value vector of {max([num_inputs] + widths)} (inputs {num_inputs}, "
                         f"levels {widths}); {kernel} takes at most {MAX_VALS[kernel]}")
    P = 16 // itemsize
    Rp = -(-R // P) * P
    rows, cols = 32 + 2 * R, 32 * P + 2 * Rp + 2 * P
    buf = -(-rows * cols * itemsize // 16) * 16
    slots = sum(value_slots(num_inputs, widths))
    fixed = (buffers * buf + -(-num_inputs * itemsize // 16) * 16
             + 4 * record_ints(num_inputs, widths, K))
    for threads in (128, 64, 32):
        smem = fixed + slots * threads * 16
        if smem <= MAX_SMEM_BYTES:
            return threads, smem
    raise ValueError(f"{kernel}'s block does not fit {MAX_SMEM_BYTES} bytes")


def pipeline_launch(itemsize: int, R: int, num_inputs: int, widths,
                    K: int) -> Tuple[int, int]:
    """B3's block, ``(threads, dynamic shared memory bytes)``: two window
    buffers for a chain whose radii sum to R.  Refuses a chain reaching
    past :data:`WINDOW_MAX_RADIUS` or a value vector wider than 64."""
    if R > WINDOW_MAX_RADIUS:
        raise ValueError(f"chain radii reach {R} pixels; the kernel's halo holds at most "
                         f"{WINDOW_MAX_RADIUS}")
    return _block("vcgra_pipeline_batched", itemsize, R, 2, num_inputs, widths, K)


def fused_launch(itemsize: int, radius: int, num_inputs: int, widths,
                 K: int) -> Tuple[int, int, bool]:
    """B1's block, ``(threads, dynamic shared memory bytes, window)``: with
    ``window`` (radius up to :data:`WINDOW_MAX_RADIUS`) one window buffer
    holds the frame's tile and halo; past it the kernel reads its taps from
    device memory and takes no buffer.  Refuses a radius past
    :data:`FUSED_MAX_RADIUS` or a value vector wider than 64."""
    if radius > FUSED_MAX_RADIUS:
        raise ValueError(f"radius {radius}: its tap bank's rows do not fit an int32 tap_sel "
                         f"(at most {FUSED_MAX_RADIUS})")
    window = radius <= WINDOW_MAX_RADIUS
    threads, smem = _block("vcgra_fused_batched", itemsize, radius if window else 0,
                           int(window), num_inputs, widths, K)
    return threads, smem, window


def batched_launch(itemsize: int, num_inputs: int, widths, K: int) -> Tuple[int, int]:
    """B2's block, ``(threads, dynamic shared memory bytes)``: no window
    buffer.  Refuses a value vector wider than 64."""
    return _block("vcgra_batched", itemsize, 0, 0, num_inputs, widths, K)


def conventional_launch(itemsize: int, num_inputs: int, widths, K: int,
                        block_n: int) -> Tuple[int, int, int]:
    """B4's block, ``(threads, dynamic shared memory bytes, passes)``: B2's
    block over one app, taking ``block_n`` pixels in passes of ``threads *
    P`` (P = 16 / itemsize), at least one (the C side also takes no more
    than N needs).  Refuses a value vector wider than 64."""
    threads, smem = _block("vcgra_conventional", itemsize, 0, 0, num_inputs, widths, K)
    per_pass = threads * (16 // itemsize)
    return threads, smem, max(1, -(-int(block_n) // per_pass))


def vcgra_pipeline_batched(grid: GridSpec, radii, settings, ingests, out_chs: torch.Tensor,
                           hw: torch.Tensor, images: torch.Tensor,
                           tile_rows=None) -> torch.Tensor:
    """N chained tenants on N raw frames in one call (a small launch that
    packs each (stage, app)'s live settings, then the chain kernel): the
    Hopper twin of the reference's Pallas ``vcgra_pipeline_batched``.

    ``radii``: the S stage radii; ``settings``: stage-stacked dense banks
    (ops int32 [S, N, L, max_w], sel [S, N, L, max_w, 2], out_sel
    [S, N, K]); ``ingests``: (tap_sel int32 [S, N, C], const_vals
    [S, N, C] in grid dtype); ``out_chs``: int32 [S, N], the output
    channel stage *i* forwards (the last row is never read); ``hw``: int32
    [N, 2] true (rows, cols) of each app's frame inside the canvas;
    ``images``: [N, H, W], cast to the grid dtype.  Returns [N, K, H*W].
    Stage *i* forwards ``ys[:, out_ch]`` (the output mux's pick), as the
    reference's XLA oracle does.  ``tile_rows`` is validated and resolved
    against the chain's total radius like the reference's; the kernel's
    output does not depend on it."""
    radii = tuple(int(r) for r in radii)
    if not radii or min(radii) < 0:
        raise ValueError(f"radii must be a non-empty sequence of ints >= 0, got {radii}")
    frames = images.to(grid.dtype)
    n, H, W = frames.shape
    S, R = len(radii), sum(radii)
    resolve_tile_rows(check_tile_rows(tile_rows), H, W, R, grid)
    device = frames.device
    ops, sel, out_sel = settings
    tap_sel, consts = ingests
    L, max_w, K, C = grid.num_levels, max(grid.pes_per_level), grid.num_outputs, grid.num_inputs
    _check("ops", ops, (S, n, L, max_w), torch.int32, device)
    _check("sel", sel, (S, n, L, max_w, 2), torch.int32, device)
    _check("out_sel", out_sel, (S, n, K), torch.int32, device)
    _check("tap_sel", tap_sel, (S, n, C), torch.int32, device)
    _check("const_vals", consts, (S, n, C), grid.dtype, device)
    _check("out_chs", out_chs, (S, n), torch.int32, device)
    _check("hw", hw, (n, 2), torch.int32, device)
    _check("images", frames, (n, H, W), grid.dtype, device)
    if device.type == "cpu":
        return ref.vcgra_pipeline_batched_ref(grid, radii, settings, ingests, out_chs, hw,
                                              frames)
    lib = _launch_target("vcgra_pipeline_batched", grid, n, device)
    threads, _ = pipeline_launch(frames.element_size(), R, C, grid.pes_per_level, K)
    slots_a, slots_b = value_slots(C, grid.pes_per_level)
    out = torch.empty((n, K, H * W), dtype=grid.dtype, device=device)
    if out.numel() == 0:
        return out
    widths = _int32_on(grid.pes_per_level, device)
    radii_t = _int32_on(radii, device)
    records = torch.empty((S * n, record_ints(C, grid.pes_per_level, K)),
                          dtype=torch.int32, device=device)
    rec_consts = torch.empty((S * n, C), dtype=grid.dtype, device=device)
    with torch.cuda.device(device):
        rc = lib.vcgra_pipeline_batched(
            _DTYPE_CODES[grid.dtype], frames.data_ptr(), ops.data_ptr(), sel.data_ptr(),
            out_sel.data_ptr(), tap_sel.data_ptr(), consts.data_ptr(), out_chs.data_ptr(),
            hw.data_ptr(), widths.data_ptr(), radii_t.data_ptr(), records.data_ptr(),
            rec_consts.data_ptr(), out.data_ptr(),
            S, n, H, W, L, max_w, K, C, R, threads, slots_a, slots_b,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on_error("vcgra_pipeline_batched", rc)
    LAUNCHES["vcgra_pipeline_batched"] += 1
    return out


def _check_block_n(block_n) -> int:
    if isinstance(block_n, bool) or not isinstance(block_n, (int, np.integer)) \
            or block_n < LANE or block_n % LANE:
        raise ValueError(f"block_n must be a positive multiple of {LANE}, got {block_n!r}")
    return int(block_n)


def vcgra_conventional(grid: GridSpec, settings, x: torch.Tensor,
                       block_n: int = BLOCK_N) -> torch.Tensor:
    """One app over channel-major ``x [num_inputs, N]`` -> ``[K, N]`` with
    its settings as runtime operands: the Hopper twin of the reference's
    Pallas ``vcgra_conventional``.  ``settings``: one dense bank
    ``(ops int32 [L, max_w], sel int32 [L, max_w, 2], out_sel int32 [K])``
    (:func:`_pack_settings`).  Like B2 with one app: a small launch packs
    the app's live settings, then the kernel reads only its live channels.
    ``block_n`` pixels per block (validated like the reference's;
    :func:`conventional_launch`); N needs no padding and the output does not
    depend on ``block_n``."""
    block_n = _check_block_n(block_n)
    if x.dim() != 2:
        raise ValueError(f"x must be [channels, N], got shape {tuple(x.shape)}")
    C, N = x.shape
    device = x.device
    ops, sel, out_sel = settings
    L, max_w, K = grid.num_levels, max(grid.pes_per_level), grid.num_outputs
    _check("ops", ops, (L, max_w), torch.int32, device)
    _check("sel", sel, (L, max_w, 2), torch.int32, device)
    _check("out_sel", out_sel, (K,), torch.int32, device)
    _check("x", x, (grid.num_inputs, N), grid.dtype, device)
    if device.type == "cpu":
        return ref.vcgra_conventional_ref(grid, settings, x)
    lib = _launch_target("vcgra_conventional", grid, 1, device)
    threads, _, _ = conventional_launch(x.element_size(), C, grid.pes_per_level, K, block_n)
    out = torch.empty((K, N), dtype=grid.dtype, device=device)
    if out.numel() == 0:
        return out
    widths = _int32_on(grid.pes_per_level, device)
    records = torch.empty(record_ints(C, grid.pes_per_level, K), dtype=torch.int32,
                          device=device)
    with torch.cuda.device(device):
        rc = lib.vcgra_conventional(
            _DTYPE_CODES[grid.dtype], x.data_ptr(), ops.data_ptr(), sel.data_ptr(),
            out_sel.data_ptr(), widths.data_ptr(), records.data_ptr(), out.data_ptr(), N,
            block_n, L, max_w, K, C, threads, *value_slots(C, grid.pes_per_level),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on_error("vcgra_conventional", rc)
    LAUNCHES["vcgra_conventional"] += 1
    return out


def vcgra_specialized(kernel: SpecializedKernel, x: torch.Tensor,
                      block_n: int = BLOCK_N) -> torch.Tensor:
    """Run one app's loaded B5 kernel (:class:`SpecializedKernel`) over
    channel-major ``x [C, N]`` -> ``[K, N]``: the Hopper twin of the
    reference's Pallas ``vcgra_specialized``.  Only the live input rows are
    read; ``block_n`` pixels per block, and the output does not depend on
    it."""
    block_n = _check_block_n(block_n)
    grid = kernel.grid
    if x.dim() != 2:
        raise ValueError(f"x must be [channels, N], got shape {tuple(x.shape)}")
    C, N = x.shape
    _check("x", x, (C, N), grid.dtype, kernel.device)
    if C < kernel.num_channels:
        raise ValueError(f"x has {C} channels; {kernel.config.app_name!r} reads "
                         f"{kernel.num_channels}")
    if kernel.device.type == "cpu":
        return ref.vcgra_specialized_ref(grid, kernel.config, x, kernel.bake_consts)
    out = torch.empty((grid.num_outputs, N), dtype=grid.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = load_library("vcgra_specialize")
    with torch.cuda.device(x.device):
        rc = lib.vcgra_spec_launch(kernel.handle, x.data_ptr(), out.data_ptr(), N, N,
                                   block_n, THREADS, torch.cuda.current_stream().cuda_stream)
    _raise_on_error("vcgra_specialized", rc)
    LAUNCHES["vcgra_specialized"] += 1
    return out


def _pack_settings(grid: GridSpec, config: VCGRAConfig, device=None):
    """One app's settings as B4's dense bank: ``(ops int32 [L, max_w],
    sel int32 [L, max_w, 2], out_sel int32 [K], max_w)``; pad slots hold
    Op.NONE / select 0 and are never read."""
    max_w = max(grid.pes_per_level)
    ops_arr = np.zeros((grid.num_levels, max_w), np.int32)
    sel_arr = np.zeros((grid.num_levels, max_w, 2), np.int32)
    for lvl in range(grid.num_levels):
        w = grid.pes_per_level[lvl]
        ops_arr[lvl, :w] = config.opcodes[lvl]
        sel_arr[lvl, :w] = config.selects[lvl]
    return (torch.as_tensor(ops_arr, device=device), torch.as_tensor(sel_arr, device=device),
            torch.as_tensor(np.asarray(config.out_sel, np.int32), device=device), max_w)


def ingest_image(plan: IngestPlan, dtype: torch.dtype, image: torch.Tensor) -> torch.Tensor:
    """Fused frame ingest: ``[H, W]`` raw image -> ``[C, H*W]`` channels
    (the tap bank and each channel's producer, on the image's device)."""
    bank = form_tap_bank(image[None], plan.radius, dtype)[0]
    return apply_ingest(bank, plan.to_torch(dtype, device=image.device))


def vcgra_apply(grid: GridSpec, config: VCGRAConfig, x: torch.Tensor,
                mode: str = "specialized", block_n: int = BLOCK_N) -> torch.Tensor:
    """Run a mapped application over a channel-major batch
    ``[num_inputs, N]`` (on ``x``'s device): B5 for ``mode="specialized"``
    (compiled for this config, coefficients read from ``x`` as the
    reference's Pallas body does), B4 for ``mode="conventional"``."""
    _check_block_n(block_n)
    if mode == "specialized":
        kernel = SpecializedKernel(grid, config, bake_consts=False, device=x.device)
        return vcgra_specialized(kernel, x, block_n=block_n)
    if mode == "conventional":
        ops_arr, sel_arr, out_sel, _ = _pack_settings(grid, config, device=x.device)
        return vcgra_conventional(grid, (ops_arr, sel_arr, out_sel),
                                  pad_channels(x, grid.num_inputs), block_n=block_n)
    raise ValueError(f"unknown mode {mode!r}")


def vcgra_apply_image(grid: GridSpec, config: VCGRAConfig, image, mode: str = "specialized",
                      block_n: int = BLOCK_N, device="cuda") -> torch.Tensor:
    """Stencil-app convenience: ``[H, W]`` image -> ``[H, W]`` (or
    ``[K, H, W]``) output, on ``device``.

    Takes the fused ingest (tap bank + channel select on the device)
    whenever the config carries an :class:`IngestPlan`; the host-side
    two-step oracle (``stencil_inputs`` + ``pack_inputs``) otherwise."""
    dev = check_device(device)
    img = torch.as_tensor(image, device=dev)
    H, W = img.shape
    if config.ingest is not None:
        x = ingest_image(config.ingest, grid.dtype, img)
    else:
        taps = apps.stencil_inputs(img)
        feed = {k: v for k, v in taps.items() if k in config.input_order}
        x = pack_inputs(config, feed, grid.dtype, device=dev)
    y = vcgra_apply(grid, config, x, mode=mode, block_n=block_n).reshape(-1, H, W)
    return y[0] if y.shape[0] == 1 else y


# -- plan executors ------------------------------------------------------------


def _batched_fused_fn(grid: GridSpec, radius: int, tile_rows=None):
    """``fn(stacked_configs, stacked_ingests, images) -> [N, K, H*W]``."""

    def fn(stacked_configs, stacked_ingests, images):
        settings = pack_settings_batched(grid, stacked_configs)
        return vcgra_fused_batched(grid, radius, settings, stacked_ingests,
                                   images, tile_rows=tile_rows)

    return fn


def _batched_fn(grid: GridSpec):
    """``fn(stacked_configs, xs) -> [N, K, B]``."""

    def fn(stacked_configs, xs):
        return vcgra_batched(grid, pack_settings_batched(grid, stacked_configs),
                             xs.to(grid.dtype))

    return fn


def pipeline_fn(grid: GridSpec, radii, tile_rows=None):
    """``fn(stage_settings, hw, images) -> [N, K, H*W]``: each stage's
    ``(stacked_configs, stacked_ingests, out_ch)`` is dense-packed
    (:func:`pack_settings_batched`) and stacked on a leading stage axis, so
    the whole chain rides one launch of :func:`vcgra_pipeline_batched`."""
    radii = tuple(int(r) for r in radii)

    def fn(stage_settings, hw, images):
        packed = [pack_settings_batched(grid, configs) for configs, _, _ in stage_settings]
        settings = tuple(torch.stack([p[j] for p in packed]) for j in range(3))
        ingests = (
            torch.stack([ing[0].to(torch.int32) for _, ing, _ in stage_settings]),
            torch.stack([ing[1].to(grid.dtype) for _, ing, _ in stage_settings]),
        )
        out_chs = torch.stack([oc.to(torch.int32) for _, _, oc in stage_settings])
        return vcgra_pipeline_batched(grid, radii, settings, ingests, out_chs,
                                      hw.to(torch.int32), images, tile_rows=tile_rows)

    return fn


@register_pipeline_executor("hopper")
def _plan_pipeline(plan: OverlayPlan):
    return pipeline_fn(plan.grid, plan.pipeline[0].radii, plan.tile_rows)


@register_executor("hopper", batched=True, fused=True)
def _plan_batched_fused(plan: OverlayPlan):
    return _batched_fused_fn(plan.grid, plan.radius, plan.tile_rows)


@register_executor("hopper", batched=True, fused=False)
def _plan_batched(plan: OverlayPlan):
    return _batched_fn(plan.grid)


@register_executor("hopper", batched=False, fused=False)
def _plan_single(plan: OverlayPlan):
    """Single-app execution rides the batched kernel with N=1."""
    batched = _batched_fn(plan.grid)

    def fn(config, x):
        return batched(lift_app_axis(config), x[None])[0]

    return fn


@register_executor("hopper", batched=False, fused=True)
def _plan_single_fused(plan: OverlayPlan):
    batched = _batched_fused_fn(plan.grid, plan.radius, plan.tile_rows)

    def fn(config, ingest, image):
        return batched(lift_app_axis(config), lift_app_axis(ingest), image[None])[0]

    return fn
