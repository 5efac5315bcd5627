"""Wrapper of the Hopper fused-stencil kernel (B6) and its entry points.

``stencil_fused`` checks its operands, allocates the output and launches
``csrc/stencil.cu`` on PyTorch's current stream, counting each launch in
:data:`LAUNCHES`.  Given a CPU tensor it computes the plain version
(``ref.stencil_fused_ref``) instead; for a CUDA tensor it launches or
raises.  The kernel holds the library filters as compile-time constants,
so on the card the filters must be one of :data:`FILTERS` (or the Sobel
pair); ``sobel_magnitude_fused`` and ``conv3x3_fused`` are the entry
points, twins of the reference's.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from repro_torch.core import applications as apps
from repro_torch.core.interpreter import check_device
from repro_torch.kernels.build import load_library
from repro_torch.kernels.stencil import ref

#: Launches of the kernel since the last :func:`reset_launch_counts`.
LAUNCHES: Dict[str, int] = {"stencil_fused": 0}

#: The library filters, in the kernel's filter-id order.
FILTERS = {
    "sobel_x": apps.SOBEL_X, "sobel_y": apps.SOBEL_Y, "gauss3": apps.GAUSS3,
    "sharpen": apps.SHARPEN, "laplace": apps.LAPLACE, "box3": apps.BOX3,
}
_FILTER_IDS = {tuple(float(c) for row in k for c in row): i for i, k in enumerate(FILTERS.values())}
#: The kernel's only two-filter form: ``|sobel_x * img| + |sobel_y * img|``.
_PAIRS = {(0, 1)}

_DTYPE_CODES = {torch.int32: 0, torch.float32: 2, torch.bfloat16: 3}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _filter_id(kq) -> int:
    key = tuple(float(c) for row in kq for c in row)
    if key not in _FILTER_IDS:
        raise ValueError(f"filter {kq!r} is not one of the kernel's compiled filters "
                         f"({', '.join(FILTERS)})")
    return _FILTER_IDS[key]


def stencil_fused(image: torch.Tensor, kernels: Sequence, block_h: int = 8) -> torch.Tensor:
    """Fused stencil over an ``[H, W]`` image: one filter -> its
    convolution, two -> ``|k0*img| + |k1*img|``, in the image dtype (int32,
    float32 or bfloat16).  ``block_h`` output rows per block, between 1 and
    the kernel's limit; the output does not depend on it."""
    if image.dim() != 2:
        raise ValueError(f"image must be [H, W], got shape {tuple(image.shape)}")
    if image.dtype not in _DTYPE_CODES:
        raise TypeError(f"image dtype {image.dtype}; the kernel takes int32, float32 "
                        "or bfloat16")
    if len(kernels) not in (1, 2):
        raise ValueError(f"one or two filters, got {len(kernels)}")
    if isinstance(block_h, bool) or not isinstance(block_h, int) or block_h < 1:
        raise ValueError(f"block_h must be an int >= 1, got {block_h!r}")
    if not image.is_contiguous():
        raise ValueError("image must be contiguous")
    if image.device.type == "cpu":
        return ref.stencil_fused_ref(image, kernels)
    if image.device.type != "cuda":
        raise ValueError(f"the Hopper kernels run on CUDA tensors, got {image.device}")
    ids = [_filter_id(k) for k in kernels]
    if len(ids) == 2 and tuple(ids) not in _PAIRS:
        raise ValueError("the kernel's two-filter form is the Sobel pair (sobel_x, sobel_y)")
    lib = load_library("stencil")
    if block_h > lib.stencil_max_block_h():
        raise ValueError(f"block_h={block_h}; the kernel's tile holds at most "
                         f"{lib.stencil_max_block_h()} rows")
    H, W = image.shape
    out = torch.empty_like(image)
    if out.numel() == 0:
        return out
    if -(-H // block_h) > 65535:
        raise ValueError(f"{H} rows in tiles of {block_h} exceed the launch's 65535 row tiles")
    with torch.cuda.device(image.device):
        rc = lib.stencil_fused(_DTYPE_CODES[image.dtype], ids[0], ids[1] if len(ids) == 2 else -1,
                               image.data_ptr(), out.data_ptr(), H, W, block_h,
                               torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"stencil_fused launch failed: cudaError {rc}")
    LAUNCHES["stencil_fused"] += 1
    return out


def sobel_magnitude_fused(image, block_h: int = 8, device="cuda") -> torch.Tensor:
    """Fully fused ``|Gx| + |Gy|`` Sobel magnitude of an ``[H, W]`` frame
    on ``device`` (the beyond-paper fast path)."""
    img = torch.as_tensor(image, device=check_device(device))
    return stencil_fused(img, (apps.SOBEL_X, apps.SOBEL_Y), block_h=block_h)


def conv3x3_fused(image, kernel_name: str, block_h: int = 8, device="cuda") -> torch.Tensor:
    """One library 3x3 filter (:data:`FILTERS`) over an ``[H, W]`` frame on
    ``device``."""
    img = torch.as_tensor(image, device=check_device(device))
    return stencil_fused(img, (FILTERS[kernel_name],), block_h=block_h)
