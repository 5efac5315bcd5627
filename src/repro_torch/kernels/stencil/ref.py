"""Plain PyTorch versions of the fused 3x3 stencil.

* :func:`stencil_ref` is the twin of the reference's oracle
  (``repro.kernels.stencil.ref.stencil_ref``): each filter sums
  ``coeff * tap`` onto a zero start in the image dtype, so PyTorch's
  promotion makes an int32 (or int16) image's result float32, as JAX's
  weak typing does there.
* :func:`stencil_fused_ref` is the plain version of the Hopper kernel B6
  (and of the reference's Pallas ``stencil_fused``): the sum starts at the
  first nonzero term and the result is cast back to the image dtype, so an
  int32 image gives an int32 result (float -> int truncation).

The kernel wrapper (``ops.stencil_fused``) takes the latter only for
tensors on the CPU; on the card ``chip_smoke.py`` and the CUDA tests hold
the kernel against it.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

Kernel3 = Sequence[Sequence[float]]


def _taps(image: torch.Tensor):
    """``(row, col, tap)`` of the zero-padded image, in row-major order."""
    H, W = image.shape
    pad = F.pad(image, (1, 1, 1, 1))
    for r in range(3):
        for c in range(3):
            yield r, c, pad[r: r + H, c: c + W]


def stencil_ref(image: torch.Tensor, kernels: Sequence[Kernel3]) -> torch.Tensor:
    """One filter -> its convolution; two -> ``|k0*img| + |k1*img|``."""
    H, W = image.shape
    outs = []
    for kq in kernels:
        acc = torch.zeros((H, W), dtype=image.dtype, device=image.device)
        for r, c, tap in _taps(image):
            coeff = float(kq[r][c])
            if coeff != 0.0:
                acc = acc + coeff * tap
        outs.append(acc)
    if len(outs) == 2:
        return outs[0].abs() + outs[1].abs()
    return outs[0]


def stencil_fused_ref(image: torch.Tensor, kernels: Sequence[Kernel3]) -> torch.Tensor:
    """B6's arithmetic: ``tap * float(c)`` for the nonzero coefficients,
    summed from the first term in row-major order (float32 for int32 and
    float32 images, bf16 rounded after every op for bf16 images), then cast
    to the image dtype."""
    outs = []
    for kq in kernels:
        acc = None
        for r, c, tap in _taps(image):
            coeff = float(kq[r][c])
            if coeff != 0.0:
                term = tap * coeff
                acc = term if acc is None else acc + term
        outs.append(acc)
    res = outs[0].abs() + outs[1].abs() if len(outs) == 2 else outs[0]
    return res.to(image.dtype)
