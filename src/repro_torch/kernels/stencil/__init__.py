"""The fused 3x3 stencil kernel for Hopper (``csrc/stencil.cu``), its
wrapper, entry points and plain PyTorch versions."""

from repro_torch.kernels.stencil.ops import (
    LAUNCHES,
    conv3x3_fused,
    reset_launch_counts,
    sobel_magnitude_fused,
    stencil_fused,
)
from repro_torch.kernels.stencil.ref import stencil_fused_ref, stencil_ref

__all__ = [
    "LAUNCHES",
    "conv3x3_fused",
    "reset_launch_counts",
    "sobel_magnitude_fused",
    "stencil_fused",
    "stencil_fused_ref",
    "stencil_ref",
]
