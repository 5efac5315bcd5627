"""GQA flash decode attention for Hopper (``csrc/flash_decode.cu``, B7),
its wrapper and its plain PyTorch version."""

from repro_torch.kernels.flash_attention.ops import (
    LAUNCHES,
    decode_attention,
    reset_launch_counts,
)
from repro_torch.kernels.flash_attention.ref import decode_ref

__all__ = ["LAUNCHES", "decode_attention", "decode_ref", "reset_launch_counts"]
