"""The VCGRA overlay kernels for Hopper (``csrc/vcgra.cu``,
``csrc/vcgra_pipeline.cu``), their wrappers and their plain PyTorch
versions."""

from repro_torch.kernels.vcgra.ops import (
    LAUNCHES,
    pack_settings_batched,
    pipeline_fn,
    reset_launch_counts,
    vcgra_batched,
    vcgra_fused_batched,
    vcgra_pipeline_batched,
)
from repro_torch.kernels.vcgra.ref import (
    vcgra_batched_ref,
    vcgra_fused_batched_ref,
    vcgra_pipeline_batched_ref,
)

__all__ = [
    "LAUNCHES",
    "pack_settings_batched",
    "pipeline_fn",
    "reset_launch_counts",
    "vcgra_batched",
    "vcgra_batched_ref",
    "vcgra_fused_batched",
    "vcgra_fused_batched_ref",
    "vcgra_pipeline_batched",
    "vcgra_pipeline_batched_ref",
]
