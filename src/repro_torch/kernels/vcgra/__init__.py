"""The VCGRA overlay kernels for Hopper (``csrc/vcgra.cu``,
``csrc/vcgra_pipeline.cu`` and the per-app kernels that ``specialized.py``
generates), their wrappers, the single-app entry points and their plain
PyTorch versions."""

from repro_torch.kernels.vcgra.ops import (
    LAUNCHES,
    pack_settings_batched,
    pipeline_fn,
    reset_launch_counts,
    vcgra_apply,
    vcgra_apply_image,
    vcgra_batched,
    vcgra_conventional,
    vcgra_fused_batched,
    vcgra_pipeline_batched,
    vcgra_specialized,
)
from repro_torch.kernels.vcgra.ref import (
    vcgra_batched_ref,
    vcgra_conventional_ref,
    vcgra_fused_batched_ref,
    vcgra_pipeline_batched_ref,
    vcgra_ref,
    vcgra_specialized_ref,
)
from repro_torch.kernels.vcgra.specialized import SpecializedKernel

__all__ = [
    "LAUNCHES",
    "SpecializedKernel",
    "pack_settings_batched",
    "pipeline_fn",
    "reset_launch_counts",
    "vcgra_apply",
    "vcgra_apply_image",
    "vcgra_batched",
    "vcgra_batched_ref",
    "vcgra_conventional",
    "vcgra_conventional_ref",
    "vcgra_fused_batched",
    "vcgra_fused_batched_ref",
    "vcgra_pipeline_batched",
    "vcgra_pipeline_batched_ref",
    "vcgra_ref",
    "vcgra_specialized",
    "vcgra_specialized_ref",
]
