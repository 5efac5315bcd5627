from repro_torch.roofline.model import (
    F32_FLOPS, HBM_BW, NVLINK_BW_PER_DIRECTION, PEAK_FLOPS, RooflineReport, collective_bytes,
    format_roofline_rows, model_flops_estimate, shape_bytes,
)

__all__ = [
    "F32_FLOPS", "HBM_BW", "NVLINK_BW_PER_DIRECTION", "PEAK_FLOPS", "RooflineReport",
    "collective_bytes", "format_roofline_rows", "model_flops_estimate", "shape_bytes",
]
