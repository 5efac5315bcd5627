"""Optimizer: AdamW with global-norm clipping and decay masking, and
error-feedback int8 gradient compression (twin of the reference's
``optim/``)."""

from repro_torch.optim.adamw import (
    AdamWConfig, adamw_update, global_norm, init_opt_state, schedule_lr,
)
from repro_torch.optim.grad_compression import compress, decompress, init_error_state

__all__ = [
    "AdamWConfig", "adamw_update", "global_norm", "init_opt_state",
    "schedule_lr", "compress", "decompress", "init_error_state",
]
