"""Atomic, async checkpointing with the reference's on-disk layout."""

from repro_torch.checkpoint.checkpointer import Checkpointer

__all__ = ["Checkpointer"]
