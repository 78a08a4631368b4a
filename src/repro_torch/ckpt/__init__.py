"""Checkpoints whose manifest index is reconstructed on restore (the
paper's recovery path): see :mod:`repro_torch.ckpt.checkpoint`."""

from . import checkpoint  # noqa: F401
from .checkpoint import (  # noqa: F401
    CheckpointIndex,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
    save_checkpoint_delta,
    step_manifest,
)

__all__ = [
    "CheckpointIndex",
    "latest_step",
    "restore_checkpoint",
    "save_checkpoint",
    "save_checkpoint_delta",
    "step_manifest",
]
