"""Checkpointing of the PyTorch/CUDA port (twin of ``repro.checkpoint``):
tree save/restore on the reference's disk format, with manifest and CRCs."""
from repro_torch.checkpoint.store import (
    CheckpointManager,
    latest_step,
    leaf_manifest,
    restore_pytree,
    save_pytree,
    step_dir,
    steps,
)

__all__ = [
    "CheckpointManager",
    "latest_step",
    "leaf_manifest",
    "restore_pytree",
    "save_pytree",
    "step_dir",
    "steps",
]
