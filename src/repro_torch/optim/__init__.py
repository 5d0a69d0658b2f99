"""Optimizer substrate of the port (twin of ``repro.optim``): gradient
transforms over nested parameter dicts, updated in place, and the paper's
staleness mechanism (``delayed_gradient``)."""
from repro_torch.optim.optimizers import (
    Optimizer,
    adam,
    adamw,
    add_decayed_weights,
    apply_updates,
    chain,
    clip_by_global_norm,
    cosine_schedule,
    scale,
    sgd,
)
from repro_torch.optim.delayed import (
    DelayedState,
    delayed_gradient,
    staleness_step_scale,
)

__all__ = [
    "Optimizer",
    "adam",
    "adamw",
    "add_decayed_weights",
    "apply_updates",
    "chain",
    "clip_by_global_norm",
    "cosine_schedule",
    "scale",
    "sgd",
    "DelayedState",
    "delayed_gradient",
    "staleness_step_scale",
]
