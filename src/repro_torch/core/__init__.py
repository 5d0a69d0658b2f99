"""core of the PyTorch/CUDA port (twin of ``repro.core``): the config and
state of stochastic GBDT and the serial trainer (the PS engine under the
zero-staleness schedule)."""
from repro_torch.core.sgbdt import (
    SGBDTConfig,
    TrainState,
    init_state,
    train_loss,
    train_metrics,
    train_serial,
)

__all__ = [
    "SGBDTConfig",
    "TrainState",
    "init_state",
    "train_serial",
    "train_loss",
    "train_metrics",
]
