"""core of the PyTorch/CUDA port (twin of ``repro.core``): the paper's
contribution.

- ``sgbdt``: config/state definitions + the serial trainer (the tau = 0
  special case, the PS engine under the zero-staleness schedule).
- ``async_sgbdt``: the asynchronous trainer under explicit delay
  schedules, in loop and explicit-schedule (``scan_with``) forms.
- ``simulator``: the event-driven parameter-server cluster simulator
  (heterogeneous workers, network jitter), numpy only, bit for bit the
  reference's.
- ``baselines``: the closed-form speedup models (Eq. 13, fork-join,
  DimBoost), numpy only.
"""
from repro_torch.core.sgbdt import (
    SGBDTConfig,
    TrainState,
    init_state,
    train_loss,
    train_metrics,
    train_serial,
)
from repro_torch.core.async_sgbdt import (
    constant_delay,
    max_staleness,
    train_async,
    train_async_scan,
    worker_round_robin,
)
from repro_torch.core.simulator import ClusterSpec, simulate_async, simulate_sync

__all__ = [
    "SGBDTConfig",
    "TrainState",
    "init_state",
    "train_serial",
    "train_loss",
    "train_metrics",
    "constant_delay",
    "max_staleness",
    "worker_round_robin",
    "train_async",
    "train_async_scan",
    "ClusterSpec",
    "simulate_async",
    "simulate_sync",
]
