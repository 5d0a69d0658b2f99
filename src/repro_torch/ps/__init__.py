"""ps of the PyTorch/CUDA port (twin of ``repro.ps``): the parameter-server
engine (worker ``propose_tree``, server ``server_fold``, the shared
``round_body``, the loop-form ``Trainer``, the staleness-adaptive step's
``staleness_scale`` and ``scale_push``) and its delay schedules."""
from repro_torch.ps.engine import (
    Trainer,
    clear_trainers,
    get_trainer,
    propose_tree,
    round_body,
    scale_push,
    server_fold,
    staleness_scale,
    train,
)
from repro_torch.ps.schedules import (
    constant_delay,
    max_staleness,
    resolve_schedule,
    staleness_scales,
    worker_round_robin,
)

__all__ = [
    "Trainer",
    "clear_trainers",
    "get_trainer",
    "propose_tree",
    "round_body",
    "scale_push",
    "server_fold",
    "staleness_scale",
    "train",
    "constant_delay",
    "max_staleness",
    "resolve_schedule",
    "staleness_scales",
    "worker_round_robin",
]
