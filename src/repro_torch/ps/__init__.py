"""ps of the PyTorch/CUDA port (twin of ``repro.ps``): the parameter-server
engine (worker ``propose_tree``, server ``server_fold``, the shared
``round_body``, the loop-form ``Trainer``) and its delay schedules."""
from repro_torch.ps.engine import (
    Trainer,
    clear_trainers,
    get_trainer,
    propose_tree,
    round_body,
    server_fold,
    train,
)
from repro_torch.ps.schedules import (
    constant_delay,
    max_staleness,
    resolve_schedule,
    worker_round_robin,
)

__all__ = [
    "Trainer",
    "clear_trainers",
    "get_trainer",
    "propose_tree",
    "round_body",
    "server_fold",
    "train",
    "constant_delay",
    "max_staleness",
    "resolve_schedule",
    "worker_round_robin",
]
