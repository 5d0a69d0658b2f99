"""ps of the PyTorch/CUDA port (twin of ``repro.ps``), the parameter-server
execution layer (Algorithm 3):

  * ``engine``    — the Trainer and the one shared round body (worker
                    ``propose_tree`` with its per-ticket ``round_draws``,
                    server ``server_fold``, the staleness-adaptive
                    ``staleness_scale`` and ``scale_push``);
  * ``schedules`` — delay-schedule providers k(j): closed forms, realized
                    arrays, or on-the-spot cluster simulation;
  * ``worker``    — the worker pool a block of W trees at a time;
  * ``runtime``   — REAL host asynchrony: W worker threads (each on a CUDA
                    stream of its own on the card) race a server fold loop,
                    the realized k(j) is recorded into a ``RunTrace``, and
                    replaying the trace reproduces the forest exactly.
  * ``sharded``   — the synchronous sharded build over ``torch.distributed``
                    (data-parallel and 2D data x feature), which
                    ``Trainer(mesh=)`` runs.
"""
from repro_torch.ps.engine import (
    Trainer,
    clear_trainers,
    get_trainer,
    propose_tree,
    round_body,
    round_draws,
    scale_push,
    server_fold,
    staleness_scale,
    train,
)
from repro_torch.ps.runtime import AsyncRuntime, FaultPlan, RunTrace, replay_trace
from repro_torch.ps.schedules import (
    constant_delay,
    max_staleness,
    resolve_schedule,
    staleness_scales,
    worker_round_robin,
)
from repro_torch.ps.worker import build_trees_batched, train_worker_parallel

__all__ = [
    "AsyncRuntime",
    "FaultPlan",
    "RunTrace",
    "replay_trace",
    "Trainer",
    "clear_trainers",
    "get_trainer",
    "propose_tree",
    "round_body",
    "round_draws",
    "scale_push",
    "server_fold",
    "staleness_scale",
    "train",
    "constant_delay",
    "max_staleness",
    "resolve_schedule",
    "staleness_scales",
    "worker_round_robin",
    "build_trees_batched",
    "train_worker_parallel",
]
