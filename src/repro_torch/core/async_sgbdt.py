"""Asynch-SGBDT: Algorithm 3 with explicit delay schedules (twin of
``repro.core.async_sgbdt``, the legacy names).

Asynchrony's entire algorithmic effect is *which* server version each
pushed tree was built from: the k(j) map with staleness j - k(j).
Proposition 1 is stated in terms of k(j), so k(j) is executed exactly. Both
entry points run the shared round body (``repro_torch.ps.engine``) under a
``Trainer``:

  * ``train_async``: the loop with per-round eval hooks (experiments);
  * ``train_async_scan``: the run over an explicit (k(j), ticket) pair with
    per-round losses (``Trainer.scan_with``, the loop-form twin of the
    reference's ``lax.scan``).

The schedule closed forms (``constant_delay``, ``worker_round_robin``,
``max_staleness``) are re-exported from ``repro_torch.ps.schedules``.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core.sgbdt import SGBDTConfig, TrainState
from repro_torch.ps.schedules import (  # noqa: F401  (public re-exports)
    constant_delay,
    max_staleness,
    worker_round_robin,
)
from repro_torch.trees.binning import BinnedData


def train_async(
    cfg: SGBDTConfig,
    data: BinnedData,
    schedule: np.ndarray,
    seed: int = 0,
    eval_every: int = 0,
    eval_fn: Callable[[TrainState, int], None] | None = None,
) -> TrainState:
    """Algorithm 3 under an explicit delay schedule (the loop), on the
    data's device."""
    from repro_torch.ps.engine import train

    return train(cfg, data, schedule, seed=seed, eval_every=eval_every, eval_fn=eval_fn)


def train_async_scan(
    cfg: SGBDTConfig,
    data: BinnedData,
    schedule: np.ndarray,  # (T,) int32 k(j)
    key_index: np.ndarray,  # (T,) tickets: round j folds ticket key_index[j]
    ring_size: int,
    seed: int = 0,
) -> tuple[TrainState, torch.Tensor]:
    """Whole training run over an explicit (k(j), ticket) pair; returns the
    per-round train losses too. The reference's ``rngs`` are ``keys[i]``
    for ticket i: here the tickets and the ``seed`` of ``round_draws``."""
    from repro_torch.ps.engine import get_trainer

    return get_trainer(cfg, data.bins.device).scan_with(
        data, schedule, key_index, ring_size, seed=seed)
