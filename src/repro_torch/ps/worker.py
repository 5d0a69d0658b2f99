"""Worker-parallel tree building (twin of ``repro.ps.worker``): the whole
worker pool a block at a time.

W asynchronous workers build W trees concurrently. A block of W trees can
be built together iff no tree in it depends on a version created inside
it, i.e. k(j) <= block_start for every j in the block; the round-robin
steady state k(j) = j - W + 1 satisfies this for blocks of exactly W.

The port builds a block's lanes one after another on the same kernels,
inputs and draws as the loop form, which is the loop itself. So
``train_worker_parallel`` checks the block condition and runs the
``Trainer``'s loop under the round-robin schedule: its forest is
``ps.engine.train(cfg, data, ("round_robin", W))`` bit for bit (the
reference's vmapped block equals its loop only where no near-tied split
flips). ``build_trees_batched`` builds a block's lanes with
``propose_tree`` and stacks them as the reference's vmap returns them.
One launch of W x L rows a level, the counterpart of the reference's
``vmap``, is ROADMAP.md A5a.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from repro_torch.core.sgbdt import SGBDTConfig, TrainState
from repro_torch.ps.engine import Draws, get_trainer, propose_tree, unpack_draws
from repro_torch.ps.schedules import worker_round_robin
from repro_torch.trees.binning import BinnedData
from repro_torch.trees.tree import Tree


def build_trees_batched(
    cfg: SGBDTConfig,
    data: BinnedData,
    f_targets: Sequence[torch.Tensor],  # W stale targets, each (N,) or (N, K)
    draws: Sequence[Draws],  # W rounds' draws (``engine.round_draws``)
) -> tuple[Tree, torch.Tensor]:
    """All W worker builds of a block: (trees stacked on a leading W axis,
    deltas (W, N), or (W, N, K) for K-output objectives). Each lane is the
    standalone ``propose_tree`` with the same (target, draws), bit for bit."""
    built = []
    for f_target, d in zip(f_targets, draws, strict=True):
        m_prime, _, feat_mask = unpack_draws(d)
        built.append(propose_tree(cfg, data, f_target, None, m_prime, feat_mask))
    trees = Tree(*(torch.stack(parts) for parts in zip(*(t for t, _ in built))))
    return trees, torch.stack([d for _, d in built])


def train_worker_parallel(
    cfg: SGBDTConfig,
    data: BinnedData,
    n_workers: int,
    seed: int = 0,
    eval_every: int = 0,
    eval_fn: Callable[[TrainState, int], None] | None = None,
) -> TrainState:
    """Round-robin W-worker training, the pool a block at a time.

    Equals ``ps.engine.train(cfg, data, ("round_robin", W), seed)`` bit for
    bit (the adaptive step's deflation included). ``eval_every`` is rounded
    up to block boundaries, as in the reference.
    """
    sched = worker_round_robin(cfg.n_trees, n_workers)
    for b0 in range(0, cfg.n_trees, n_workers):
        if (sched[b0:b0 + n_workers] > b0).any():
            raise AssertionError("block depends on in-block version")

    def at_block_end(state: TrainState, b1: int) -> None:
        b0 = (b1 - 1) // n_workers * n_workers
        if (b1 % n_workers == 0 or b1 == cfg.n_trees) and b1 // eval_every > b0 // eval_every:
            eval_fn(state, b1)

    hook = eval_fn is not None and eval_every > 0
    return get_trainer(cfg, data.bins.device).train(
        data, sched, seed=seed, eval_every=1 if hook else 0,
        eval_fn=at_block_end if hook else None)
