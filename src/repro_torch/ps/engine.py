"""The parameter-server training engine (twin of ``repro.ps.engine``).

Algorithm 3 splits a boosting round across the PS roles:

  worker — pull a (possibly stale) prediction vector F^{k(j)}, draw the
           Bernoulli subdataset Q, build the gradient target, fit a tree
           (``propose_tree``);
  server — fold the pushed tree into the live state F <- F + v * Tree
           (``server_fold``).

``round_body`` composes the two. ``Trainer.train`` runs it in a Python
loop under any delay schedule, keeping a ring of the last F versions.

Randomness comes from a ``torch.Generator`` seeded from ``seed``. It
cannot reproduce ``jax.random``'s bits, so ``propose_tree`` and
``Trainer.train`` also take injected per-round draws (``m_prime`` (N,),
``feat_mask`` (F,)): the parity tests recompute the reference's draws and
hand them in.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.core.sgbdt import SGBDTConfig, TrainState, init_state
from repro_torch.data.sampling import bernoulli_weights
from repro_torch.ps.schedules import max_staleness, resolve_schedule
from repro_torch.trees.binning import BinnedData
from repro_torch.trees.forest import Forest, forest_push
from repro_torch.trees.learner import build_tree, build_tree_multi
from repro_torch.trees.tree import Tree, apply_tree, apply_tree_stack

# One round's draws: (m_prime (N,) f32, feat_mask (F,) bool).
Draws = tuple[torch.Tensor, torch.Tensor]


def propose_tree(
    cfg: SGBDTConfig,
    data: BinnedData,
    f_target: torch.Tensor,
    gen: torch.Generator | None = None,
    m_prime: torch.Tensor | None = None,
    feat_mask: torch.Tensor | None = None,
) -> tuple[Tree, torch.Tensor]:
    """Worker side: sample Q -> build target from F^{k(j)} -> fit a tree.

    Returns the tree and its prediction delta on the training bins (the
    push payload). A K-output objective fits K trees against the (N, K)
    field, one stacked group with an (N, K) delta: still one push, and one
    (m', mask) draw a round. The step length v scales the leaf table HERE,
    before the gather, so the server fold is a pure add (engine.py:73-81
    of the reference). Draws not injected come from ``gen``: Bernoulli
    weights first, then the feature mask.
    """
    obj = cfg.obj
    if m_prime is None:
        m_prime, _ = bernoulli_weights(gen, cfg.sampling_rate, data.multiplicity)
    if feat_mask is None:
        n_feat = data.n_features
        if cfg.learner.feature_fraction < 1.0:
            u = torch.rand(n_feat, generator=gen, device=data.bins.device)
            feat_mask = u < cfg.learner.feature_fraction
        else:
            feat_mask = torch.ones(n_feat, dtype=torch.bool, device=data.bins.device)
    g, _ = obj.grad_hess(data.labels, f_target)
    v = torch.tensor(cfg.step_length, dtype=torch.float32, device=g.device)
    # The paper's gradient step: h_i = m'_i (broadcast over the K outputs),
    # so a leaf is the mean sampled gradient.
    if obj.n_outputs == 1:
        tree = build_tree(cfg.learner, data.bins, m_prime * g, m_prime, feat_mask.bool())
        tree = tree._replace(leaf_value=v * tree.leaf_value)
        return tree, apply_tree(tree, data.bins)
    trees = build_tree_multi(cfg.learner, data.bins, m_prime[:, None] * g,
                             m_prime[:, None].expand_as(g), feat_mask.bool())
    trees = trees._replace(leaf_value=v * trees.leaf_value)
    return trees, apply_tree_stack(trees, data.bins)


def server_fold(
    forest: Forest, f_live: torch.Tensor, tree: Tree, delta: torch.Tensor
) -> tuple[Forest, torch.Tensor]:
    """Server side: F <- F + v * Tree (one tree, or a K-output group into K
    slots). The leaves arrive pre-scaled by v, so this is a slot write plus
    a pure add."""
    return forest_push(forest, tree, 1.0), f_live + delta


def round_body(
    cfg: SGBDTConfig,
    data: BinnedData,
    forest: Forest,
    f_live: torch.Tensor,
    f_target: torch.Tensor,
    gen: torch.Generator | None = None,
    draws: Draws | None = None,
) -> tuple[Forest, torch.Tensor]:
    """One boosting round: the tree is built against (possibly stale)
    ``f_target`` but folded into the live server state."""
    m_prime, feat_mask = draws if draws is not None else (None, None)
    tree, delta = propose_tree(cfg, data, f_target, gen, m_prime, feat_mask)
    return server_fold(forest, f_live, tree, delta)


class Trainer:
    """Single-device parameter-server GBDT trainer (the loop form).

    Runs on the card unless ``device`` is given; without a GPU and without
    a ``device`` it raises.
    """

    def __init__(self, cfg: SGBDTConfig, *, device: str | torch.device | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)

    def train(
        self,
        data: BinnedData,
        schedule=("round_robin", 1),
        seed: int = 0,
        eval_every: int = 0,
        eval_fn: Callable[[TrainState, int], None] | None = None,
        draws: Sequence[Draws] | None = None,
        rounds: int | None = None,
    ) -> TrainState:
        """Python-loop execution with per-round eval hooks. ``draws[j]``,
        when given, replaces round j's random draws. ``rounds`` stops after
        that many rounds of the schedule (default: all ``cfg.n_trees``);
        the forest keeps its full ``cfg.n_trees`` slots either way."""
        cfg = self.cfg
        if data.bins.device != self.device:
            raise ValueError(f"data lies on {data.bins.device}, trainer on {self.device}")
        sched = resolve_schedule(schedule, cfg.n_trees)
        rounds = cfg.n_trees if rounds is None else rounds
        if not 0 <= rounds <= cfg.n_trees:
            raise ValueError(f"rounds must lie in [0, {cfg.n_trees}], got {rounds}")
        ring_size = max_staleness(sched) + 1
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        state = init_state(cfg, data)
        forest, f = state.forest, state.f
        ring = [f] * ring_size  # the last ring_size versions of F ((N,) or (N, K))
        for j in range(rounds):
            f_target = ring[int(sched[j]) % ring_size]
            forest, f = round_body(
                cfg, data, forest, f, f_target, gen,
                None if draws is None else draws[j],
            )
            ring[(j + 1) % ring_size] = f
            if eval_fn is not None and eval_every and (j + 1) % eval_every == 0:
                eval_fn(TrainState(forest, f, j + 1), j + 1)
        return TrainState(forest=forest, f=f, step=rounds)


# One cached Trainer per (config, device), LRU-bounded: a sweep over many
# configs keeps at most _TRAINERS_MAX of them.
_TRAINERS: "OrderedDict[tuple[SGBDTConfig, torch.device], Trainer]" = OrderedDict()
_TRAINERS_MAX = 8


def get_trainer(cfg: SGBDTConfig, device: str | torch.device | None = None) -> Trainer:
    """The cached ``Trainer`` of ``cfg`` on ``device`` (the card unless one
    is given)."""
    key = (cfg, resolve_device(device))
    trainer = _TRAINERS.get(key)
    if trainer is None:
        trainer = _TRAINERS[key] = Trainer(cfg, device=key[1])
        while len(_TRAINERS) > _TRAINERS_MAX:
            _TRAINERS.popitem(last=False)
    else:
        _TRAINERS.move_to_end(key)
    return trainer


def clear_trainers() -> None:
    """Drop every cached Trainer."""
    _TRAINERS.clear()


def train(
    cfg: SGBDTConfig,
    data: BinnedData,
    schedule=("round_robin", 1),
    seed: int = 0,
    eval_every: int = 0,
    eval_fn: Callable[[TrainState, int], None] | None = None,
) -> TrainState:
    """Functional convenience over the cached Trainer of ``cfg`` on the
    data's device."""
    return get_trainer(cfg, data.bins.device).train(
        data, schedule, seed=seed, eval_every=eval_every, eval_fn=eval_fn)
