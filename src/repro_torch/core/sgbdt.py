"""Stochastic GBDT config and training state (twin of ``repro.core.sgbdt``).

The functional-space view of the paper: the "parameter" is the prediction
vector F in R^N (or R^{N x K} for a K-output objective) over the training
set; one boosting round is one projected SGD step on E[L_random(F; Q)].
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.objectives import Objective, get_objective
from repro_torch.trees.binning import BinnedData
from repro_torch.trees.forest import Forest, empty_forest
from repro_torch.trees.learner import LearnerConfig


class SGBDTConfig(NamedTuple):
    n_trees: int = 400  # boosting rounds (x n_outputs trees each)
    step_length: float = 0.01  # the paper's v
    sampling_rate: float = 0.8  # uniform R
    loss: str = "logistic"  # a registered objective; ``objective`` wins when set
    learner: LearnerConfig = LearnerConfig()
    # "gradient": the paper's step (h = m', a leaf is the mean sampled
    # gradient). "newton": xgboost's leaf -G / (H + lam) with the sampled
    # hessian m' h, for the paper's conclusion 2 (Newton leaves do not
    # survive asynchrony).
    step_kind: str = "gradient"
    # An Objective instance or a registry spec ("multiclass:5", "quantile:0.9").
    objective: Objective | str | None = None
    # Staleness-adaptive step (Proposition 1's deflation): > 0 scales each
    # fold's tree by 1 / (1 + 6 * adaptive_step * tau_j), tau_j = j - k(j)
    # the staleness seen at fold time, on the server (``engine.scale_push``).
    # tau = 0 scales by exactly 1.0, so serial training keeps its bits.
    adaptive_step: float = 0.0

    @property
    def obj(self) -> Objective:
        return get_objective(self.objective if self.objective is not None else self.loss)

    @property
    def n_outputs(self) -> int:
        return self.obj.n_outputs


class TrainState(NamedTuple):
    forest: Forest
    f: torch.Tensor  # (N,) or (N, K) current train-set predictions
    step: int  # server update counter j


def init_state(cfg: SGBDTConfig, data: BinnedData) -> TrainState:
    """Server init: the constant tree is the objective's prior
    (``init_score``): log-odds for logistic, the multiplicity-weighted label
    mean for squared error and Huber, the weighted label quantile for
    pinball, log class priors (K,) for multiclass, 0 for ranking."""
    obj = cfg.obj
    base = obj.init_score(data.labels, data.multiplicity).float()
    forest = empty_forest(cfg.n_trees, cfg.learner.depth, base_score=base,
                          n_outputs=obj.n_outputs, device=data.bins.device)
    f = base.expand((data.n_samples,) + tuple(base.shape)).clone()
    return TrainState(forest=forest, f=f, step=0)


def train_serial(
    cfg: SGBDTConfig,
    data: BinnedData,
    seed: int = 0,
    eval_every: int = 0,
    eval_fn: Callable[[TrainState, int], None] | None = None,
) -> TrainState:
    """The paper's serial stochastic GBDT (Fig. 3): the PS engine under the
    zero-staleness schedule ``("round_robin", 1)`` (k(j) = j), on the
    data's device; no loop of its own."""
    from repro_torch.ps.engine import train  # the engine imports this module

    return train(cfg, data, ("round_robin", 1), seed=seed, eval_every=eval_every,
                 eval_fn=eval_fn)


def train_loss(cfg: SGBDTConfig, data: BinnedData, state: TrainState) -> torch.Tensor:
    return cfg.obj.loss(data.labels, state.f, data.multiplicity, qid=data.qid)


def train_metrics(cfg: SGBDTConfig, data: BinnedData, state: TrainState) -> dict:
    """The objective's scalar diagnostics on the training set."""
    return cfg.obj.metrics(data.labels, state.f, data.multiplicity, qid=data.qid)
