"""Stochastic GBDT config and training state (twin of ``repro.core.sgbdt``).

The functional-space view of the paper: the "parameter" is the prediction
vector F in R^N over the training set; one boosting round is one projected
SGD step on E[L_random(F; Q)].
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.objectives import Objective, get_objective
from repro_torch.trees.binning import BinnedData
from repro_torch.trees.forest import Forest, empty_forest
from repro_torch.trees.learner import LearnerConfig


class SGBDTConfig(NamedTuple):
    n_trees: int = 400  # boosting rounds
    step_length: float = 0.01  # the paper's v
    sampling_rate: float = 0.8  # uniform R
    loss: str = "logistic"  # a registered objective (only "logistic" so far)
    learner: LearnerConfig = LearnerConfig()

    @property
    def obj(self) -> Objective:
        return get_objective(self.loss)


class TrainState(NamedTuple):
    forest: Forest
    f: torch.Tensor  # (N,) current train-set predictions
    step: int  # server update counter j


def init_state(cfg: SGBDTConfig, data: BinnedData) -> TrainState:
    """Server init: the constant tree is the objective's prior."""
    base = cfg.obj.init_score(data.labels, data.multiplicity).float()
    forest = empty_forest(
        cfg.n_trees, cfg.learner.depth, base_score=base, device=data.bins.device
    )
    f = base.expand(data.n_samples).clone()
    return TrainState(forest=forest, f=f, step=0)
