"""The paper's symmetric-logit binary objective (twin of
``repro.objectives.classification.BinaryLogistic``)."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.objectives.base import Objective, weighted_mean
from repro_torch.objectives.registry import register
from repro_torch.trees.losses import logistic_grad_hess, logistic_loss, sigmoid2


@register("logistic", "binary_logistic")
@dataclasses.dataclass(frozen=True)
class BinaryLogistic(Objective):
    """p = sigmoid(2F); grad = 2(p - y), hess = 4p(1 - p)."""

    name = "logistic"

    def init_score(self, y, weight):
        ybar = (weight * y).sum() / weight.sum()
        ybar = torch.clamp(ybar, 1e-6, 1.0 - 1e-6)
        return 0.5 * torch.log(ybar / (1.0 - ybar))

    def grad_hess(self, y, f):
        return logistic_grad_hess(y, f)

    def link(self, f):
        return sigmoid2(f)

    def loss(self, y, f, weight=None):
        return logistic_loss(y, f, weight)

    def metrics(self, y, f, weight=None):
        acc = weighted_mean(((f > 0.0) == (y > 0.5)).float(), weight)
        return {"loss": self.loss(y, f, weight), "accuracy": acc}
