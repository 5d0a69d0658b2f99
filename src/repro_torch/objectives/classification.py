"""Classification objectives (twin of ``repro.objectives.classification``):
the paper's symmetric-logit binary loss and K-output multiclass softmax."""
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

    def grad_hess(self, y, f, qid=None):
        return logistic_grad_hess(y, f)

    def link(self, f):
        return sigmoid2(f)

    def per_example(self, y, f):
        margin = (2.0 * y - 1.0) * f
        return torch.logaddexp(torch.zeros_like(margin), -2.0 * margin)

    def loss(self, y, f, weight=None, qid=None):
        return logistic_loss(y, f, weight)

    def metrics(self, y, f, weight=None, qid=None):
        acc = weighted_mean(((f > 0.0) == (y > 0.5)).float(), weight)
        return {"loss": self.loss(y, f, weight), "accuracy": acc}


@register("multiclass", "softmax")
@dataclasses.dataclass(frozen=True)
class MulticlassSoftmax(Objective):
    """K-class cross-entropy over K raw scores a sample.

    One tree a class a round fits the (N, K) field g = p - onehot(y);
    h = p(1 - p) is the exact diagonal of the cross-entropy's hessian.
    Labels are class ids stored as floats.
    """

    n_classes: int = 3
    name = "multiclass"

    @property
    def n_outputs(self) -> int:
        return self.n_classes

    def _onehot(self, y):
        return torch.nn.functional.one_hot(y.long(), self.n_classes).to(torch.float32)

    def init_score(self, y, weight):
        prior = (weight[:, None] * self._onehot(y)).sum(0) / weight.sum()
        return torch.log(torch.clamp(prior, 1e-6, 1.0))

    def grad_hess(self, y, f, qid=None):
        p = torch.softmax(f, dim=-1)
        return p - self._onehot(y), p * (1.0 - p)

    def link(self, f):
        return torch.softmax(f, dim=-1)

    def per_example(self, y, f):
        return -(self._onehot(y) * torch.log_softmax(f, dim=-1)).sum(-1)

    def metrics(self, y, f, weight=None, qid=None):
        acc = weighted_mean((torch.argmax(f, dim=-1) == y.long()).float(), weight)
        return {"loss": self.loss(y, f, weight), "accuracy": acc}
