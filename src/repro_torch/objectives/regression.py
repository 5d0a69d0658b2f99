"""Regression objectives (twin of ``repro.objectives.regression``):
squared error, quantile (pinball), Huber."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.objectives.base import Objective, weighted_mean
from repro_torch.objectives.registry import register
from repro_torch.trees.losses import mse_grad_hess, mse_loss


@register("mse", "squared_error")
@dataclasses.dataclass(frozen=True)
class SquaredError(Objective):
    """l = 0.5 (F - y)^2; init = the multiplicity-weighted label mean."""

    name = "mse"

    def init_score(self, y, weight):
        return (weight * y).sum() / weight.sum()

    def grad_hess(self, y, f, qid=None):
        return mse_grad_hess(y, f)

    def per_example(self, y, f):
        return 0.5 * (f - y) ** 2

    def loss(self, y, f, weight=None, qid=None):
        return mse_loss(y, f, weight)

    def metrics(self, y, f, weight=None, qid=None):
        rmse = torch.sqrt(weighted_mean((f - y) ** 2, weight))
        return {"loss": self.loss(y, f, weight), "rmse": rmse}


@register("quantile", "pinball")
@dataclasses.dataclass(frozen=True)
class Quantile(Objective):
    """Pinball loss for the ``alpha`` quantile.

    The GBM surrogate hessian of 1 is returned (the true second derivative
    is 0 a.e.), so ``exact_hessian`` is False; the gradient is exact a.e.
    """

    alpha: float = 0.5
    name = "quantile"
    exact_hessian = False

    def init_score(self, y, weight):
        """The weighted ``alpha`` quantile of the labels: a stable sort (the
        reference's ``jnp.argsort``), the cumulative weight, and its first
        entry at or above ``alpha`` x the total (``searchsorted``, left)."""
        order = torch.argsort(y, stable=True)
        ys, ws = y[order], weight[order]
        cum = torch.cumsum(ws, 0)
        idx = torch.searchsorted(cum, (self.alpha * cum[-1]).reshape(1))[0]
        return ys[idx.clamp(0, y.shape[0] - 1)]

    def grad_hess(self, y, f, qid=None):
        grad = torch.where(y >= f, torch.full_like(f, -self.alpha),
                           torch.full_like(f, 1.0 - self.alpha))
        return grad, torch.ones_like(f)

    def per_example(self, y, f):
        return torch.where(y >= f, self.alpha * (y - f), (1.0 - self.alpha) * (f - y))

    def metrics(self, y, f, weight=None, qid=None):
        cover = weighted_mean((y <= f).to(f.dtype), weight)  # should approach alpha
        return {"loss": self.loss(y, f, weight), "coverage": cover}


@register("huber")
@dataclasses.dataclass(frozen=True)
class Huber(Objective):
    """Huber loss: quadratic within ``delta`` of the label, linear outside."""

    delta: float = 1.0
    name = "huber"

    def init_score(self, y, weight):
        return (weight * y).sum() / weight.sum()

    def grad_hess(self, y, f, qid=None):
        r = f - y
        inside = r.abs() <= self.delta
        grad = torch.clamp(r, -self.delta, self.delta)
        return grad, torch.where(inside, torch.ones_like(f), torch.zeros_like(f))

    def per_example(self, y, f):
        r = f - y
        inside = r.abs() <= self.delta
        return torch.where(inside, 0.5 * r ** 2, self.delta * (r.abs() - 0.5 * self.delta))

    def metrics(self, y, f, weight=None, qid=None):
        rmse = torch.sqrt(weighted_mean((f - y) ** 2, weight))
        return {"loss": self.loss(y, f, weight), "rmse": rmse}
