"""The Objective protocol (twin of ``repro.objectives.base``).

An objective packages what a loss needs to flow through training and
serving: ``n_outputs`` (K raw scores a sample; the forest fits K trees a
round, and K = 1 keeps the (N,) shapes), ``init_score`` (the optimal
constant model, () or (K,)), ``grad_hess`` (per-sample d/dF and d2/dF2 of
the unweighted ``loss_sum``; the engine applies the importance weights
itself), ``link`` (raw score -> served prediction) and the weighted
``loss``/``metrics``. ``qid`` carries per-sample query ids (ranking);
objectives that do not group samples accept it and ignore it.

The autodiff contract: ``grad_hess(y, f)[0]`` is ``torch.autograd.grad``
of ``loss_sum``, and, where ``exact_hessian``, ``grad_hess(y, f)[1]`` is
the diagonal of its hessian. Objectives whose GBM hessian is a surrogate
(quantile's ones) set ``exact_hessian = False``.
"""
from __future__ import annotations

import torch


class Objective:
    """Base class; see the module docstring for the contract."""

    name: str = "abstract"
    # grad_hess[0] is exactly d loss_sum / dF (a.e.).
    exact_gradient: bool = True
    # grad_hess[1] is exactly the diagonal of d2 loss_sum / dF2 (a.e.).
    exact_hessian: bool = True
    # Sample i's (grad, hess) depend only on (y_i, f_i). Listwise objectives
    # (LambdaRank) mix rows within a query group.
    rowwise: bool = True

    @property
    def n_outputs(self) -> int:
        return 1

    def init_score(self, y, weight):
        raise NotImplementedError

    def grad_hess(self, y, f, qid=None):
        raise NotImplementedError

    def link(self, f):
        return f

    def per_example(self, y, f):
        """Per-sample unweighted loss (N,): separable objectives only."""
        raise NotImplementedError

    def loss_sum(self, y, f, qid=None):
        """Unnormalized total loss: the potential ``grad_hess`` derives."""
        return self.per_example(y, f).sum()

    def loss(self, y, f, weight=None, qid=None):
        """Multiplicity-weighted mean loss (the paper's Eq. 1 normalized)."""
        return weighted_mean(self.per_example(y, f), weight)

    def metrics(self, y, f, weight=None, qid=None):
        return {"loss": self.loss(y, f, weight, qid=qid)}


def weighted_mean(x: torch.Tensor, weight: torch.Tensor | None = None) -> torch.Tensor:
    if weight is None:
        return x.mean()
    return (weight * x).sum() / weight.sum()
