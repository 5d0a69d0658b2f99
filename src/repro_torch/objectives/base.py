"""The Objective protocol (twin of ``repro.objectives.base``).

An objective packages what a loss needs to flow through training and
serving: ``n_outputs``, ``init_score`` (the optimal constant model),
``grad_hess`` (per-sample d/dF and d2/dF2 of the unweighted loss; the
engine applies the importance weights itself), ``link`` (raw score ->
served prediction) and the weighted ``loss``/``metrics``.
"""
from __future__ import annotations

import torch


class Objective:
    """Base class; see the module docstring for the contract."""

    name: str = "abstract"

    @property
    def n_outputs(self) -> int:
        return 1

    def init_score(self, y, weight):
        raise NotImplementedError

    def grad_hess(self, y, f):
        raise NotImplementedError

    def link(self, f):
        return f

    def loss(self, y, f, weight=None):
        raise NotImplementedError

    def metrics(self, y, f, weight=None):
        return {"loss": self.loss(y, f, weight)}


def weighted_mean(x: torch.Tensor, weight: torch.Tensor | None = None) -> torch.Tensor:
    if weight is None:
        return x.mean()
    return (weight * x).sum() / weight.sum()
