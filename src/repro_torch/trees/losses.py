"""Losses, gradients and hessians in the paper's functional-space
convention (twin of ``repro.trees.losses``): Friedman's two-sided logit
p = e^F / (e^F + e^-F) = sigmoid(2F), and squared error.
"""
from __future__ import annotations

import torch


def sigmoid2(f: torch.Tensor) -> torch.Tensor:
    """p = e^F / (e^F + e^-F) = sigmoid(2F)."""
    return torch.sigmoid(2.0 * f)


def logistic_loss(
    y: torch.Tensor, f: torch.Tensor, weight: torch.Tensor | None = None
) -> torch.Tensor:
    """Weighted mean logistic loss (Eq. 1 normalized by sum m_i)."""
    margin = (2.0 * y - 1.0) * f
    per = torch.logaddexp(torch.zeros_like(margin), -2.0 * margin)
    if weight is None:
        return per.mean()
    return (weight * per).sum() / weight.sum()


def logistic_grad_hess(y: torch.Tensor, f: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """grad = 2 (p - y), hess = 4 p (1 - p): both O(1)-bounded."""
    p = sigmoid2(f)
    return 2.0 * (p - y), 4.0 * p * (1.0 - p)


def mse_loss(y: torch.Tensor, f: torch.Tensor, weight: torch.Tensor | None = None) -> torch.Tensor:
    per = 0.5 * (f - y) ** 2
    if weight is None:
        return per.mean()
    return (weight * per).sum() / weight.sum()


def mse_grad_hess(y: torch.Tensor, f: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return f - y, torch.ones_like(f)


# DEPRECATED, as in the reference: the string-keyed loss table predates the
# Objective API (``repro_torch.objectives``); ``SGBDTConfig.loss`` strings
# resolve through ``objectives.get_objective``. Kept for callers of the raw
# functions.
LOSSES = {
    "logistic": (logistic_loss, logistic_grad_hess),
    "mse": (mse_loss, mse_grad_hess),
}
