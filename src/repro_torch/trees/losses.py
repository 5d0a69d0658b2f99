"""Logistic loss in the paper's functional-space convention.

Twin of the logistic part of ``repro.trees.losses``: Friedman's two-sided
logit p = e^F / (e^F + e^-F) = sigmoid(2F).
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
