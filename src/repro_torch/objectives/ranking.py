"""Pairwise learning to rank over query groups, LambdaRank style (twin of
``repro.objectives.ranking``).

Queries are ``BinnedData.qid`` (int32 a sample); only pairs within one
query with different relevance labels contribute. For a pair where i is
more relevant than j the pair loss is RankNet's logistic
``log(1 + exp(-sigma (F_i - F_j)))``, optionally weighted by the |Delta
DCG| of swapping the pair at the current ranking (LambdaRank). The
weights are detached, so ``grad_hess`` is exactly the autograd gradient
and diagonal hessian of ``loss_sum`` in both modes.

The pairwise field is dense (N, N) and masked: every sum is a plain
reduction, with no float atomics, so a run on the card repeats bit for
bit. At N = 4000 each f32 matrix is 64 MB.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.objectives.base import Objective
from repro_torch.objectives.registry import register


@register("lambdarank", "ranknet")
@dataclasses.dataclass(frozen=True)
class LambdaRank(Objective):
    """Pairwise logistic ranking; ``ndcg_weight`` enables |Delta DCG| pair
    weights (unnormalized: no division by a query's maximum DCG)."""

    sigma: float = 1.0
    ndcg_weight: bool = True
    name = "lambdarank"
    rowwise = False  # pair gradients mix rows within a query group

    def _pair_weights(self, y, f, qid):
        if qid is None:
            raise ValueError(
                "lambdarank needs per-sample query ids: build the dataset "
                "with BinnedData.qid (e.g. data.make_ranking)"
            )
        same = qid[:, None] == qid[None, :]
        pref = same & (y[:, None] > y[None, :])  # i preferred over j
        w = pref.to(f.dtype)
        if self.ndcg_weight:
            # Each doc's 0-based rank within its query (descending score,
            # ties broken by index, so that equal scores still take distinct
            # ranks: otherwise the all-equal initial state has zero |Delta
            # DCG| everywhere and training never starts); the swap cost is
            # |gain_i - gain_j| * |disc_i - disc_j|.
            idx = torch.arange(f.shape[0], device=f.device)
            beats = (f[None, :] > f[:, None]) | (
                (f[None, :] == f[:, None]) & (idx[None, :] < idx[:, None])
            )
            rank = (same & beats).sum(1)
            gain = 2.0 ** y - 1.0
            disc = 1.0 / torch.log2(2.0 + rank.to(f.dtype))
            dg = (gain[:, None] - gain[None, :]).abs() * (disc[:, None] - disc[None, :]).abs()
            w = w * dg.detach()
        return pref, w

    def init_score(self, y, weight):
        return torch.zeros((), dtype=torch.float32, device=y.device)

    def grad_hess(self, y, f, qid=None):
        _, w = self._pair_weights(y, f, qid)
        s = torch.sigmoid(-self.sigma * (f[:, None] - f[None, :]))
        g_pair = -self.sigma * w * s  # d(pair) / dF_i
        h_pair = self.sigma ** 2 * w * s * (1.0 - s)
        grad = g_pair.sum(1) - g_pair.sum(0)
        hess = h_pair.sum(1) + h_pair.sum(0)
        return grad, hess

    def _pair_losses(self, y, f, qid):
        """(pref, w, per-pair loss): the (N, N) matrices, built once."""
        pref, w = self._pair_weights(y, f, qid)
        x = -self.sigma * (f[:, None] - f[None, :])
        return pref, w, torch.logaddexp(torch.zeros_like(x), x)

    def loss_sum(self, y, f, qid=None):
        _, w, pair = self._pair_losses(y, f, qid)
        return (w * pair).sum()

    def loss(self, y, f, weight=None, qid=None):
        """Mean pair loss (multiplicity weights do not apply to pairs)."""
        _, w, pair = self._pair_losses(y, f, qid)
        return (w * pair).sum() / torch.clamp(w.sum(), min=1e-12)

    def metrics(self, y, f, weight=None, qid=None):
        pref, w, pair = self._pair_losses(y, f, qid)
        correct = pref & (f[:, None] > f[None, :])
        n_pref = torch.clamp(pref.sum(), min=1)
        return {
            "loss": (w * pair).sum() / torch.clamp(w.sum(), min=1e-12),
            "pairwise_acc": correct.sum() / n_pref,
        }
