"""Feature quantization into histogram bins (dense layout).

Twin of ``repro.trees.binning``: features are quantized once per dataset
into at most ``n_bins`` integer bins, and split search runs over bin
boundaries. The sparse layout is not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device


class BinnedData(NamedTuple):
    """A quantized dataset.

    Attributes:
      bins: (N, F) int32 bin ids in [0, n_bins).
      bin_edges: (F, n_bins - 1) float32 upper bin edges (last bin open).
      labels: (N,) float32.
      multiplicity: (N,) float32 — the paper's m_i.
      n_bins: static int.
    """

    bins: torch.Tensor
    bin_edges: torch.Tensor
    labels: torch.Tensor
    multiplicity: torch.Tensor
    n_bins: int

    @property
    def n_samples(self) -> int:
        return self.bins.shape[0]

    @property
    def n_features(self) -> int:
        return self.bins.shape[1]


def make_bins(x: np.ndarray, n_bins: int = 256) -> np.ndarray:
    """Per-feature quantile bin edges, (F, n_bins - 1) float32. Host-side,
    once per dataset; degenerate features get repeated edges."""
    qs = np.linspace(0.0, 1.0, n_bins + 1)[1:-1]
    edges = np.quantile(x, qs, axis=0).T.astype(np.float32)  # (F, n_bins-1)
    return np.ascontiguousarray(edges)


def apply_bins(x: torch.Tensor, bin_edges: torch.Tensor, nan_bin: int = 0) -> torch.Tensor:
    """Map raw features (N, F) onto bin ids (N, F) int32 by a left-side
    batched ``searchsorted``.

    ``-inf`` lands in bin 0 and ``+inf`` in the last bin (they are below or
    above every edge); ``NaN`` routes to ``nan_bin`` so a malformed row
    never reads as a very large feature.
    """
    ids = torch.searchsorted(
        bin_edges.contiguous(), x.t().contiguous(), right=False, out_int32=True
    ).t()
    return torch.where(torch.isnan(x), torch.full_like(ids, nan_bin), ids).contiguous()


def bin_dataset(
    x: np.ndarray,
    y: np.ndarray,
    n_bins: int = 256,
    multiplicity: np.ndarray | None = None,
    device: str | torch.device | None = None,
) -> BinnedData:
    """One-shot dataset quantization onto ``device`` (the card by default)."""
    dev = resolve_device(device)
    edges = make_bins(x, n_bins)
    edges_t = torch.as_tensor(edges, device=dev)
    bins = apply_bins(torch.as_tensor(np.asarray(x, np.float32), device=dev), edges_t)
    if multiplicity is None:
        multiplicity = np.ones(x.shape[0], np.float32)
    return BinnedData(
        bins=bins,
        bin_edges=edges_t,
        labels=torch.as_tensor(np.asarray(y, np.float32), device=dev),
        multiplicity=torch.as_tensor(np.asarray(multiplicity, np.float32), device=dev),
        n_bins=n_bins,
    )
