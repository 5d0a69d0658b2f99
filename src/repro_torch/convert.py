"""Turn the JAX package's parameters, given as numpy arrays, into the port's.

Callers pass ``np.asarray`` of a reference ``Forest``, ``BinnedData`` or
``SparseBins`` field by field, so both packages compute on the same values.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.trees.binning import BinnedData, SparseBins
from repro_torch.trees.forest import Forest


def _tensor(a, dtype, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype), device=dev)  # a writable copy


def forest_from_numpy(
    feature, threshold, leaf_value, n_trees, base_score,
    device: str | torch.device | None = None,
) -> Forest:
    """A ``Forest`` (f32 layout, one output) from numpy arrays."""
    dev = resolve_device(device)

    return Forest(
        feature=_tensor(feature, np.int32, dev),
        threshold=_tensor(threshold, np.int32, dev),
        leaf_value=_tensor(leaf_value, np.float32, dev),
        n_trees=_tensor(n_trees, np.int32, dev).reshape(()),
        base_score=_tensor(base_score, np.float32, dev).reshape(()),
    )


def binned_from_numpy(
    bins, bin_edges, labels, multiplicity, n_bins: int,
    device: str | torch.device | None = None,
) -> BinnedData:
    """A dense ``BinnedData`` from numpy arrays."""
    dev = resolve_device(device)

    return BinnedData(
        bins=_tensor(bins, np.int32, dev),
        bin_edges=_tensor(bin_edges, np.float32, dev),
        labels=_tensor(labels, np.float32, dev),
        multiplicity=_tensor(multiplicity, np.float32, dev),
        n_bins=int(n_bins),
    )


def sparse_from_numpy(
    indices, codes, feat_rows, feat_codes, zero_bin,
    device: str | torch.device | None = None,
) -> SparseBins:
    """A ``SparseBins`` from numpy arrays (the reference's five fields)."""
    dev = resolve_device(device)

    return SparseBins(*(_tensor(a, np.int32, dev) for a in
                        (indices, codes, feat_rows, feat_codes, zero_bin)))
