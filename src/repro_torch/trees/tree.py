"""Dense heap-indexed decision trees (twin of ``repro.trees.tree``).

A depth-``d`` tree is stored as flat arrays: internal nodes 0..2^d-2 in
level order (children of i are 2i+1 / 2i+2), leaves are the 2^d slots of
the final level. Unsplittable nodes are pass-through splits (all left).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.trees.binning import SparseBins, gather_feature_bins


class Tree(NamedTuple):
    """feature/threshold (2^d - 1,) int32 (left iff bin <= threshold);
    leaf_value (2^d,) f32."""

    feature: torch.Tensor
    threshold: torch.Tensor
    leaf_value: torch.Tensor

    @property
    def depth(self) -> int:
        return int(self.leaf_value.shape[-1]).bit_length() - 1


def tree_num_nodes(depth: int) -> tuple[int, int]:
    """(n_internal, n_leaves) for a full tree of the given depth."""
    return (1 << depth) - 1, 1 << depth


def leaf_indices(tree: Tree, bins: torch.Tensor | SparseBins) -> torch.Tensor:
    """Route samples (N, F) to leaf indices (N,) int64 by a depth-step heap
    walk; each step reads its bin through ``gather_feature_bins``, so the
    dense and the sparse layout route alike."""
    feature = tree.feature.long()
    node = torch.zeros(bins.shape[0], dtype=torch.int64, device=bins.device)
    for _ in range(tree.depth):
        val = gather_feature_bins(bins, feature[node])
        node = 2 * node + 1 + (val > tree.threshold[node]).long()
    return node - ((1 << tree.depth) - 1)


def apply_tree(tree: Tree, bins: torch.Tensor | SparseBins) -> torch.Tensor:
    """Predict (N,) f32 for binned inputs (N, F), dense or sparse."""
    return tree.leaf_value[leaf_indices(tree, bins)]
