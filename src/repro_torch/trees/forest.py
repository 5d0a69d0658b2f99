"""Fixed-capacity forests: stacked tree arrays + a fill count (twin of
``repro.trees.forest``, f32 layout, one output).

The server's additive model F(x) = base + sum_t v * Tree_t(x). Capacity is
fixed up front (the paper fixes the tree budget T). Unlike the reference's
immutable arrays, ``forest_push`` writes the new slot in place: a push
then costs one tree, not a copy of the forest.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops
from repro_torch.trees.tree import Tree, tree_num_nodes


class Forest(NamedTuple):
    feature: torch.Tensor  # (T, 2^d - 1) int32
    threshold: torch.Tensor  # (T, 2^d - 1) int32
    leaf_value: torch.Tensor  # (T, 2^d) f32 — already scaled by the step length
    n_trees: torch.Tensor  # () int32 — live slots (stays on the device)
    base_score: torch.Tensor  # () f32 init score

    @property
    def depth(self) -> int:
        return int(self.leaf_value.shape[-1]).bit_length() - 1


def empty_forest(
    capacity: int, depth: int, base_score=0.0, device: str | torch.device | None = None
) -> Forest:
    """An all-dead forest of ``capacity`` slots; on the card unless a device
    is given."""
    device = resolve_device(device)
    n_int, n_leaf = tree_num_nodes(depth)
    return Forest(
        feature=torch.zeros((capacity, n_int), dtype=torch.int32, device=device),
        threshold=torch.full((capacity, n_int), 2**30, dtype=torch.int32, device=device),
        leaf_value=torch.zeros((capacity, n_leaf), dtype=torch.float32, device=device),
        n_trees=torch.zeros((), dtype=torch.int32, device=device),
        base_score=torch.as_tensor(base_score, dtype=torch.float32, device=device),
    )


def forest_push(forest: Forest, tree: Tree, step_length: float) -> Forest:
    """Server fold-in F <- F + v * Tree: writes slot ``n_trees`` in place
    (the slot index never leaves the device) and returns the forest with
    the count advanced."""
    slot = forest.n_trees.long().reshape(1)
    forest.feature.index_copy_(0, slot, tree.feature[None])
    forest.threshold.index_copy_(0, slot, tree.threshold[None])
    forest.leaf_value.index_copy_(0, slot, (tree.leaf_value * step_length)[None])
    return forest._replace(n_trees=forest.n_trees + 1)


def forest_predict(forest: Forest, bins: torch.Tensor) -> torch.Tensor:
    """F(x) over binned inputs (N, F) -> (N,); slots >= n_trees predict 0."""
    pred = ops.forest_traverse(
        bins, forest.feature, forest.threshold, forest.leaf_value,
        forest.n_trees, forest.depth,
    )
    return forest.base_score + pred
