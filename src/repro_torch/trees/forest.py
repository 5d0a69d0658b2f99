"""Fixed-capacity forests: stacked tree arrays + a fill count (twin of
``repro.trees.forest``).

The server's additive model F(x) = base + sum_t v * Tree_t(x). Capacity is
fixed up front (the paper fixes the tree budget T). A K-output objective
fits K trees a round; they take K consecutive slots (slot = round * K + k,
round-major, output-minor), so ``n_trees`` counts live slots and slot t
adds into output t % K. The output count comes from ``base_score``'s
shape: () for one output, (K,) otherwise.

Unlike the reference's immutable arrays, ``forest_push`` writes the new
slots in place: a push then costs its trees, not a copy of the forest.

``Forest.quantize`` packs the serving payload (``QuantizedForest``): int8
thresholds with int8 leaves times a per-tree scale, or int16 thresholds
with fp16 leaves; the traversal kernel dequantizes as it reads.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops
from repro_torch.trees.tree import Tree, tree_num_nodes


class Forest(NamedTuple):
    feature: torch.Tensor  # (T, 2^d - 1) int32; T = capacity * n_outputs slots
    threshold: torch.Tensor  # (T, 2^d - 1) int32
    leaf_value: torch.Tensor  # (T, 2^d) f32 — already scaled by the step length
    n_trees: torch.Tensor  # () int32 — live slots (stays on the device)
    base_score: torch.Tensor  # () f32 init score, or (K,) for K outputs

    @property
    def depth(self) -> int:
        return int(self.leaf_value.shape[-1]).bit_length() - 1

    @property
    def n_outputs(self) -> int:
        return int(self.base_score.shape[-1]) if self.base_score.ndim else 1

    def quantize(self, mode: str = "int8") -> "QuantizedForest":
        """The packed serving payload (reference ``Forest.quantize``):

        - ``"int8"``: thresholds (bin ids) in int8, exact when every live
          one is <= 127 (raises otherwise); leaves ``round(leaf / scale)``
          with one f32 ``scale = max|leaf| / 127`` a tree (1 for an all-zero
          tree), so a score moves at most ``sum_t scale_t / 2``.
        - ``"fp16"``: thresholds in int16 (live ones <= 32767), leaves
          rounded to float16.

        Dead slots (>= ``n_trees``) are masked at traversal time, so their
        thresholds are zeroed rather than range-checked. Reads ``n_trees``
        and the largest threshold on the host: a load-time operation.
        """
        if mode not in ("int8", "fp16"):
            raise ValueError(f"quantize mode must be 'int8' or 'fp16', got {mode!r}")
        slots = self.feature.shape[0]
        live = torch.arange(slots, device=self.feature.device) < self.n_trees
        thr = torch.where(live[:, None], self.threshold, torch.zeros_like(self.threshold))
        top = int(thr.max()) if thr.numel() else 0
        if mode == "fp16":
            if top > 32767:
                raise ValueError("fp16 mode stores thresholds as int16: live "
                                 "bin ids must be <= 32767")
            return QuantizedForest(
                feature=self.feature,
                threshold=thr.to(torch.int16),
                leaf_value=self.leaf_value.to(torch.float16),
                leaf_scale=torch.ones(slots, dtype=torch.float32, device=self.feature.device),
                n_trees=self.n_trees,
                base_score=self.base_score,
            )
        if top > 127:
            raise ValueError(
                "int8 mode stores thresholds as int8: live bin ids must be "
                "<= 127 (use n_bins <= 128, or mode='fp16')"
            )
        peak = self.leaf_value.abs().amax(dim=1)
        scale = torch.where(peak > 0, peak / 127.0, torch.ones_like(peak)).to(torch.float32)
        q = torch.clamp(torch.round(self.leaf_value / scale[:, None]), -127, 127)
        return QuantizedForest(
            feature=self.feature,
            threshold=thr.to(torch.int8),
            leaf_value=q.to(torch.int8),
            leaf_scale=scale,
            n_trees=self.n_trees,
            base_score=self.base_score,
        )


class QuantizedForest(NamedTuple):
    """A ``Forest`` with a packed traversal payload (``Forest.quantize``).
    The mode follows ``leaf_value``'s dtype: int8 (scaled by ``leaf_scale``)
    or float16."""

    feature: torch.Tensor  # (T, 2^d - 1) int32
    threshold: torch.Tensor  # (T, 2^d - 1) int8 (int8 mode) or int16 (fp16)
    leaf_value: torch.Tensor  # (T, 2^d) int8 or float16
    leaf_scale: torch.Tensor  # (T,) f32 per-tree scale (ones for fp16)
    n_trees: torch.Tensor  # () int32 — live slots
    base_score: torch.Tensor  # () or (K,) f32, never quantized

    @property
    def depth(self) -> int:
        return int(self.leaf_value.shape[-1]).bit_length() - 1

    @property
    def n_outputs(self) -> int:
        return int(self.base_score.shape[-1]) if self.base_score.ndim else 1

    @property
    def mode(self) -> str:
        return "int8" if self.leaf_value.dtype == torch.int8 else "fp16"

    def dequantize(self) -> Forest:
        """The f32 forest the payload encodes (dead-slot thresholds come back
        as 0, which the ``n_trees`` mask hides)."""
        leaf = self.leaf_value.to(torch.float32)
        if self.leaf_value.dtype == torch.int8:
            leaf = leaf * self.leaf_scale[:, None]
        return Forest(
            feature=self.feature,
            threshold=self.threshold.to(torch.int32),
            leaf_value=leaf,
            n_trees=self.n_trees,
            base_score=self.base_score,
        )


def quantization_atol(forest: Forest, quantized: QuantizedForest) -> float:
    """The bound on |quantized score - f32 score| of any sample and output:
    the sum over live trees of each tree's worst leaf error (a sample reads
    one leaf a tree)."""
    deq = quantized.dequantize()
    err = (deq.leaf_value - forest.leaf_value).abs().amax(dim=1)
    live = torch.arange(forest.feature.shape[0], device=err.device) < forest.n_trees
    return float(torch.where(live, err, torch.zeros_like(err)).sum())


def empty_forest(
    capacity: int, depth: int, base_score=0.0, n_outputs: int = 1,
    device: str | torch.device | None = None,
) -> Forest:
    """An all-dead forest of ``capacity`` rounds x ``n_outputs`` trees; on
    the card unless a device is given."""
    device = resolve_device(device)
    n_int, n_leaf = tree_num_nodes(depth)
    base = torch.as_tensor(base_score, dtype=torch.float32, device=device)
    if n_outputs > 1:
        base = base.expand(n_outputs).clone()
    slots = capacity * n_outputs
    return Forest(
        feature=torch.zeros((slots, n_int), dtype=torch.int32, device=device),
        threshold=torch.full((slots, n_int), 2**30, dtype=torch.int32, device=device),
        leaf_value=torch.zeros((slots, n_leaf), dtype=torch.float32, device=device),
        n_trees=torch.zeros((), dtype=torch.int32, device=device),
        base_score=base,
    )


def forest_push(forest: Forest, tree: Tree, step_length: float) -> Forest:
    """Server fold-in F <- F + v * Tree: writes slot ``n_trees`` (one tree)
    or the K slots from it (a stacked group of K trees) in place. The slot
    index never leaves the device; returns the forest with the count
    advanced."""
    group = tree.leaf_value.ndim == 2
    k = tree.leaf_value.shape[0] if group else 1
    slots = forest.n_trees.long() + torch.arange(k, device=forest.n_trees.device)
    parts = tree if group else Tree(*(a[None] for a in tree))
    forest.feature.index_copy_(0, slots, parts.feature)
    forest.threshold.index_copy_(0, slots, parts.threshold)
    forest.leaf_value.index_copy_(0, slots, parts.leaf_value * step_length)
    return forest._replace(n_trees=forest.n_trees + k)


def forest_predict(forest: Forest | QuantizedForest, bins: torch.Tensor) -> torch.Tensor:
    """F(x) over binned inputs (N, F) -> (N,), or (N, K) for K outputs;
    slots >= n_trees predict 0. A ``QuantizedForest`` is dequantized by the
    traversal as it reads."""
    pred = ops.forest_traverse(
        bins, forest.feature, forest.threshold, forest.leaf_value,
        forest.n_trees, forest.depth, n_outputs=forest.n_outputs,
        leaf_scale=getattr(forest, "leaf_scale", None),
    )
    return forest.base_score + pred
