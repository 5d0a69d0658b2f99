"""Level-wise histogram tree learner, staged (twin of ``repro.trees.learner``).

One tree build = ``depth`` levels; each level builds per-node grad/hess
histograms, scans them into the gain surface, takes the first-max argmax
under the feature mask and re-routes the samples. The histogram and gain
stages are the hand-written kernels on the card (``kernels.ops``).

Histogram modes (``LearnerConfig.hist_mode``):
  * ``'subtract'`` (default) — below the root only the smaller child of
    every parent (by hessian mass, the drawn-sample count) is
    histogrammed; its sibling is ``parent - built``.
  * ``'rebuild'`` — every node of every level is histogrammed.

Every sum here is taken without float atomics, so a build on the card
gives the same bits run after run.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops
from repro_torch.trees.tree import Tree


class LearnerConfig(NamedTuple):
    depth: int = 7  # 2^depth leaves
    n_bins: int = 64
    lam: float = 1.0  # L2 on leaf values
    min_child_hess: float = 1e-3
    feature_fraction: float = 0.8  # share of features drawn per tree
    hist_mode: str = "subtract"  # 'subtract' | 'rebuild'


def segment_sum(vals: torch.Tensor, seg: torch.Tensor, n_segments: int) -> torch.Tensor:
    """(n_segments,) sums of ``vals`` by segment id, as masked row sums.

    ``index_add_``/``scatter_add_`` on CUDA floats add with atomics in an
    order that changes from run to run; a masked (n_segments, N) reduction
    takes a fixed order. Its memory grows as n_segments * N, which is small
    at the trees' widths (512 leaves x 4000 samples is 8 MB).
    """
    ids = torch.arange(n_segments, device=seg.device)
    onehot = seg[None, :].long() == ids[:, None]
    return torch.where(onehot, vals[None, :], torch.zeros_like(vals)[None, :]).sum(1)


def _smaller_children(node: torch.Tensor, h: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """Each parent's child with less hessian mass, (n_nodes // 2,) int32
    (ties pick the even child)."""
    counts = segment_sum(h, node, n_nodes)
    parents = torch.arange(n_nodes // 2, dtype=torch.int32, device=node.device)
    return 2 * parents + (counts[0::2] > counts[1::2]).to(torch.int32)


def _level_histogram(
    cfg: LearnerConfig,
    bins: torch.Tensor,
    node: torch.Tensor,
    g: torch.Tensor,
    h: torch.Tensor,
    level: int,
    parent_hist: torch.Tensor | None,
) -> torch.Tensor:
    """The (2, 2^level, F, B) histogram of one level, by the config's mode."""
    n_nodes = 1 << level
    if cfg.hist_mode == "rebuild" or level == 0:
        return ops.build_histogram(bins, node, g, h, n_nodes, cfg.n_bins)
    active = _smaller_children(node, h, n_nodes)
    built = ops.build_histogram_subset(bins, node, g, h, active, n_nodes, cfg.n_bins)
    # Node n (parent p = n >> 1) is either the built child or the sibling
    # derived as parent - built.
    ids = torch.arange(n_nodes, device=bins.device)
    par_of = ids >> 1
    is_built = ids == active[par_of].long()
    built_rows = built[:, par_of]
    sibling_rows = parent_hist[:, par_of] - built_rows
    return torch.where(is_built[None, :, None, None], built_rows, sibling_rows)


def build_tree(
    cfg: LearnerConfig,
    bins: torch.Tensor,  # (N, F) int32
    g: torch.Tensor,  # (N,) f32 weighted gradient target
    h: torch.Tensor,  # (N,) f32 weighted hessian / sample weight
    feat_mask: torch.Tensor,  # (F,) bool — the features this tree may split on
) -> Tree:
    if cfg.hist_mode not in ("subtract", "rebuild"):
        raise ValueError(f"unknown hist_mode {cfg.hist_mode!r} (want 'subtract'|'rebuild')")
    n = bins.shape[0]
    n_bins = cfg.n_bins
    node = torch.zeros(n, dtype=torch.int32, device=bins.device)  # level-local ids
    features, thresholds = [], []
    hist = None  # the previous level's histograms (the subtraction cache)
    for level in range(cfg.depth):
        n_nodes = 1 << level
        hist = _level_histogram(cfg, bins, node, g, h, level, hist)
        gain = ops.split_gain(hist, cfg.lam, cfg.min_child_hess)
        gain = gain.masked_fill(~feat_mask[None, :, None], float("-inf"))
        flat = gain.reshape(n_nodes, -1)
        idx = torch.argmax(flat, dim=-1)  # the first maximum, as jnp.argmax
        best = flat.gather(1, idx[:, None])[:, 0]
        # Unsplittable node -> pass-through: all samples go left.
        ok = torch.isfinite(best) & (best > 0.0)
        feat = torch.where(ok, idx // n_bins, 0).to(torch.int32)
        thr = torch.where(ok, idx % n_bins, n_bins - 1).to(torch.int32)
        nodel = node.long()
        val = bins.gather(1, feat.long()[nodel][:, None])[:, 0]
        node = 2 * node + (val > thr[nodel]).to(torch.int32)
        features.append(feat)
        thresholds.append(thr)

    n_leaves = 1 << cfg.depth
    leaf_g = segment_sum(g, node, n_leaves)
    leaf_h = segment_sum(h, node, n_leaves)
    leaf_value = -leaf_g / (leaf_h + cfg.lam)
    leaf_value = torch.where(leaf_h > 0, leaf_value, torch.zeros_like(leaf_value))
    return Tree(
        feature=torch.cat(features),
        threshold=torch.cat(thresholds),
        leaf_value=leaf_value.float(),
    )
