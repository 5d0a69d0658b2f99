"""Level-wise histogram tree learner (twin of ``repro.trees.learner``).

One tree build = ``depth`` levels; each level builds per-node grad/hess
histograms, scans them into the gain surface, takes the first-max argmax
under the feature mask and re-routes the samples.

Histogram modes (``LearnerConfig.hist_mode``):
  * ``'subtract'`` (default) — below the root only the smaller child of
    every parent (by hessian mass, the drawn-sample count) is
    histogrammed; its sibling is ``parent - built``.
  * ``'rebuild'`` — every node of every level is histogrammed.

Backends (``LearnerConfig.backend``):
  * ``'staged'`` (default) — histogram kernel, sibling derivation, split-gain
    kernel, argmax and partition, each a step of its own (``kernels.ops``);
  * ``'fused'`` — each level whose resident set fits the budget
    (``kernels.level_build.fused_level_fits``) is one fused level
    (``kernels.level_build``); the other levels run staged. The fused level
    gives the staged level's bits, so the two backends build the same tree.
    The sparse layout always runs staged (the fused level reads dense bins).
Either way the device decides kernel versus plain version, as everywhere in
the port. Every sum here is taken without float atomics, so a build on the
card gives the same bits run after run.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import level_build as _level_build
from repro_torch.kernels import ops
from repro_torch.kernels.ops import segment_sum
from repro_torch.trees.binning import SparseBins, gather_feature_bins
from repro_torch.trees.tree import Tree

BACKENDS = ("staged", "fused")


class LearnerConfig(NamedTuple):
    depth: int = 7  # 2^depth leaves
    n_bins: int = 64
    lam: float = 1.0  # L2 on leaf values
    min_child_hess: float = 1e-3
    feature_fraction: float = 0.8  # share of features drawn per tree
    hist_mode: str = "subtract"  # 'subtract' | 'rebuild'
    backend: str = "staged"  # 'staged' | 'fused'


def _smaller_children(node: torch.Tensor, h: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """Each parent's child with less hessian mass, (n_nodes // 2,) int32
    (ties pick the even child)."""
    counts = segment_sum(h, node, n_nodes)
    parents = torch.arange(n_nodes // 2, dtype=torch.int32, device=node.device)
    return 2 * parents + (counts[0::2] > counts[1::2]).to(torch.int32)


def _level_histogram(
    cfg: LearnerConfig,
    bins: torch.Tensor | SparseBins,
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
    ids = torch.arange(n_nodes, device=node.device)
    par_of = ids >> 1
    is_built = ids == active[par_of].long()
    built_rows = built[:, par_of]
    sibling_rows = parent_hist[:, par_of] - built_rows
    return torch.where(is_built[None, :, None, None], built_rows, sibling_rows)


def _staged_level(
    cfg: LearnerConfig,
    bins: torch.Tensor | SparseBins,
    node: torch.Tensor,
    g: torch.Tensor,
    h: torch.Tensor,
    feat_mask: torch.Tensor,  # (F,) bool
    level: int,
    parent_hist: torch.Tensor | None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One level as separate steps: (hist, feat, thr, new_node)."""
    n_nodes, n_bins = 1 << level, cfg.n_bins
    hist = _level_histogram(cfg, bins, node, g, h, level, parent_hist)
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
    val = gather_feature_bins(bins, feat.long()[nodel])
    return hist, feat, thr, 2 * node + (val > thr[nodel]).to(torch.int32)


def _fused_level(
    cfg: LearnerConfig,
    bins: torch.Tensor,
    node: torch.Tensor,
    g: torch.Tensor,
    h: torch.Tensor,
    mask_i32: torch.Tensor,  # (F,) int32
    level: int,
    parent_hist: torch.Tensor | None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One level as one fused level (``kernels.level_build``); the same
    returns as ``_staged_level``."""
    n_nodes = 1 << level
    derive = cfg.hist_mode == "subtract" and level > 0
    if derive:
        active = _smaller_children(node, h, n_nodes)
    else:
        active = torch.arange(n_nodes, dtype=torch.int32, device=node.device)
    hist, feat, thr, _, new_node = ops.level_build(
        bins, node, g, h, active, parent_hist if derive else None, mask_i32,
        cfg.lam, cfg.min_child_hess, n_nodes, cfg.n_bins, derive_sibling=derive,
    )
    return hist, feat, thr, new_node


def build_tree(
    cfg: LearnerConfig,
    bins: torch.Tensor | SparseBins,  # (N, F) int32 or the sparse layout
    g: torch.Tensor,  # (N,) f32 weighted gradient target
    h: torch.Tensor,  # (N,) f32 weighted hessian / sample weight
    feat_mask: torch.Tensor,  # (F,) bool — the features this tree may split on
) -> Tree:
    if cfg.hist_mode not in ("subtract", "rebuild"):
        raise ValueError(f"unknown hist_mode {cfg.hist_mode!r} (want 'subtract'|'rebuild')")
    if cfg.backend not in BACKENDS:
        raise ValueError(f"unknown backend {cfg.backend!r} (want one of {BACKENDS})")
    n, n_feat = bins.shape
    use_fused = cfg.backend == "fused" and not isinstance(bins, SparseBins)
    mask_i32 = feat_mask.to(torch.int32) if use_fused else None
    node = torch.zeros(n, dtype=torch.int32, device=g.device)  # level-local ids
    features, thresholds = [], []
    hist = None  # the previous level's histograms (the subtraction cache)
    for level in range(cfg.depth):
        n_nodes = 1 << level
        n_sub = n_nodes // 2 if (cfg.hist_mode == "subtract" and level) else n_nodes
        if use_fused and _level_build.fused_level_fits(n, n_nodes, n_sub, n_feat, cfg.n_bins):
            hist, feat, thr, node = _fused_level(cfg, bins, node, g, h, mask_i32, level, hist)
        else:
            hist, feat, thr, node = _staged_level(cfg, bins, node, g, h, feat_mask, level,
                                                  hist)
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
