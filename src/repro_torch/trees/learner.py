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
  * ``'staged'`` (default) — histogram kernel, sibling derivation, the
    split-gain kernel with each node's masked first maximum
    (``split_gain_decide``) and partition, each a step of its own
    (``kernels.ops``);
  * ``'fused'`` — each level whose resident set fits the budget
    (``kernels.level_build.fused_level_fits``) is one fused level
    (``kernels.level_build``); the other levels run staged. The fused level
    gives the staged level's bits, so the two backends build the same tree.
    The sparse layout always runs staged (the fused level reads dense bins).
Either way the device decides kernel versus plain version, as everywhere in
the port. Every sum here is taken without float atomics, so a build on the
card gives the same bits run after run.

Sharded builds (``ps.sharded``): ``build_tree(..., mesh=)`` runs one rank's
part of a build whose samples are sharded over ``cfg.axis_name`` and whose
features are sharded over ``cfg.feature_axis``. Each rank launches the
same kernels on its own block; the histograms, the smaller-child counts
and the leaf statistics merge with psums over the data axis (the sibling
is derived after the merge), and under feature sharding each node's split
merges over the feature axis: ``pmax`` of the local best gains, then
``pmin`` of the global flat index among the ranks that hold the maximum,
which is the unsharded first maximum bit for bit. The fused level decides
on the histograms it holds, which are a rank's own, so a sharded build
always runs staged.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import collectives
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
    # The mesh axis the samples are sharded over (``build_tree(mesh=)``):
    # histograms, smaller-child counts and leaf statistics psum across it.
    axis_name: str | None = None
    # The mesh axis the feature columns are sharded over: each rank holds a
    # contiguous block of F / (the axis's size) columns, and each node's
    # split merges with the (L,)-sized pmax / pmin.
    feature_axis: str | None = None


class _Axes(NamedTuple):
    """A build's mesh axes (None where unsharded) and the global F the
    dense histogram takes its launch plan from."""

    data: object | None
    feature: object | None
    plan_features: int | None


_UNSHARDED = _Axes(None, None, None)


def _smaller_children(node: torch.Tensor, h: torch.Tensor, n_nodes: int,
                      axis=None) -> torch.Tensor:
    """Each parent's child with less hessian mass, (n_nodes // 2,) int32
    (ties pick the even child). The counts merge over the data ``axis``
    first, so every rank picks the same child."""
    counts = segment_sum(h, node, n_nodes)
    if axis is not None:
        counts = collectives.psum(counts, axis)
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
    axes: _Axes = _UNSHARDED,
) -> torch.Tensor:
    """The (2, 2^level, F, B) histogram of one level, by the config's mode
    (merged over the data axis)."""
    n_nodes = 1 << level
    if cfg.hist_mode == "rebuild" or level == 0:
        return ops.build_histogram(bins, node, g, h, n_nodes, cfg.n_bins, axis=axes.data,
                                   plan_features=axes.plan_features)
    active = _smaller_children(node, h, n_nodes, axes.data)
    built = ops.build_histogram_subset(bins, node, g, h, active, n_nodes, cfg.n_bins,
                                       axis=axes.data, plan_features=axes.plan_features)
    # Node n (parent p = n >> 1) is either the built child or the sibling
    # derived as parent - built, after the merge (subtraction commutes
    # with the psum, and every rank subtracts the same merged values).
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
    feat_mask: torch.Tensor,  # (F,) bool, or its int32 form (1 = may split)
    level: int,
    parent_hist: torch.Tensor | None,
    axes: _Axes = _UNSHARDED,
    route_bins: torch.Tensor | SparseBins | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One level as separate steps: (hist, feat, thr, new_node). ``feat`` is
    a global feature id. ``route_bins`` routes the samples where it is not
    ``bins`` (a feature shard's sparse histogram view beside the whole
    row-major store)."""
    n_bins = cfg.n_bins
    route_bins = bins if route_bins is None else route_bins
    hist = _level_histogram(cfg, bins, node, g, h, level, parent_hist, axes)
    mask_i32 = feat_mask if feat_mask.dtype == torch.int32 else feat_mask.to(torch.int32)
    # The surface and each node's first maximum under the mask, one launch.
    _, best, idx = ops.split_gain_decide(hist, cfg.lam, cfg.min_child_hess, mask_i32)
    f_local = hist.shape[2]
    if axes.feature is not None:
        # Rank s holds global columns [s F_loc, (s + 1) F_loc), so the global
        # flat index orders cells as the unsharded argmax does: the lowest
        # one among the ranks at the maximum is the unsharded first maximum
        # (all -inf nodes tie at rank 0's index 0, as torch.argmax).
        gidx = idx.to(torch.int32) + axes.feature.index * (f_local * n_bins)
        best_all = collectives.pmax(best, axes.feature)
        cand = torch.where(best == best_all, gidx, torch.iinfo(torch.int32).max)
        idx, best = collectives.pmin(cand, axes.feature), best_all
    # Unsplittable node -> pass-through: all samples go left.
    ok = torch.isfinite(best) & (best > 0.0)
    feat = torch.where(ok, idx // n_bins, 0).to(torch.int32)
    thr = torch.where(ok, idx % n_bins, n_bins - 1).to(torch.int32)
    nodel = node.long()
    f_of = feat.long()[nodel]
    if axes.feature is not None and not isinstance(route_bins, SparseBins):
        # Only the winning feature's owner holds its column: each rank puts
        # in what it owns and a one-byte psum rebuilds the column (bin ids
        # are below n_bins <= 256).
        lo = axes.feature.index * f_local
        owned = (f_of >= lo) & (f_of < lo + f_local)
        v = route_bins.gather(1, (f_of - lo).clamp(0, f_local - 1)[:, None])[:, 0]
        v = torch.where(owned, v, 0).to(torch.uint8)
        val = collectives.psum(v, axes.feature).to(torch.int32)
    else:
        # The dense gather, or the whole row-major store, which routes by
        # global feature id with no collective.
        val = gather_feature_bins(route_bins, f_of)
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
    mesh=None,  # launch.mesh.Mesh naming cfg.axis_name / cfg.feature_axis
) -> Tree:
    """One tree. Under ``cfg.axis_name`` / ``cfg.feature_axis`` this is one
    rank's part of a sharded build (``ps.sharded``): ``bins``, ``g`` and
    ``h`` are the rank's own block, ``feat_mask`` is over the global
    features, and the returned tree is the same on every rank."""
    if cfg.hist_mode not in ("subtract", "rebuild"):
        raise ValueError(f"unknown hist_mode {cfg.hist_mode!r} (want 'subtract'|'rebuild')")
    if cfg.backend not in BACKENDS:
        raise ValueError(f"unknown backend {cfg.backend!r} (want one of {BACKENDS})")
    sharded = cfg.axis_name is not None or cfg.feature_axis is not None
    if sharded and mesh is None:
        raise ValueError("a sharded LearnerConfig needs the mesh its axes name")
    axes, hist_bins = _UNSHARDED, bins
    sparse = isinstance(bins, SparseBins)
    if sharded:
        feat_ax = None if cfg.feature_axis is None else mesh.axis(cfg.feature_axis)
        if sparse:
            # Only the feature-major store is sharded: the histogram view
            # takes the zero-bin slice of its block, the row-major store and
            # the whole zero_bin route by global feature id.
            f_local, f_global = bins.feat_rows.shape[0], bins.n_features
        else:
            f_local = bins.shape[1]
            f_global = f_local * (feat_ax.size if feat_ax is not None else 1)
        if feat_ax is not None and f_local != f_global:
            lo = feat_ax.index * f_local
            feat_mask = feat_mask[lo:lo + f_local]
            if sparse:
                hist_bins = bins._replace(zero_bin=bins.zero_bin[lo:lo + f_local].contiguous())
        axes = _Axes(None if cfg.axis_name is None else mesh.axis(cfg.axis_name), feat_ax,
                     f_global if feat_ax is not None and not sparse else None)
    n, n_feat = hist_bins.shape
    if feat_mask.shape[0] != n_feat:
        raise ValueError(f"feat_mask has {feat_mask.shape[0]} features, the build {n_feat}")
    use_fused = cfg.backend == "fused" and not sparse and not sharded
    sharded_args = (axes, bins) if sharded else ()
    mask_i32 = feat_mask.to(torch.int32)  # the kernels' form, once a tree
    node = torch.zeros(n, dtype=torch.int32, device=g.device)  # level-local ids
    features, thresholds = [], []
    hist = None  # the previous level's histograms (the subtraction cache)
    for level in range(cfg.depth):
        n_nodes = 1 << level
        n_sub = n_nodes // 2 if (cfg.hist_mode == "subtract" and level) else n_nodes
        if use_fused and _level_build.fused_level_fits(n, n_nodes, n_sub, n_feat, cfg.n_bins):
            hist, feat, thr, node = _fused_level(cfg, bins, node, g, h, mask_i32, level, hist)
        else:
            hist, feat, thr, node = _staged_level(cfg, hist_bins, node, g, h, mask_i32,
                                                  level, hist, *sharded_args)
        features.append(feat)
        thresholds.append(thr)

    n_leaves = 1 << cfg.depth
    leaf_g = segment_sum(g, node, n_leaves)
    leaf_h = segment_sum(h, node, n_leaves)
    if axes.data is not None:  # merge the leaf statistics across data shards
        leaf_g = collectives.psum(leaf_g, axes.data)
        leaf_h = collectives.psum(leaf_h, axes.data)
    leaf_value = -leaf_g / (leaf_h + cfg.lam)
    leaf_value = torch.where(leaf_h > 0, leaf_value, torch.zeros_like(leaf_value))
    return Tree(
        feature=torch.cat(features),
        threshold=torch.cat(thresholds),
        leaf_value=leaf_value.float(),
    )


def build_tree_multi(
    cfg: LearnerConfig,
    bins: torch.Tensor | SparseBins,
    g: torch.Tensor,  # (N, K) f32 per-output weighted gradient field
    h: torch.Tensor,  # (N, K) f32 per-output weighted hessian / weight
    feat_mask: torch.Tensor,  # (F,) bool, ONE mask shared by the K trees
    mesh=None,  # as ``build_tree``
) -> Tree:
    """K trees against the (N, K) field, stacked as one ``Tree`` of (K, ...)
    arrays: the K-output round's one push. The K trees share the round's
    feature mask; each lane is a standalone ``build_tree`` on its column.
    The K builds run one after another (batching them into one histogram
    launch of K x L rows is later work)."""
    trees = [build_tree(cfg, bins, g[:, k].contiguous(), h[:, k].contiguous(), feat_mask,
                        mesh) for k in range(g.shape[1])]
    return Tree(*(torch.stack(parts) for parts in zip(*trees)))
