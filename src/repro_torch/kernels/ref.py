"""Plain-PyTorch oracles for the port's kernels (twin of ``repro.kernels.ref``).

These are the semantics of record on the torch side: each hand-written
CUDA kernel is held against them on the card, and the CPU tests hold
them against the JAX reference. Every float op rounds once, as the
kernels (built with ``--fmad=false``) do.
"""
from __future__ import annotations

import torch


def _scatter_hist(
    bins: torch.Tensor, row: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
    n_rows: int, n_bins: int,
) -> torch.Tensor:
    """(2, n_rows, F, n_bins) sums of grad/hess per (row, feature, bin);
    samples with ``row < 0`` add nothing."""
    n, f = bins.shape
    active = row >= 0
    rowc = torch.where(active, row, torch.zeros_like(row)).long()
    seg = (rowc[:, None] * f + torch.arange(f, device=bins.device)[None, :]) * n_bins
    seg = (seg + bins.long()).reshape(-1)
    zero = torch.zeros_like(grad)
    num = n_rows * f * n_bins
    out = []
    for vals in (torch.where(active, grad, zero), torch.where(active, hess, zero)):
        mat = vals[:, None].expand(n, f).reshape(-1)
        out.append(torch.zeros(num, dtype=torch.float32, device=bins.device)
                   .index_add_(0, seg, mat))
    return torch.stack(out).reshape(2, n_rows, f, n_bins)


def histogram_ref(
    bins: torch.Tensor,  # (N, F) int32 bin ids
    node_ids: torch.Tensor,  # (N,) int32, -1 = inactive
    grad: torch.Tensor,  # (N,) f32
    hess: torch.Tensor,  # (N,) f32
    n_nodes: int,
    n_bins: int,
) -> torch.Tensor:
    """Gradient/hessian histograms out[0|1, node, f, b] (scatter-add form)."""
    return _scatter_hist(bins, node_ids, grad, hess, n_nodes, n_bins)


def histogram_subset_ref(
    bins: torch.Tensor,
    node_ids: torch.Tensor,
    grad: torch.Tensor,
    hess: torch.Tensor,
    active_nodes: torch.Tensor,  # (n_sub,) node ids to histogram
    n_nodes: int,
    n_bins: int,
) -> torch.Tensor:
    """Node-subset histograms: row r sums the samples on ``active_nodes[r]``."""
    n_sub = active_nodes.shape[0]
    inv = torch.full((n_nodes,), -1, dtype=torch.int64, device=bins.device)
    inv[active_nodes.long()] = torch.arange(n_sub, device=bins.device)
    nodec = node_ids.long().clamp(0, n_nodes - 1)
    row = torch.where(node_ids >= 0, inv[nodec], torch.full_like(inv[nodec], -1))
    return _scatter_hist(bins, row, grad, hess, n_sub, n_bins)


def split_gain_surface_ref(
    hist: torch.Tensor, lam: float, min_child_hess: float
) -> torch.Tensor:
    """Gain surface (L, F, B) from (2, L, F, B) histograms; -inf where a
    child's hessian mass is under ``min_child_hess`` and at the last bin."""
    g, h = hist[0], hist[1]
    gl = torch.cumsum(g, dim=-1)
    hl = torch.cumsum(h, dim=-1)
    gt, ht = gl[..., -1:], hl[..., -1:]
    gr, hr = gt - gl, ht - hl
    gain = gl * gl / (hl + lam) + gr * gr / (hr + lam) - gt * gt / (ht + lam)
    valid = (hl >= min_child_hess) & (hr >= min_child_hess)
    valid[..., -1] = False
    return torch.where(valid, gain, torch.full_like(gain, float("-inf")))


def level_build_ref(
    bins: torch.Tensor,  # (N, F) int32
    node_ids: torch.Tensor,  # (N,) int32 level-local node per sample, -1 inactive
    grad: torch.Tensor,  # (N,) f32
    hess: torch.Tensor,  # (N,) f32
    active_nodes: torch.Tensor,  # (L_sub,) int32 node ids to histogram
    parent_hist: torch.Tensor | None,  # (2, L_sub, F, B) previous-level cache
    feat_mask: torch.Tensor,  # (F,) bool / int / f32 -- available features (> 0)
    lam: float,
    min_child_hess: float,
    n_nodes: int,
    n_bins: int,
    derive_sibling: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One whole tree level: (hist (2, L, F, B), best_feature (L,) int32,
    best_bin (L,) int32, best_gain (L,) f32, new_node (N,) int32).

    The staged level as one function: histogram of the active nodes (in
    derive mode each sibling is ``parent - built``), gain scan, feature
    mask, first-max argmax, the pass-left fix (feature 0, threshold
    ``n_bins - 1``) and the ``2 * node + go_right`` re-route. ``best_gain``
    is taken before the pass-left fix; a sample on node -1 maps to -2.
    Without ``derive_sibling``, ``active_nodes`` enumerates 0 .. L-1.
    """
    built = histogram_subset_ref(bins, node_ids, grad, hess, active_nodes, n_nodes, n_bins)
    if derive_sibling:
        ids = torch.arange(n_nodes, device=bins.device)
        par_of = ids >> 1
        is_built = ids == active_nodes[par_of].long()
        built_rows = built[:, par_of]
        hist = torch.where(is_built[None, :, None, None], built_rows,
                           parent_hist[:, par_of] - built_rows)
    else:
        hist = built
    gain = split_gain_surface_ref(hist, lam, min_child_hess)
    gain = gain.masked_fill(~(feat_mask > 0)[None, :, None], float("-inf"))
    flat = gain.reshape(n_nodes, -1)
    idx = torch.argmax(flat, dim=-1)  # the first maximum
    best = flat.gather(1, idx[:, None])[:, 0]
    ok = torch.isfinite(best) & (best > 0.0)
    feat = torch.where(ok, idx // n_bins, 0).to(torch.int32)
    thr = torch.where(ok, idx % n_bins, n_bins - 1).to(torch.int32)
    node_c = node_ids.long().clamp(0, n_nodes - 1)
    val = bins.gather(1, feat.long()[node_c][:, None])[:, 0]
    go_right = (val > thr[node_c]).to(torch.int32)
    new_node = torch.where(node_ids >= 0, 2 * node_ids + go_right, 2 * node_ids)
    return hist, feat, thr, best, new_node


def node_rows(
    node_ids: torch.Tensor, active_nodes: torch.Tensor | None, n_nodes: int
) -> torch.Tensor:
    """Each node id's output row (int64; -1 for node -1, ids outside
    [0, n_nodes) and nodes outside ``active_nodes``); row r is node
    ``active_nodes[r]``, or node r when ``active_nodes`` is None."""
    dev = node_ids.device
    inv = torch.arange(n_nodes, device=dev)
    if active_nodes is not None:
        inv = torch.full((n_nodes,), -1, dtype=torch.int64, device=dev)
        inv[active_nodes.long()] = torch.arange(active_nodes.shape[0], device=dev)
    ok = (node_ids >= 0) & (node_ids < n_nodes)
    return torch.where(ok, inv[node_ids.long().clamp(0, n_nodes - 1)], -1)


def histogram_sparse_stored_ref(
    feat_rows: torch.Tensor,  # (F, C) int32 sample ids, -1 = pad
    feat_codes: torch.Tensor,  # (F, C) int32 stored bin codes
    node_ids: torch.Tensor,  # (N,) int32, -1 = inactive
    grad: torch.Tensor,  # (N,) f32
    hess: torch.Tensor,  # (N,) f32
    n_nodes: int,
    n_bins: int,
    active_nodes: torch.Tensor | None = None,  # (R,) int32 node subset
) -> torch.Tensor:
    """(2, R, F, n_bins) grad/hess sums over the STORED entries only (R =
    n_nodes, or one row per ``active_nodes`` entry): the sparse histogram
    kernel's semantics, before the zero-bin complement. Each cell adds its
    entries in ascending entry order (scatter-add over the (F, C) store)."""
    f, _ = feat_rows.shape
    rows = n_nodes if active_nodes is None else active_nodes.shape[0]
    dev = feat_rows.device
    valid = feat_rows >= 0
    safe = torch.where(valid, feat_rows, 0).long()
    e_node = torch.where(valid, node_ids[safe], -1)
    e_row = node_rows(e_node, active_nodes, n_nodes)
    keep = e_row >= 0
    cell = (e_row * f + torch.arange(f, device=dev)[:, None]) * n_bins + feat_codes.long()
    cell = cell[keep]
    out = []
    for vals in (grad, hess):
        out.append(torch.zeros(rows * f * n_bins, dtype=torch.float32, device=dev)
                   .index_add_(0, cell, vals[safe][keep]))
    return torch.stack(out).reshape(2, rows, f, n_bins)


def histogram_sparse_ref(sp, node_ids, grad, hess, n_nodes: int, n_bins: int) -> torch.Tensor:
    """Sparse-layout histogram oracle: densify (exact), then ``histogram_ref``."""
    from repro_torch.trees.binning import to_dense

    return histogram_ref(to_dense(sp), node_ids, grad, hess, n_nodes, n_bins)


def histogram_sparse_subset_ref(
    sp, node_ids, grad, hess, active_nodes, n_nodes: int, n_bins: int
) -> torch.Tensor:
    """Node-subset sparse oracle: densify, then ``histogram_subset_ref``."""
    from repro_torch.trees.binning import to_dense

    return histogram_subset_ref(
        to_dense(sp), node_ids, grad, hess, active_nodes, n_nodes, n_bins
    )


def _tree_leaf_values(
    bins: torch.Tensor, feat: torch.Tensor, thr: torch.Tensor, leaves: torch.Tensor,
    depth: int,
) -> torch.Tensor:
    """One tree's leaf value per sample, (N,) — the heap descent."""
    node = torch.zeros(bins.shape[0], dtype=torch.int64, device=bins.device)
    for _ in range(depth):
        v = bins.gather(1, feat.long()[node][:, None])[:, 0]
        node = 2 * node + 1 + (v > thr[node]).long()
    return leaves[node - ((1 << depth) - 1)]


def forest_traverse_ref(
    bins: torch.Tensor,  # (N, F) int32
    feature: torch.Tensor,  # (T, 2^d - 1) int32
    threshold: torch.Tensor,  # (T, 2^d - 1) int32
    leaf_value: torch.Tensor,  # (T, 2^d) f32
    n_trees: torch.Tensor | int,  # live slots
    depth: int,
) -> torch.Tensor:
    """Masked forest sum (N,) f32, all trees at once then one reduce over
    the tree axis (the shape of ``repro``'s traversal oracle)."""
    t, n = feature.shape[0], bins.shape[0]
    node = torch.zeros((t, n), dtype=torch.int64, device=bins.device)
    bins_t = bins.t().long()
    for _ in range(depth):
        f = feature.long().gather(1, node)
        v = bins_t.gather(0, f)
        node = 2 * node + 1 + (v > threshold.gather(1, node)).long()
    vals = leaf_value.gather(1, node - ((1 << depth) - 1))
    live = torch.arange(t, device=bins.device)[:, None] < n_trees
    return torch.where(live, vals, torch.zeros_like(vals)).sum(0)


def apply_forest_ref(
    bins: torch.Tensor,
    feature: torch.Tensor,
    threshold: torch.Tensor,
    leaf_value: torch.Tensor,
    depth: int,
    n_trees: torch.Tensor | int | None = None,  # None = every slot live
) -> torch.Tensor:
    """Sum of per-tree predictions (N,) f32, accumulated tree by tree in
    slot order; slots >= ``n_trees`` add exactly 0."""
    total = torch.zeros(bins.shape[0], dtype=torch.float32, device=bins.device)
    for t in range(feature.shape[0]):
        vals = _tree_leaf_values(bins, feature[t], threshold[t], leaf_value[t], depth)
        if n_trees is not None:
            vals = torch.where(torch.as_tensor(t, device=bins.device) < n_trees,
                               vals, torch.zeros_like(vals))
        total = total + vals
    return total
