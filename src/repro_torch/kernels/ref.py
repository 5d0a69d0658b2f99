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
