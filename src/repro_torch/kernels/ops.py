"""Public kernel entry points (twin of ``repro.kernels.ops``).

Dispatch is by the tensor's device and nothing else: a CPU tensor runs the
kernel's plain PyTorch version, a CUDA tensor launches the hand-written
kernel or raises. There is no backend knob and no fallback. The histogram
entry points also dispatch on the layout: a ``SparseBins`` takes the
sparse kernel plus the zero-bin complement. Dtypes are checked by the
kernel modules, not cast.

``axis`` (a ``launch.mesh.MeshAxis``): under a data-parallel build each
rank histograms its own samples with the same kernels, and the histograms
merge with a psum over the axis (``collectives``): every cell is a sum
over disjoint sample subsets, so the partial sums compose.
"""
from __future__ import annotations

import torch

from repro_torch import collectives
from repro_torch.kernels import (
    flash_attention as _flash,
    forest_traversal,
    histogram,
    histogram_sparse,
    level_build as _level_build,
    ref,
    split_scan,
)
from repro_torch.trees.binning import SparseBins

split_gain = split_scan.split_gain  # gain surface (L, F, B), -inf where invalid
# The surface and each node's masked first maximum (best, idx), one launch.
split_gain_decide = split_scan.split_gain_decide
# Masked forest sum (N,), or (N, K) with ``n_outputs``; quantized layouts
# pass their packed arrays and ``leaf_scale``.
forest_traverse = forest_traversal.forest_traverse
level_build = _level_build.level_build  # one fused tree level


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Sk, KV, hd)
    v: torch.Tensor,  # (B, Sk, KV, hd)
    causal: bool = True,
) -> torch.Tensor:
    """Fused attention in the model layout -> (B, Sq, H, hd), q head h
    reading kv head h // (H // KV). The kernel reads the (B, S, H, hd)
    tensors in place and masks the ragged edge itself, so nothing is padded
    or transposed; on the card the result is contiguous.

    Differentiable on every device through ``FlashAttention``: its backward
    is the backward kernels on the card and their plain version on the CPU
    (not autograd through the plain forward)."""
    out = _flash.FlashAttention.apply(q.transpose(1, 2), k.transpose(1, 2),
                                      v.transpose(1, 2), causal)
    return out.transpose(1, 2)


def segment_sum(vals: torch.Tensor, seg: torch.Tensor, n_segments: int) -> torch.Tensor:
    """(n_segments,) sums of ``vals`` by segment id, as masked row sums;
    ids outside [0, n_segments) add nothing.

    ``index_add_``/``scatter_add_`` on CUDA floats add with atomics in an
    order that changes from run to run; a masked (n_segments, N) reduction
    takes a fixed order. Its memory grows as n_segments * N, which is small
    at the trees' widths (512 leaves x 4000 samples is 8 MB).
    """
    ids = torch.arange(n_segments, device=seg.device)
    onehot = seg[None, :].long() == ids[:, None]
    return torch.where(onehot, vals[None, :], torch.zeros_like(vals)[None, :]).sum(1)


def _node_totals(
    node_ids: torch.Tensor,
    grad: torch.Tensor,
    hess: torch.Tensor,
    active_nodes: torch.Tensor | None,
    n_nodes: int,
) -> torch.Tensor:
    """(2, R) grad/hess mass of each histogram row's node: what the stored
    entries miss is this minus their row sum."""
    rows = n_nodes if active_nodes is None else active_nodes.shape[0]
    row = ref.node_rows(node_ids, active_nodes, n_nodes)
    return torch.stack([segment_sum(grad, row, rows), segment_sum(hess, row, rows)])


def _zero_bin_complement(
    stored: torch.Tensor,  # (2, R, F, B) stored-entry histograms
    totals: torch.Tensor,  # (2, R) per-row grad/hess mass
    zero_bin: torch.Tensor,  # (F,) int32
) -> torch.Tensor:
    """Add each row's absent-entry mass at the feature's zero bin:
    ``missing = totals - sum_b stored``. A subtraction, so it runs on
    complete sums (after any reduce across devices), never on partials."""
    missing = totals[:, :, None] - stored.sum(dim=-1)  # (2, R, F)
    b_iota = torch.arange(stored.shape[-1], device=stored.device)
    onehot = (zero_bin[:, None] == b_iota[None, :]).to(stored.dtype)  # (F, B)
    return stored + missing[..., None] * onehot[None, None]


def build_histogram_sparse(
    feat_rows: torch.Tensor,  # (F, C) int32
    feat_codes: torch.Tensor,  # (F, C) int32
    zero_bin: torch.Tensor,  # (F,) int32
    node_ids: torch.Tensor,  # (N,) int32, -1 = inactive
    grad: torch.Tensor,
    hess: torch.Tensor,
    n_nodes: int,
    n_bins: int,
    active_nodes: torch.Tensor | None = None,  # (R,) int32 node subset
    axis=None,  # MeshAxis the samples are sharded over
) -> torch.Tensor:
    """(2, R, F, n_bins) histograms from the feature-major sparse store:
    the stored-entry kernel, then the zero-bin complement in plain torch
    (every device; the node totals are masked sums, no float atomics).
    Under ``axis`` the stored sums and the node totals merge first, and
    the complement (a subtraction) runs on the merged values."""
    stored = histogram_sparse.histogram_sparse(
        feat_rows, feat_codes, node_ids, grad, hess, n_nodes, n_bins, active_nodes)
    totals = _node_totals(node_ids, grad, hess, active_nodes, n_nodes)
    if axis is not None:
        stored = collectives.psum(stored, axis)
        totals = collectives.psum(totals, axis)
    return _zero_bin_complement(stored, totals, zero_bin)


def build_histogram(
    bins: torch.Tensor | SparseBins,  # (N, F) int32 or the sparse layout
    node_ids: torch.Tensor,  # (N,) int32 level-local node ids, -1 = inactive
    grad: torch.Tensor,  # (N,) f32
    hess: torch.Tensor,  # (N,) f32
    n_nodes: int,
    n_bins: int,
    axis=None,  # MeshAxis the samples are sharded over
    plan_features: int | None = None,
) -> torch.Tensor:
    """(2, n_nodes, F, n_bins) histograms of a full level, merged over
    ``axis``. ``plan_features``: the F whose launch plan the dense kernel
    takes (a feature shard passes the global F, so each cell sums in the
    order it has unsharded; ``histogram.histogram``)."""
    if isinstance(bins, SparseBins):
        return build_histogram_sparse(bins.feat_rows, bins.feat_codes, bins.zero_bin,
                                      node_ids, grad, hess, n_nodes, n_bins, axis=axis)
    out = histogram.histogram(bins, node_ids, grad, hess, n_nodes, n_bins,
                              plan_features=plan_features)
    return out if axis is None else collectives.psum(out, axis)


def build_histogram_subset(
    bins: torch.Tensor | SparseBins,
    node_ids: torch.Tensor,
    grad: torch.Tensor,
    hess: torch.Tensor,
    active_nodes: torch.Tensor,  # (n_sub,) int32 node ids to build
    n_nodes: int,
    n_bins: int,
    axis=None,  # MeshAxis the samples are sharded over
    plan_features: int | None = None,
) -> torch.Tensor:
    """(2, n_sub, F, n_bins) histograms of the ``active_nodes`` only — the
    smaller-child build of histogram subtraction (the reference's argument
    order), merged over ``axis``. The sibling's subtraction is not here:
    the learner subtracts after the merge, so every rank derives it from
    the same merged values."""
    if isinstance(bins, SparseBins):
        return build_histogram_sparse(bins.feat_rows, bins.feat_codes, bins.zero_bin,
                                      node_ids, grad, hess, n_nodes, n_bins, active_nodes,
                                      axis=axis)
    out = histogram.histogram(bins, node_ids, grad, hess, n_nodes, n_bins, active_nodes,
                              plan_features=plan_features)
    return out if axis is None else collectives.psum(out, axis)
