"""Gradient/hessian histograms: CUDA kernel wrapper and its plain version.

Replaces ``repro.kernels.histogram.histogram_pallas``. The kernel
(``csrc/histogram.cu``) says what bounds it and how its design answers
that. A CPU tensor runs ``histogram_plain``; a CUDA tensor launches the
kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, hist_plan, ref

launches = 0  # kernel launches, counted where the kernel is launched


def histogram_plain(
    bins: torch.Tensor,
    node_ids: torch.Tensor,
    grad: torch.Tensor,
    hess: torch.Tensor,
    n_nodes: int,
    n_bins: int,
    active_nodes: torch.Tensor | None = None,
) -> torch.Tensor:
    """The plain PyTorch version (scatter-add; on CUDA its adds use atomics,
    so it is a yardstick there, never the main path)."""
    if active_nodes is None:
        return ref.histogram_ref(bins, node_ids, grad, hess, n_nodes, n_bins)
    return ref.histogram_subset_ref(
        bins, node_ids, grad, hess, active_nodes, n_nodes, n_bins
    )


def launch_plan(
    bins: torch.Tensor, n_nodes: int, n_bins: int, active_nodes: torch.Tensor | None,
    plan_features: int | None = None,
) -> hist_plan.HistPlan:
    """The kernel's launch plan for these inputs (``kernels.hist_plan``).

    ``plan_features``: the F to take the plan of, when it is not the
    bins' own (a feature shard of a wider matrix). A cell's order depends
    on the plan's tile, warps and splits, never on which features a tile
    holds, so the shard's cells then sum in the wide matrix's order; the
    grid is cut down to the shard's own tiles."""
    rows = n_nodes if active_nodes is None else active_nodes.shape[0]
    n, f = bins.shape
    p = hist_plan.plan(n, plan_features or f, n_bins, rows)
    if plan_features is None or plan_features == f:
        return p
    return p._replace(grid=(-(-f // p.feat_tile), rows, p.splits))


def histogram(
    bins: torch.Tensor,  # (N, F) int32
    node_ids: torch.Tensor,  # (N,) int32, -1 = inactive
    grad: torch.Tensor,  # (N,) f32
    hess: torch.Tensor,  # (N,) f32
    n_nodes: int,
    n_bins: int,
    active_nodes: torch.Tensor | None = None,  # (R,) int32 node subset
    plan_features: int | None = None,  # the F whose launch plan to take
) -> torch.Tensor:
    """(2, R, F, n_bins) f32 histograms; R = n_nodes for the full level
    (``active_nodes=None``), else row r sums node ``active_nodes[r]``.
    ``plan_features``: see ``launch_plan``."""
    if bins.device.type == "cpu":
        return histogram_plain(bins, node_ids, grad, hess, n_nodes, n_bins, active_nodes)
    if bins.device.type != "cuda":
        raise ValueError(f"histogram: no kernel for device {bins.device}")
    global launches
    dev = bins.device
    n, f = bins.shape
    rows = n_nodes if active_nodes is None else active_nodes.shape[0]
    _build.require(bins, "bins", torch.int32, (n, f), dev)
    _build.require(node_ids, "node_ids", torch.int32, (n,), dev)
    _build.require(grad, "grad", torch.float32, (n,), dev)
    _build.require(hess, "hess", torch.float32, (n,), dev)
    if active_nodes is not None:
        _build.require(active_nodes, "active_nodes", torch.int32, (rows,), dev)
    out = torch.empty((2, rows, f, n_bins), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    plan = launch_plan(bins, n_nodes, n_bins, active_nodes, plan_features)
    work = torch.empty(hist_plan.work_ints(plan, n, n_bins), dtype=torch.int32, device=dev)
    fn = _build.function(
        "histogram", "histogram_launch",
        [ctypes.c_void_p] * 7 + [ctypes.c_longlong] + [ctypes.c_int] * 8 + [ctypes.c_void_p],
    )
    err = fn(
        bins.data_ptr(), node_ids.data_ptr(), grad.data_ptr(), hess.data_ptr(),
        None if active_nodes is None else active_nodes.data_ptr(), out.data_ptr(),
        work.data_ptr(), work.numel(), n, f, n_bins, rows, plan.feat_tile, plan.warps,
        plan.splits, plan.min_per_column, _build.stream_of(dev),
    )
    _build.check(err, "histogram kernel")
    with _build.COUNT_LOCK:
        launches += 1
    return out
