"""Gradient/hessian histograms: CUDA kernel wrapper and its plain version.

Replaces ``repro.kernels.histogram.histogram_pallas``. The kernel
(``csrc/histogram.cu``) says what bounds it and how its design answers
that. A CPU tensor runs ``histogram_plain``; a CUDA tensor launches the
kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

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


def histogram(
    bins: torch.Tensor,  # (N, F) int32
    node_ids: torch.Tensor,  # (N,) int32, -1 = inactive
    grad: torch.Tensor,  # (N,) f32
    hess: torch.Tensor,  # (N,) f32
    n_nodes: int,
    n_bins: int,
    active_nodes: torch.Tensor | None = None,  # (R,) int32 node subset
) -> torch.Tensor:
    """(2, R, F, n_bins) f32 histograms; R = n_nodes for the full level
    (``active_nodes=None``), else row r sums node ``active_nodes[r]``."""
    if bins.device.type == "cpu":
        return histogram_plain(bins, node_ids, grad, hess, n_nodes, n_bins, active_nodes)
    if bins.device.type != "cuda":
        raise ValueError(f"histogram: no kernel for device {bins.device}")
    global launches
    dev = bins.device
    if active_nodes is None:
        active_nodes = torch.arange(n_nodes, dtype=torch.int32, device=dev)
    n, f = bins.shape
    rows = active_nodes.shape[0]
    _build.require(bins, "bins", torch.int32, (n, f), dev)
    _build.require(node_ids, "node_ids", torch.int32, (n,), dev)
    _build.require(grad, "grad", torch.float32, (n,), dev)
    _build.require(hess, "hess", torch.float32, (n,), dev)
    _build.require(active_nodes, "active_nodes", torch.int32, (rows,), dev)
    out = torch.empty((2, rows, f, n_bins), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    fn = _build.function(
        "histogram", "histogram_launch",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    )
    err = fn(
        bins.data_ptr(), node_ids.data_ptr(), grad.data_ptr(), hess.data_ptr(),
        active_nodes.data_ptr(), out.data_ptr(), n, f, n_bins, rows,
        _build.stream_of(dev),
    )
    _build.check(err, "histogram kernel")
    launches += 1
    return out
