"""Stored-entry sparse histograms: CUDA kernel wrapper and its plain version.

Replaces ``repro.kernels.histogram_sparse.histogram_sparse_pallas``. The
kernel (``csrc/histogram_sparse.cu``) says what bounds it and how its
design answers that. It sums the stored entries only; ``kernels.ops``
adds the zero-bin complement. A CPU tensor runs ``histogram_sparse_plain``;
a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

launches = 0  # kernel launches, counted where the kernel is launched

MAX_NODES = 16384  # the kernel keeps a node -> row map in shared memory

# The plain PyTorch version (scatter-add; on CUDA its adds use atomics, so it
# is a yardstick there, never the main path).
histogram_sparse_plain = ref.histogram_sparse_stored_ref


def histogram_sparse(
    feat_rows: torch.Tensor,  # (F, C) int32 sample ids, -1 = pad
    feat_codes: torch.Tensor,  # (F, C) int32 stored bin codes
    node_ids: torch.Tensor,  # (N,) int32, -1 = inactive
    grad: torch.Tensor,  # (N,) f32
    hess: torch.Tensor,  # (N,) f32
    n_nodes: int,
    n_bins: int,
    active_nodes: torch.Tensor | None = None,  # (R,) int32 node subset
) -> torch.Tensor:
    """(2, R, F, n_bins) f32 stored-entry histograms; R = n_nodes for the
    full level (``active_nodes=None``), else row r sums node
    ``active_nodes[r]``."""
    if feat_rows.device.type == "cpu":
        return histogram_sparse_plain(feat_rows, feat_codes, node_ids, grad, hess,
                                      n_nodes, n_bins, active_nodes)
    if feat_rows.device.type != "cuda":
        raise ValueError(f"histogram_sparse: no kernel for device {feat_rows.device}")
    global launches
    dev = feat_rows.device
    if active_nodes is None:
        active_nodes = torch.arange(n_nodes, dtype=torch.int32, device=dev)
    f, c = feat_rows.shape
    n = node_ids.shape[0]
    rows = active_nodes.shape[0]
    if not 1 <= n_nodes <= MAX_NODES:
        raise ValueError(f"histogram_sparse kernel takes 1..{MAX_NODES} nodes, got {n_nodes}")
    _build.require(feat_rows, "feat_rows", torch.int32, (f, c), dev)
    _build.require(feat_codes, "feat_codes", torch.int32, (f, c), dev)
    _build.require(node_ids, "node_ids", torch.int32, (n,), dev)
    _build.require(grad, "grad", torch.float32, (n,), dev)
    _build.require(hess, "hess", torch.float32, (n,), dev)
    _build.require(active_nodes, "active_nodes", torch.int32, (rows,), dev)
    out = torch.empty((2, rows, f, n_bins), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    fn = _build.function(
        "histogram_sparse", "histogram_sparse_launch",
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    )
    err = fn(
        feat_rows.data_ptr(), feat_codes.data_ptr(), node_ids.data_ptr(), grad.data_ptr(),
        hess.data_ptr(), active_nodes.data_ptr(), out.data_ptr(), f, c, n_bins, n_nodes,
        rows, _build.stream_of(dev),
    )
    _build.check(err, "histogram_sparse kernel")
    launches += 1
    return out
