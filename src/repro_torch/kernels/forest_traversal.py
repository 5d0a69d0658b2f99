"""Batched forest traversal: CUDA kernel wrapper and its plain version.

Replaces ``repro.kernels.forest_traversal.forest_traverse_pallas`` (f32
layout, one output). The kernel (``csrc/forest_traversal.cu``) says what
bounds it and how its design answers that. A CPU tensor runs
``forest_traverse_plain``; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

launches = 0  # kernel launches, counted where the kernel is launched

MAX_DEPTH = 10  # the kernel stages 16 trees at a time in shared memory


def forest_traverse_plain(
    bins: torch.Tensor,
    feature: torch.Tensor,
    threshold: torch.Tensor,
    leaf_value: torch.Tensor,
    n_trees: torch.Tensor | int,
    depth: int,
) -> torch.Tensor:
    """The plain PyTorch version: tree by tree in slot order, the same sum
    the kernel takes (so the two agree bit for bit)."""
    return ref.apply_forest_ref(bins, feature, threshold, leaf_value, depth, n_trees)


def forest_traverse(
    bins: torch.Tensor,  # (N, F) int32
    feature: torch.Tensor,  # (T, 2^d - 1) int32, ids in [0, F)
    threshold: torch.Tensor,  # (T, 2^d - 1) int32
    leaf_value: torch.Tensor,  # (T, 2^d) f32
    n_trees: torch.Tensor | int,  # live slots; slots >= n_trees add 0
    depth: int,
) -> torch.Tensor:
    """Masked forest sum (N,) f32."""
    if bins.device.type == "cpu":
        return forest_traverse_plain(bins, feature, threshold, leaf_value, n_trees, depth)
    if bins.device.type != "cuda":
        raise ValueError(f"forest_traverse: no kernel for device {bins.device}")
    if not 0 <= depth <= MAX_DEPTH:
        raise ValueError(f"forest_traverse kernel takes depth 0..{MAX_DEPTH}, got {depth}")
    global launches
    dev = bins.device
    n, f = bins.shape
    t = feature.shape[0]
    n_int, n_leaf = (1 << depth) - 1, 1 << depth
    n_trees = torch.as_tensor(n_trees, dtype=torch.int32, device=dev).reshape(())
    _build.require(bins, "bins", torch.int32, (n, f), dev)
    _build.require(feature, "feature", torch.int32, (t, n_int), dev)
    _build.require(threshold, "threshold", torch.int32, (t, n_int), dev)
    _build.require(leaf_value, "leaf_value", torch.float32, (t, n_leaf), dev)
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    fn = _build.function(
        "forest_traversal", "forest_traverse_launch",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    )
    err = fn(
        bins.data_ptr(), feature.data_ptr(), threshold.data_ptr(), leaf_value.data_ptr(),
        n_trees.data_ptr(), out.data_ptr(), n, f, t, depth, _build.stream_of(dev),
    )
    _build.check(err, "forest_traverse kernel")
    launches += 1
    return out
