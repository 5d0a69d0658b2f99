"""Public kernel entry points (twin of ``repro.kernels.ops``).

Dispatch is by the tensor's device and nothing else: a CPU tensor runs the
kernel's plain PyTorch version, a CUDA tensor launches the hand-written
kernel or raises. There is no backend knob and no fallback. The names are
the kernel modules' own entry points; dtypes are checked there, not cast.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import forest_traversal, histogram, split_scan

build_histogram = histogram.histogram  # (2, n_nodes, F, B) of a full level
split_gain = split_scan.split_gain  # gain surface (L, F, B), -inf where invalid
forest_traverse = forest_traversal.forest_traverse  # masked forest sum (N,)


def build_histogram_subset(
    bins: torch.Tensor,  # (N, F) int32
    node_ids: torch.Tensor,  # (N,) int32 level-local node ids, -1 = inactive
    grad: torch.Tensor,  # (N,) f32
    hess: torch.Tensor,  # (N,) f32
    active_nodes: torch.Tensor,  # (n_sub,) int32 node ids to build
    n_nodes: int,
    n_bins: int,
) -> torch.Tensor:
    """(2, n_sub, F, n_bins) histograms of the ``active_nodes`` only — the
    smaller-child build of histogram subtraction (the reference's argument
    order)."""
    return histogram.histogram(bins, node_ids, grad, hess, n_nodes, n_bins, active_nodes)
