"""One fused tree level: CUDA kernel wrapper, its plain version and the
Hopper budget model that decides which levels fuse.

Replaces ``repro.kernels.level_build.level_build_pallas``. The kernel
(``csrc/level_build.cu``) is one cooperative launch of a persistent grid
whose phases meet at grid barriers; its source says what bounds it and how
it gives the staged chain's bits. A CPU tensor runs ``level_build_plain``; a
CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, hist_plan, ref

launches = 0  # kernel launches, counted where the kernel is launched
max_grid = 0  # blocks of the persistent grid at most; 0: as many as the card holds at once

level_build_plain = ref.level_build_ref  # the plain PyTorch version

MAX_NODES = 4096  # the route phase keeps the (L,) split table in shared memory

# The budget model. The TPU program held the level in 12 MiB of VMEM
# (``repro.kernels.level_build.fused_level_vmem_bytes``). On Hopper the
# level is one launch: the built rows stay in shared memory from the
# histogram to the scan, and its phases hand each other only the launch's
# scratch (the row-sorted list, the split tickets and partials, the (node,
# tile) gain partials: ``hist_plan.work_ints``). What the level wants
# resident in the H100's 50 MB L2 (50 MiB, as the card reports it) is what
# it shares with the levels around it: the (N, F) bin matrix, which every
# level's histogram reads again (and the route one cell a sample), the
# parent cache the level above wrote, and the level histogram it writes
# for the level below:
#
#     bytes = 4 * (N * F + 2 * F * B * (L + L_sub)) + 4 * scratch
#
# (the parent term is charged at full levels too, as the TPU model does).
# At realsim width (N = 4000, F = 1500, B = 64; 384 000 B per (grad or
# hess, node) row) that is 24 MB + 3 * 2^l * 384 KB (+ under 0.1 MB of
# scratch) at a subtract level l >= 1: levels 0-4 fuse (42.4 MB at level 4)
# and levels 5-8 run staged (60.9 MB at 5). At the multiclass width (N =
# 4000, F = 60) every level fuses.
FUSED_L2_BUDGET = 50 * 2**20


def fused_level_bytes(n: int, n_nodes: int, n_sub: int, n_feat: int, n_bins: int) -> int:
    """Bytes the fused level keeps resident in L2 (see the module's model)."""
    scratch = hist_plan.work_ints(hist_plan.plan(n, n_feat, n_bins, n_sub), n, n_bins,
                                  n_nodes, fused=True)
    return 4 * (n * n_feat + 2 * n_feat * n_bins * (n_nodes + n_sub)) + 4 * scratch


def fused_level_fits(
    n: int, n_nodes: int, n_sub: int, n_feat: int, n_bins: int,
    budget: int = FUSED_L2_BUDGET,
) -> bool:
    """Whether one fused level's resident set fits the L2 budget (and its
    split table fits the kernel's shared memory)."""
    return (n_nodes <= MAX_NODES
            and fused_level_bytes(n, n_nodes, n_sub, n_feat, n_bins) <= budget)


def launch_plan(
    bins: torch.Tensor, active_nodes: torch.Tensor, n_bins: int
) -> hist_plan.HistPlan:
    """Phase A's launch plan: the staged histogram's plan for the same
    (N, F, B) and rows (``kernels.hist_plan``), so the built rows carry the
    staged histogram's bits."""
    return hist_plan.plan(bins.shape[0], bins.shape[1], n_bins, active_nodes.shape[0])


def level_build(
    bins: torch.Tensor,  # (N, F) int32
    node_ids: torch.Tensor,  # (N,) int32 level-local node per sample, -1 inactive
    grad: torch.Tensor,  # (N,) f32
    hess: torch.Tensor,  # (N,) f32
    active_nodes: torch.Tensor,  # (L_sub,) int32 nodes to histogram
    parent_hist: torch.Tensor | None,  # (2, L_sub, F, B) cache (derive mode)
    feat_mask: torch.Tensor,  # (F,) int32 on the card, 1 = feature available
    lam: float,
    min_child_hess: float,
    n_nodes: int,
    n_bins: int,
    derive_sibling: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused level: (hist (2, L, F, B), feat (L,), thr (L,), best_gain
    (L,), new_node (N,)); the semantics of ``ref.level_build_ref``.

    Without ``derive_sibling`` ``active_nodes`` enumerates 0 .. L-1; with
    it ``active_nodes[p]`` is the built child of parent ``p`` and
    ``parent_hist`` the previous level's histogram.
    """
    if bins.device.type == "cpu":
        return level_build_plain(bins, node_ids, grad, hess, active_nodes, parent_hist,
                                 feat_mask, lam, min_child_hess, n_nodes, n_bins,
                                 derive_sibling)
    if bins.device.type != "cuda":
        raise ValueError(f"level_build: no kernel for device {bins.device}")
    global launches
    dev = bins.device
    n, f = bins.shape
    n_sub = active_nodes.shape[0]
    if not 1 <= n_bins <= 256:
        raise ValueError(f"level_build kernel takes 1..256 bins, got {n_bins}")
    if not 1 <= n_nodes <= MAX_NODES:
        raise ValueError(f"level_build kernel takes 1..{MAX_NODES} nodes, got {n_nodes}")
    if n_sub != (n_nodes // 2 if derive_sibling else n_nodes) or f < 1:
        raise ValueError(f"level_build: {n_sub} active nodes for a level of {n_nodes}")
    _build.require(bins, "bins", torch.int32, (n, f), dev)
    _build.require(node_ids, "node_ids", torch.int32, (n,), dev)
    _build.require(grad, "grad", torch.float32, (n,), dev)
    _build.require(hess, "hess", torch.float32, (n,), dev)
    _build.require(active_nodes, "active_nodes", torch.int32, (n_sub,), dev)
    _build.require(feat_mask, "feat_mask", torch.int32, (f,), dev)
    if derive_sibling:
        _build.require(parent_hist, "parent_hist", torch.float32, (2, n_sub, f, n_bins), dev)
    hist = torch.empty((2, n_nodes, f, n_bins), dtype=torch.float32, device=dev)
    feat = torch.empty(n_nodes, dtype=torch.int32, device=dev)
    thr = torch.empty(n_nodes, dtype=torch.int32, device=dev)
    best = torch.empty(n_nodes, dtype=torch.float32, device=dev)
    new_node = torch.empty(n, dtype=torch.int32, device=dev)
    plan = launch_plan(bins, active_nodes, n_bins)
    work = torch.empty(hist_plan.work_ints(plan, n, n_bins, n_nodes, fused=True),
                       dtype=torch.int32, device=dev)
    fn = _build.function(
        "level_build", "level_build_launch",
        [ctypes.c_void_p] * 9 + [ctypes.c_longlong] + [ctypes.c_void_p] * 4
        + [ctypes.c_int] * 11 + [ctypes.c_float] * 2 + [ctypes.c_void_p],
    )
    err = fn(
        bins.data_ptr(), node_ids.data_ptr(), grad.data_ptr(), hess.data_ptr(),
        active_nodes.data_ptr(), parent_hist.data_ptr() if derive_sibling else None,
        feat_mask.data_ptr(), hist.data_ptr(), work.data_ptr(), work.numel(),
        feat.data_ptr(), thr.data_ptr(), best.data_ptr(), new_node.data_ptr(), n, f, n_bins,
        n_nodes, n_sub, int(derive_sibling), plan.feat_tile, plan.warps, plan.splits,
        plan.min_per_column, max_grid, lam, min_child_hess, _build.stream_of(dev),
    )
    _build.check(err, "level_build kernel")
    with _build.COUNT_LOCK:
        launches += 1
    return hist, feat, thr, best, new_node
