"""The launch plan of the dense histogram kernels, in plain Python and torch.

The staged histogram (``csrc/histogram.cu``) and the fused level's phase A
(``csrc/level_build.cu``) run the same device code
(``csrc/level_common.cuh``), and both wrappers take their launch shape from
``plan`` here, so a fused level gives the staged level's bits. The plan is a
function of (N, F, B, R) alone; the device turns it into chunks from the
row counts alone. Nothing depends on the SM count, the timing or the
stream.

How the work is cut:

  * the samples of each row (row r sums node ``active[r]``, or node r at
    a full level) are listed once per call, in ascending order, rows one
    after another: the row-sorted list (``row_sorted`` is its plain
    version). Samples on node -1, or on a node no row names, are not in it;
  * a block takes one (feature tile, row). A warp's 32 lanes are
    ``feat_tile`` features x ``32 // feat_tile`` sample slots; each lane
    owns a private column of the block's shared tile, so no two threads add
    into one cell and no atomics are needed;
  * a row of n_r samples is cut into ``min(columns, ceil(n_r /
    min_per_column))`` chunks (at least one; ``columns = warps * 32 //
    feat_tile``) of ``ceil(n_r / chunks)`` samples (``chunk_bounds``);
    column c (warp c // slots, slot c % slots) sums chunk c in ascending
    order, and the block merges the used columns of each (feature, bin) in
    column order.

``feat_tile`` narrows from 32 to 8 features until the grid holds
``TARGET_BLOCKS`` blocks, so a level of one row still spreads over the card;
``warps`` grows with the samples a row holds on average (``MIN_PER_COLUMN``
or more a column), up to what leaves two blocks an SM their shared tiles.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

FEAT_TILES = (32, 16, 8)  # features per warp, widest first
TARGET_BLOCKS = 256  # blocks the grid should hold before the tile narrows
MIN_PER_COLUMN = 32  # samples a chunk should hold before another is cut
MAX_WARPS = 8
SMEM_LIMIT = 232448  # bytes of shared memory a block may use (H100)


class HistPlan(NamedTuple):
    feat_tile: int  # features a warp covers (lanes per sample slot)
    warps: int  # warps a block
    grid: tuple[int, int]  # (feature tiles, rows)
    smem_bytes: int  # the block's shared tiles
    min_per_column: int = MIN_PER_COLUMN

    @property
    def columns(self) -> int:
        """The most chunks a row is cut into: one per lane column."""
        return self.warps * (32 // self.feat_tile)


def warp_bytes(n_bins: int) -> int:
    """Shared bytes of one warp's tile: grad and hess, B bins x 32 lanes."""
    return 2 * n_bins * 32 * 4


@functools.lru_cache(maxsize=256)
def plan(n: int, n_feat: int, n_bins: int, rows: int) -> HistPlan:
    """The launch shape for N samples, F features, B bins and R rows."""
    if n_bins < 1 or warp_bytes(n_bins) > SMEM_LIMIT or rows < 1 or n_feat < 1:
        raise ValueError(f"histogram kernel: no plan for F={n_feat}, B={n_bins}, R={rows}")
    feat_tile = FEAT_TILES[-1]
    for t in FEAT_TILES:
        if -(-n_feat // t) * rows >= TARGET_BLOCKS:
            feat_tile = t
            break
    slots = 32 // feat_tile
    max_warps = max(1, min(MAX_WARPS, (SMEM_LIMIT // 2) // warp_bytes(n_bins)))
    per_row = -(-max(n, 1) // rows)
    columns = min(max(1, -(-per_row // MIN_PER_COLUMN)), max_warps * slots)
    warps = -(-columns // slots)
    return HistPlan(feat_tile, warps, (-(-n_feat // feat_tile), rows),
                    warps * warp_bytes(n_bins))


def row_sorted(
    node_ids: torch.Tensor, active_nodes: torch.Tensor | None, n_nodes: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The row-sorted sample list: (order (M,) int64, row_off (R + 1,) int64).
    ``order[row_off[r]:row_off[r + 1]]`` are the samples of row r in
    ascending order. The device builds the same list (one count and one
    placement pass); this is its plain version."""
    rows = n_nodes if active_nodes is None else active_nodes.shape[0]
    target = (torch.arange(rows, device=node_ids.device) if active_nodes is None
              else active_nodes.long())
    hit = node_ids.long()[None, :] == target[:, None]  # (R, N)
    counts = hit.sum(1)
    order = torch.nonzero(hit)[:, 1]  # row-major: by row, then by sample
    return order, torch.cat([counts.new_zeros(1), counts.cumsum(0)])


def chunk_bounds(count: int, p: HistPlan) -> list[tuple[int, int]]:
    """The [start, end) of each chunk of a row of ``count`` samples
    (positions in the row's part of the list), in chunk order."""
    used = min(p.columns, max(1, -(-count // p.min_per_column)))
    size = -(-count // used)
    return [(min(count, c * size), min(count, (c + 1) * size)) for c in range(used)]
