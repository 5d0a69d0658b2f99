"""The launch plan of the dense histogram kernels, in plain Python and torch.

The staged histogram (``csrc/histogram.cu``) and the fused level's phases 0
and 1 (``csrc/level_build.cu``) run the same device code
(``csrc/level_common.cuh``: ``level_kernel``), and both wrappers take their
launch shape from ``plan`` here, so a fused level gives the staged level's
bits. The plan is a function of (N, F, B, R) alone; the device turns it
into chunks from the row counts alone. Nothing depends on the SM count, the
size of the grid actually launched, the timing or the stream.

How the work is cut:

  * the samples of each row (row r sums node ``active[r]``, or node r at
    a full level) are listed once per call, in ascending order, rows one
    after another: the row-sorted list (``row_sorted`` is its plain
    version). Samples on node -1, or on a node no row names, are not in it;
  * an item is one (feature tile, row, block of the row): the grid of
    items is ``(feature tiles, rows, splits)``. A block's warps are
    ``feat_tile`` features x ``32 // feat_tile`` sample slots each; each
    lane owns a private column of the block's shared tile, so no two
    threads add into one cell and no atomics are needed;
  * a row of n_r samples is cut into ``min(splits * columns, ceil(n_r /
    min_per_column))`` chunks (at least one; ``columns = warps * 32 //
    feat_tile``) of ``ceil(n_r / chunks)`` samples rounded up to a multiple
    of ``BATCH``, the last ones shorter or empty (``chunk_bounds``).
    Block k of the row sums chunks ``k * columns ..`` (column c, warp
    c // slots, slot c % slots, sums one chunk in ascending order) and
    merges its used columns of each (feature, bin) in column order; the
    row's used blocks are then added in block order (``merge_order``;
    ``plan_order_histogram`` is the whole sum in that order, in plain torch).

``feat_tile`` narrows from 32 to 8 features until the grid holds
``TARGET_BLOCKS`` (feature tile, row) pairs, about one an SM. A block has as
many warps as its rows' chunks want (``MIN_PER_COLUMN`` samples or more a
chunk), up to what the shared memory holds the tiles of (a warp's columns
and the merged tile) for two blocks an SM, or for one where the pairs fill
at most half the target; where the pairs fill at most the target, it has
that many in any case (the fused level's decide step and route use every
warp). Where the pairs fill at most half the target (a narrow F, a level of
one row) and a row wants more chunks than a block has columns, the row's
chunks are cut over ``splits`` blocks, as many as keep the items within
``TARGET_BLOCKS``.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

FEAT_TILES = (32, 16, 8)  # features per warp, widest first
TARGET_BLOCKS = 128  # items the grid should hold before the tile narrows or a row splits
MIN_PER_COLUMN = 32  # samples a chunk should hold before another is cut
MAX_WARPS = 8
MAX_SPLITS = 64  # blocks a (feature tile, row) is cut into, at most (csrc kMaxSplits)
BATCH = 8  # list positions a lane loads at once: chunk sizes are multiples of it
SMEM_LIMIT = 232448  # bytes of shared memory a block may use (H100)


class HistPlan(NamedTuple):
    feat_tile: int  # features a warp covers (lanes per sample slot)
    warps: int  # warps a block
    splits: int  # blocks a (feature tile, row) is cut into
    grid: tuple[int, int, int]  # items: (feature tiles, rows, splits)
    smem_bytes: int  # the block's shared tiles and merged tile
    min_per_column: int = MIN_PER_COLUMN

    @property
    def columns(self) -> int:
        """Lane columns a block: the most chunks one block sums."""
        return self.warps * (32 // self.feat_tile)


def warp_bytes(n_bins: int) -> int:
    """Shared bytes of one warp's tile: grad and hess, B bins x 32 lanes."""
    return 2 * n_bins * 32 * 4


def tile_bytes(feat_tile: int, n_bins: int) -> int:
    """Shared bytes of a block's merged tile: grad and hess, tile x B."""
    return 2 * feat_tile * n_bins * 4


@functools.lru_cache(maxsize=256)
def plan(n: int, n_feat: int, n_bins: int, rows: int) -> HistPlan:
    """The launch shape for N samples, F features, B bins and R rows."""
    fit = [t for t in FEAT_TILES if warp_bytes(n_bins) + tile_bytes(t, n_bins) <= SMEM_LIMIT]
    if n_bins < 1 or not fit or rows < 1 or n_feat < 1:
        raise ValueError(f"histogram kernel: no plan for F={n_feat}, B={n_bins}, R={rows}")
    feat_tile = fit[-1]
    for t in fit:
        if -(-n_feat // t) * rows >= TARGET_BLOCKS:
            feat_tile = t
            break
    tiles, slots = -(-n_feat // feat_tile), 32 // feat_tile
    merge = tile_bytes(feat_tile, n_bins)
    few = 2 * tiles * rows <= TARGET_BLOCKS  # the pairs fill at most half the target
    per_sm = 1 if few else 2  # blocks an SM whose tiles the shared memory holds
    max_warps = max(1, min(MAX_WARPS, (SMEM_LIMIT // per_sm - merge) // warp_bytes(n_bins)))
    want = -(-(-(-max(n, 1) // rows)) // MIN_PER_COLUMN)  # chunks of an average row
    warps = (max_warps if tiles * rows <= TARGET_BLOCKS
             else min(max_warps, -(-want // slots)))
    columns = warps * slots
    splits = 1
    if few and want > columns:
        splits = min(-(-want // columns), TARGET_BLOCKS // (tiles * rows), MAX_SPLITS)
    return HistPlan(feat_tile, warps, splits, (tiles, rows, splits),
                    warps * warp_bytes(n_bins) + merge)


def _align4(v: int) -> int:
    return -(-v // 4) * 4


def work_ints(p: HistPlan, n: int, n_bins: int, n_nodes: int = 0, fused: bool = False) -> int:
    """Int32 words of a launch's scratch (``level_common::work_layout``): the
    row-sorted list (each row's part starting at a multiple of 8, so N + 8 R
    positions) and each listed sample's (grad, hess) beside it, each row's
    count and offset, a ticket a (row, tile) where rows split, the fused
    level's (node, tile) gain partials, and each block's merged tile of a
    split row; every region 16-byte aligned."""
    tiles, rows, splits = p.grid
    listed = _align4(n + 8 * rows)
    head = (3 * listed + 2 * rows + (rows * tiles if splits > 1 else 0)
            + (2 * n_nodes * tiles if fused else 0))
    partials = rows * tiles * splits * 2 * p.feat_tile * n_bins if splits > 1 else 0
    return _align4(head) + partials


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
    chunks = min(p.splits * p.columns, max(1, -(-count // p.min_per_column)))
    size = -(-(-(-count // chunks)) // BATCH) * BATCH
    return [(min(count, c * size), min(count, (c + 1) * size)) for c in range(chunks)]


def merge_order(count: int, p: HistPlan) -> list[list[int]]:
    """The chunks of a row of ``count`` samples by block: block k's chunks in
    column order, the used blocks in block order. A cell's sum is its
    chunks' sums added in that order within each block, then the blocks'
    sums in block order."""
    chunks = len(chunk_bounds(count, p))
    return [list(range(k, min(k + p.columns, chunks))) for k in range(0, chunks, p.columns)]


def plan_order_histogram(
    bins: torch.Tensor, node_ids: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
    active_nodes: torch.Tensor | None, n_nodes: int, n_bins: int, p: HistPlan,
) -> torch.Tensor:
    """The (2, R, F, B) f32 histogram summed in the plan's order: each chunk
    in ascending sample order from zero, the chunks merged by
    ``merge_order``. The kernels add in this order, so on the card they give
    these bits exactly (every add is one f32 rounding)."""
    order, off = row_sorted(node_ids, active_nodes, n_nodes)
    rows, f = off.shape[0] - 1, bins.shape[1]
    dev = bins.device
    out = torch.zeros((2, rows, f, n_bins), dtype=torch.float32, device=dev)
    feats = torch.arange(f, device=dev)
    for r in range(rows):
        ids = order[off[r]:off[r + 1]]
        bounds = chunk_bounds(ids.shape[0], p)
        acc = torch.zeros((len(bounds), f, n_bins + 1, 2), dtype=torch.float32, device=dev)
        lo = torch.tensor([b[0] for b in bounds], device=dev)
        hi = torch.tensor([b[1] for b in bounds], device=dev)
        for i in range(int((hi - lo).max())):  # the i-th sample of every chunk
            live = (lo + i < hi).nonzero()[:, 0]
            s = ids[lo[live] + i]
            b = bins[s].long()
            b = torch.where((b >= 0) & (b < n_bins), b, n_bins)  # off-range bins add nowhere
            cell = (live[:, None], feats[None, :], b)
            acc[cell + (0,)] += grad[s][:, None]
            acc[cell + (1,)] += hess[s][:, None]
        blocks = []
        for chunks in merge_order(ids.shape[0], p):
            v = acc[chunks[0]]
            for c in chunks[1:]:
                v = v + acc[c]
            blocks.append(v)
        v = blocks[0]
        for u in blocks[1:]:
            v = v + u
        out[0, r], out[1, r] = v[:, :n_bins, 0], v[:, :n_bins, 1]
    return out
