"""The dense histogram kernels' launch plan (``repro_torch.kernels.hist_plan``),
on the CPU: the row-sorted sample list against numpy's stable argsort, the
chunks and their merge order across a row's blocks, the shared bytes a
block, the scratch words, the grid at realsim and multiclass width, the sum
in the plan's order against the plain histogram, and one plan for the staged
histogram and the fused level."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import hist_plan, histogram, level_build
from repro_torch.trees.learner import _smaller_children

SMEM_LIMIT = 232448  # bytes a block may use on the H100
REALSIM = {"n": 4000, "n_feat": 1500, "n_bins": 64}


def _nodes(seed, n, n_nodes, lo=-1, hi=None):
    rng = np.random.default_rng(seed)
    hi = n_nodes + 3 if hi is None else hi  # ids past the level: on no row
    return rng.integers(lo, hi, n).astype(np.int32)


def _numpy_partition(node, targets):
    """Row r's samples are the samples on node targets[r], ascending: the
    stable argsort of each sample's row, with samples on no row dropped."""
    row = np.full(node.shape, len(targets), np.int64)
    for r, t in enumerate(targets):
        row[node == t] = r
    order = np.argsort(row, kind="stable")
    order = order[row[order] < len(targets)]
    counts = np.array([(row == r).sum() for r in range(len(targets))], np.int64)
    return order, np.concatenate([[0], np.cumsum(counts)])


@pytest.mark.parametrize("seed,n,n_nodes", [(0, 1, 1), (1, 333, 1), (2, 4001, 8),
                                           (3, 64, 256), (4, 1000, 16)])
@pytest.mark.parametrize("subset", [False, True])
def test_row_sorted_is_the_stable_argsort_partition(seed, n, n_nodes, subset):
    node = _nodes(seed, n, n_nodes)
    if subset:
        active = np.arange(n_nodes - 1, -1, -2, dtype=np.int32)  # reversed, every other
        targets = active
    else:
        active, targets = None, np.arange(n_nodes)
    order, off = hist_plan.row_sorted(
        torch.from_numpy(node), None if active is None else torch.from_numpy(active), n_nodes)
    want_order, want_off = _numpy_partition(node, targets)
    np.testing.assert_array_equal(order.numpy(), want_order)
    np.testing.assert_array_equal(off.numpy(), want_off)
    listed = node[order.numpy()]
    assert (listed >= 0).all() and np.isin(listed, targets).all()
    assert len(order) == np.isin(node, targets).sum()


def test_row_sorted_keeps_empty_rows():
    node = np.array([3, 3, -1, 0, 9, 3, 0], np.int32)
    active = torch.tensor([2, 0, 3, 1], dtype=torch.int32)  # rows 0 and 3 empty
    order, off = hist_plan.row_sorted(torch.from_numpy(node), active, 4)
    assert order.tolist() == [3, 6, 0, 1, 5]
    assert off.tolist() == [0, 0, 2, 5, 5]


@pytest.mark.parametrize("count", [0, 1, 31, 32, 33, 143, 4000, 4001])
@pytest.mark.parametrize("rows", [1, 2, 8, 128])
def test_every_sample_in_exactly_one_chunk(count, rows):
    p = hist_plan.plan(4000, 1500, 64, rows)
    bounds = hist_plan.chunk_bounds(count, p)
    assert 1 <= len(bounds) <= p.splits * p.columns
    # A chunk is cut only for min_per_column samples or more.
    assert len(bounds) == 1 or len(bounds) <= -(-count // p.min_per_column)
    covered = np.zeros(count, np.int64)
    for lo, hi in bounds:
        assert 0 <= lo <= hi <= count
        covered[lo:hi] += 1
    assert (covered == 1).all()
    # Chunks follow each other in column order: the merge order is the
    # samples' order.
    assert all(a[1] <= b[0] for a, b in zip(bounds, bounds[1:]))


@pytest.mark.parametrize("n_bins", [1, 2, 16, 63, 64, 100, 128, 255, 256])
@pytest.mark.parametrize("n,n_feat,rows", [(4000, 1500, 1), (4000, 1500, 128), (7, 3, 1),
                                           (100000, 28, 2), (4000, 1500, 4096)])
def test_shared_bytes_fit_a_block(n_bins, n, n_feat, rows):
    plan = hist_plan.plan(n, n_feat, n_bins, rows)
    # A warp's columns, and the merged tile the block keeps.
    assert plan.smem_bytes == (plan.warps * 2 * n_bins * 32 * 4
                               + 2 * plan.feat_tile * n_bins * 4)
    assert plan.smem_bytes <= SMEM_LIMIT
    assert 1 <= plan.warps <= hist_plan.MAX_WARPS and plan.feat_tile in hist_plan.FEAT_TILES
    assert 1 <= plan.splits <= hist_plan.MAX_SPLITS
    assert plan.grid == (-(-n_feat // plan.feat_tile), rows, plan.splits)
    # Two blocks an SM keep their tiles where more than one warp is asked,
    # unless the (feature tile, row) pairs fill at most half the target.
    few = 2 * plan.grid[0] * rows <= hist_plan.TARGET_BLOCKS
    assert plan.warps == 1 or 2 * plan.smem_bytes <= SMEM_LIMIT or few


def test_plan_rejects_what_no_block_holds():
    with pytest.raises(ValueError):
        hist_plan.plan(100, 10, 1000, 1)  # one warp's tile is 256 KB


def test_realsim_level0_fills_the_card():
    plan = hist_plan.plan(REALSIM["n"], REALSIM["n_feat"], REALSIM["n_bins"], 1)
    items = plan.grid[0] * plan.grid[1] * plan.grid[2]
    assert items >= 132, "at least one block for each of the H100's 132 SMs"
    assert plan.splits == 1  # 188 tiles fill the card: the row is not cut further
    assert plan.columns >= 2 * plan.warps  # several sample slots a warp
    # Every chunk of the row of 4000 samples is short: about 167 samples,
    # rounded up to 168 (a multiple of the 8 positions a lane loads at once).
    bounds = hist_plan.chunk_bounds(4000, plan)
    assert len(bounds) == plan.splits * plan.columns
    assert max(hi - lo for lo, hi in bounds) == 168


def test_realsim_deep_levels_take_one_warp_a_block():
    # Level 8's smaller children: 128 rows of about 10 samples; the output
    # write is the cost, so a block is one warp over 32 features.
    plan = hist_plan.plan(REALSIM["n"], REALSIM["n_feat"], REALSIM["n_bins"], 128)
    assert (plan.feat_tile, plan.warps, plan.columns) == (32, 1, 1)


def test_small_rows_use_few_columns():
    # A smaller child of 55 samples at realsim level 1 (one row): two of the
    # 24 columns (28 samples each, rounded up to 32), so one warp of six
    # zeroes and merges its tile.
    plan = hist_plan.plan(REALSIM["n"], REALSIM["n_feat"], REALSIM["n_bins"], 1)
    assert plan.columns == 24
    assert [hi - lo for lo, hi in hist_plan.chunk_bounds(55, plan)] == [32, 23]
    assert hist_plan.merge_order(55, plan) == [[0, 1]]


def test_plan_depends_on_the_shape_only():
    a = hist_plan.plan(4000, 1500, 64, 8)
    hist_plan.plan.cache_clear()
    assert hist_plan.plan(4000, 1500, 64, 8) == a


@pytest.mark.parametrize("level", range(9))
def test_staged_and_fused_wrappers_take_one_plan(level):
    """At every realsim level the staged histogram wrapper and the fused
    level's wrapper plan phase A alike, for the rows the learner hands each
    (``_level_histogram`` and ``_fused_level``)."""
    rng = np.random.default_rng(level)
    n, f, b = REALSIM["n"], REALSIM["n_feat"], REALSIM["n_bins"]
    bins = torch.zeros((n, f), dtype=torch.int32)
    n_nodes = 1 << level
    node = torch.from_numpy(rng.integers(0, n_nodes, n).astype(np.int32))
    h = torch.from_numpy(rng.binomial(1, 0.8, n).astype(np.float32))
    if level == 0:  # a full level: the staged wrapper's identity rows
        staged = histogram.launch_plan(bins, n_nodes, b, None)
        fused = level_build.launch_plan(bins, torch.arange(n_nodes, dtype=torch.int32), b)
    else:  # a subtract level: the smaller children, both ways
        active = _smaller_children(node, h, n_nodes)
        staged = histogram.launch_plan(bins, n_nodes, b, active)
        fused = level_build.launch_plan(bins, active, b)
    assert staged == fused
    # A rebuild level: every node, full in the staged wrapper, enumerated in
    # the fused one.
    assert histogram.launch_plan(bins, n_nodes, b, None) == level_build.launch_plan(
        bins, torch.arange(n_nodes, dtype=torch.int32), b)


MULTICLASS = {"n": 4000, "n_feat": 60, "n_bins": 64}


@pytest.mark.parametrize("count", [0, 1, 31, 33, 100, 767, 768, 769, 4000])
@pytest.mark.parametrize("shape", ["realsim", "multiclass"])
def test_merge_order_takes_each_chunk_once(count, shape):
    """A row's chunks by block: each chunk in exactly one block, in chunk
    order; a block holds at most its columns, the row at most its splits."""
    plan = hist_plan.plan(**(REALSIM if shape == "realsim" else MULTICLASS), rows=1)
    blocks = hist_plan.merge_order(count, plan)
    assert [c for b in blocks for c in b] == list(range(len(hist_plan.chunk_bounds(count, plan))))
    assert 1 <= len(blocks) <= plan.splits
    assert all(1 <= len(b) <= plan.columns for b in blocks)


@pytest.mark.parametrize("level", range(6))
def test_narrow_f_cuts_rows_over_blocks(level):
    """At the multiclass width (F 60: eight tiles of eight features) the
    levels of few rows cut each row over blocks, so every chunk stays near
    MIN_PER_COLUMN samples instead of a lane summing 143."""
    rows = 1 if level == 0 else 1 << (level - 1)
    plan = hist_plan.plan(**MULTICLASS, rows=rows)
    assert plan.feat_tile == 8 and plan.grid[:2] == (8, rows)
    per_row = MULTICLASS["n"] // rows
    assert max(hi - lo for lo, hi in hist_plan.chunk_bounds(per_row, plan)) <= 32
    assert (plan.splits > 1) == (per_row > 32 * plan.columns)


@pytest.mark.parametrize("n,n_feat,n_bins,rows,fused", [
    (4000, 1500, 64, 1, True), (4000, 60, 64, 1, False), (4000, 60, 64, 16, True),
    (333, 61, 63, 4, False), (7, 1, 256, 1, True)])
def test_work_ints_holds_the_launch_scratch(n, n_feat, n_bins, rows, fused):
    """The scratch words: the list (each row's part 8-aligned) and each
    listed sample's (grad, hess), each row's count and offset, a ticket a
    (row, tile) and every block's merged tile where rows split, the (node,
    tile) gain partials of a fused level; every region 16-byte aligned."""
    plan = hist_plan.plan(n, n_feat, n_bins, rows)
    tiles, _, splits = plan.grid
    n_nodes = 2 * rows
    listed = -(-(n + 8 * rows) // 4) * 4
    head = (3 * listed + 2 * rows + (rows * tiles if splits > 1 else 0)
            + (2 * n_nodes * tiles if fused else 0))
    want = -(-head // 4) * 4 + (rows * tiles * splits * 2 * plan.feat_tile * n_bins
                                if splits > 1 else 0)
    assert hist_plan.work_ints(plan, n, n_bins, n_nodes, fused) == want


def _level_inputs(seed, n, f, n_bins, n_nodes):
    rng = np.random.default_rng(seed)
    bins = torch.from_numpy(rng.integers(0, n_bins, (n, f)).astype(np.int32))
    node = torch.from_numpy(_nodes(seed, n, n_nodes, hi=n_nodes))
    hess = torch.from_numpy((1.25 * rng.binomial(1, 0.8, n)).astype(np.float32))
    grad = hess * torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    return bins, node, grad, hess


# Split rows (realsim's level 0 plan at a few hundred samples, multiclass),
# F 61 and 1, B 63 and 256, rows with no sample and with one.
@pytest.mark.parametrize("n,f,n_bins,n_nodes,subset", [
    (700, 60, 64, 1, False), (900, 61, 63, 4, True), (300, 1, 256, 2, False),
    (200, 9, 16, 8, True)])
def test_plan_order_histogram_is_the_histogram(n, f, n_bins, n_nodes, subset):
    """The sum in the plan's order (the kernels' order) is the histogram,
    within f32 rounding of the plain version's."""
    bins, node, grad, hess = _level_inputs(n + f, n, f, n_bins, n_nodes)
    active = None
    if subset:
        active = torch.arange(n_nodes - 1, -1, -2, dtype=torch.int32)
        node[node == active[0]] = -1  # a row with no sample
        node[int((node == active[1]).nonzero()[0])] = int(active[-1])
    rows = n_nodes if active is None else active.shape[0]
    plan = hist_plan.plan(n, f, n_bins, rows)._replace(min_per_column=4)  # many chunks
    got = hist_plan.plan_order_histogram(bins, node, grad, hess, active, n_nodes, n_bins, plan)
    want = histogram.histogram_plain(bins, node, grad, hess, n_nodes, n_bins, active)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))
    if subset:
        assert float(got[:, 0].abs().sum()) == 0.0
