"""The forest traversal's launch plan (``repro_torch.kernels.traversal_plan``),
on the CPU: the sample tile and tree split at the serving shapes (realsim
and multiclass, the main path's 4000 rows and the serving wave's 256), the
shared-memory budget, the one-wave grid, the rules the C entry point checks
again, and the entry point's arguments through a fake ``_build.function``.
The kernels themselves, under every plan, are held bitwise to the plain
version on the card (``tests/test_torch_cuda.py``)."""
import ctypes

import pytest
import torch

from repro_torch.kernels import _build, forest_traversal
from repro_torch.kernels import traversal_plan as tp

SMEM_LIMIT = 232448  # bytes a block may use on the H100
SMS = 132
# (rows, features, slots, depth, leaf bytes): realsim (F
# 1500, 400 slots, depth 9) and multiclass (F 60, 2000 slots, depth 6), f32,
# int8 and fp16, at 4000 rows and the serving wave's 256.
SHAPES = [(n, f, t, d, lb) for n in (4000, 256)
          for f, t, d in ((1500, 400, 9), (60, 2000, 6)) for lb in (4, 1, 2)]


@pytest.mark.parametrize("n,f,t,d,lb", SHAPES)
def test_plan_fits_the_card_and_passes_its_own_checks(n, f, t, d, lb):
    """Shared bytes under the limit, every chunk's leaves within a thread's
    stage, the grid one wave of the blocks an SM holds, each tile of 32
    rows a warp, the slab a whole number of tiles, the scratch enough."""
    p = tp.plan(n, f, t, d, lb, SMS)
    tp.check(p, f, t, d, lb)
    assert p.staged and p.row_bytes == tp.row_bytes(f)
    smem = p.smem_bytes(d, lb)
    assert smem <= SMEM_LIMIT
    assert p.chunk << d <= tp.STAGE[p.ahead] * p.threads
    per_sm = tp.blocks_per_sm(p.threads, smem)
    assert p.ahead == (2 if per_sm == 1 else 1)
    groups, tiles = p.grid(min(n, p.slab), t)
    assert groups * tiles <= SMS * per_sm
    assert groups * p.group >= t and p.samples % 32 == 0 and p.threads % p.samples == 0
    assert p.slab >= n and p.slab % p.samples == 0
    assert p.scratch_bytes >= tp.scratch_bytes(p.slab, t, p.row_bytes) >= 4 * t * n


@pytest.mark.parametrize("n,lb,samples,ahead", [
    (4000, 4, 128, 2),  # f32: 128 rows alone on an SM beat 64 rows
    (4000, 1, 64, 1),  # int8: 64 rows and their trees fit twice an SM
    (4000, 2, 64, 1),
    (256, 4, 128, 2),
])
def test_realsim_tile_is_the_largest_or_the_half_that_shares_an_sm(n, lb, samples, ahead):
    p = tp.plan(n, 1500, 400, 9, lb, SMS)
    assert (p.samples, p.ahead) == (samples, ahead)
    # A 1500-byte row is 375 words, odd: 32 rows reading one feature hit
    # 32 banks.
    assert p.row_bytes == 1500 and (p.row_bytes // 4) % 2 == 1


def test_multiclass_wave_splits_the_forest_over_the_card():
    """At 256 rows one sample tile holds every row, so the 2000 slots are
    cut into groups until the grid fills the card."""
    p = tp.plan(256, 60, 2000, 6, 4, SMS)
    groups, tiles = p.grid(256, 2000)
    assert tiles == 1 and groups * p.group >= 2000
    assert groups >= SMS
    big = tp.plan(4000, 60, 2000, 6, 4, SMS)
    assert big.samples == 512 and big.grid(4000, 2000)[1] == 8


def test_chunks_are_even_within_a_group():
    """A group is staged in chunks of one size (the last may be smaller by
    less than the number of chunks)."""
    for groups in (1, 3, 7, 33):
        p = tp.shaped(4000, 60, 2000, 6, 4, 512, 512, groups)
        n_chunks = -(-p.group // p.chunk)
        assert n_chunks * p.chunk - p.group < n_chunks


def test_rows_too_wide_for_shared_memory_are_read_from_device_memory():
    assert tp.staged_row_bytes(7000) == 7004
    assert tp.staged_row_bytes(20000) == 0
    p = tp.plan(1000, 20000, 10, 3, 4, SMS)
    assert not p.staged and p.smem_bytes(3, 4) == 0
    assert p.scratch_bytes == 4 * 10 * p.slab


def test_slabs_cap_the_scratch():
    p = tp.plan(100000, 1500, 400, 9, 4, SMS)
    assert p.slab < 100000 and p.slab % p.samples == 0
    assert p.scratch_bytes <= tp.SCRATCH_CAP + 2 * tp.SCRATCH_ALIGN


@pytest.mark.parametrize("change", [
    {"samples": 48, "threads": 96}, {"threads": 1024}, {"chunk": 0}, {"ahead": 3},
    {"slab": 100}, {"row_bytes": 1496}, {"scratch_bytes": 16}, {"chunk": 64},
])
def test_check_refuses_plans_the_kernel_does_not_take(change):
    """The rules the C entry point repeats: a tile of whole warps, threads
    a multiple of it and at most 512, a chunk within the stage and shared
    memory, one or two chunks in flight, whole tiles a slab, rows at least
    F bytes, scratch enough."""
    p = tp.plan(4000, 1500, 400, 9, 4, SMS)
    with pytest.raises(ValueError, match="breaks the kernel's rules"):
        tp.check(p._replace(**change), 1500, 400, 9, 4)


def test_launch_passes_the_plan_to_the_entry_point(monkeypatch):
    """``forest_traversal.launch``'s call of the C entry point, recorded on
    the CPU: the tensors' pointers, the shapes, the layout code, then the
    plan's integers and the scratch it allocated; the launch is counted
    under its form."""
    calls = []

    def fake_function(lib, symbol, argtypes):
        def fn(*args):
            calls.append((symbol, argtypes, args))
            return 0
        return fn

    monkeypatch.setattr(_build, "function", fake_function)
    monkeypatch.setattr(_build, "stream_of", lambda dev: 0)
    monkeypatch.setattr(forest_traversal, "form_launches",
                        dict.fromkeys(forest_traversal.form_launches, 0))
    n, f, t, d, k = 300, 60, 50, 6, 5
    bins = torch.zeros((n, f), dtype=torch.int32)
    feature = torch.zeros((t, 63), dtype=torch.int32)
    threshold = torch.zeros((t, 63), dtype=torch.int16)
    leaf = torch.zeros((t, 64), dtype=torch.float16)
    n_trees = torch.tensor(t, dtype=torch.int32)
    out = torch.empty((n, k))
    p = tp.plan(n, f, t, d, 2, SMS)
    forest_traversal.launch(p, bins, feature, threshold, leaf, n_trees, d, k, None, out)
    (symbol, argtypes, args), = calls
    assert symbol == "forest_traverse_launch" and len(argtypes) == len(args) == 23
    assert argtypes[21] is ctypes.c_longlong
    assert args[0] == bins.data_ptr() and args[4] is None and args[6] == out.data_ptr()
    assert args[8:14] == (n, f, t, d, k, 2)  # layout 2: int16 thresholds, fp16 leaves
    assert args[14:20] == (p.samples, p.threads, p.group, p.chunk, p.ahead, p.slab)
    assert args[20:22] == (p.row_bytes, p.scratch_bytes)
    assert forest_traversal.form_launches["k_fp16"] == 1
    assert sum(forest_traversal.form_launches.values()) == 1
