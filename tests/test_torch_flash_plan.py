"""The flash forward's launch plan (``repro_torch.kernels.flash_plan``), on
the CPU: the route of each (dtype, head dim), the wgmma kernel's shared
bytes and persistent grid, and the tensor maps of the views
``ops.flash_attention`` hands over, at granite-3-2b's shape and at ragged
ones. The kernels themselves, and their coverage of every work tile, are
held against their plain version on the card (``tests/test_torch_cuda.py``)."""
import ctypes

import pytest
import torch

from repro_torch.kernels import _build, flash_attention, flash_plan

SMEM_LIMIT = 232448  # bytes a block may use on the H100
GRANITE = (4, 2048, 2048, 32, 8, 64)  # b, sq, sk, h, kv, d: the prefill's shape
ZAMBA2 = (4, 2048, 2048, 32, 32, 64)  # zamba2's shared block: group 1


def _views(b, sq, sk, h, kv, d, dtype=torch.bfloat16):
    """q, k, v as ``ops.flash_attention`` passes them (the (B, S, H, d) model
    layout, transposed) and out as the wrapper allocates it."""
    q, k, v = (torch.empty(s, dtype=dtype).transpose(1, 2)
               for s in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d)))
    out = torch.empty((b, sq, h, d), dtype=dtype).transpose(1, 2)
    return q, k, v, out


@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 32, "mma_sync"), (torch.bfloat16, 80, "mma_sync"),
    (torch.float32, 32, "scalar"), (torch.float32, 64, "scalar"),
    (torch.float32, 80, "scalar"), (torch.float32, 128, "scalar"),
])
def test_route_by_dtype_and_head_dim(dtype, d, route):
    assert flash_plan.route(dtype, d) == route
    q, k, v, out = _views(1, 100, 100, 4, 2, d, dtype)
    assert flash_plan.plan(q, k, v, out, 100).route == route


def test_route_refuses_what_no_kernel_takes():
    with pytest.raises(ValueError, match="head dim"):
        flash_plan.route(torch.bfloat16, 96)
    with pytest.raises(TypeError, match="dtype"):
        flash_plan.route(torch.float16, 64)


def test_shared_bytes_stay_under_the_limit_for_every_route_and_stage_count():
    """The wgmma kernel's dynamic shared bytes (the other routes' are
    static): the q and out tiles, two stages of 128-key K and V tiles and
    the barriers, 1024-aligned. A third stage would not fit at d 128."""
    assert flash_plan.smem_bytes(64) == 99408
    assert flash_plan.smem_bytes(128) == 197712 <= SMEM_LIMIT
    assert flash_plan.smem_bytes(128) + 2 * 2 * 128 * 128 > SMEM_LIMIT


@pytest.mark.parametrize("b,sq,h,d,blocks", [
    (2, 1, 4, 64, 8), (1, 200, 8, 128, 16), (4, 2048, 32, 64, 132), (2, 1000, 16, 128, 132),
])
def test_persistent_grid_is_a_block_a_multiprocessor_while_the_tiles_last(b, sq, h, d, blocks):
    q, k, v, out = _views(b, sq, sq, h, h, d)
    p = flash_plan.plan(q, k, v, out, sq, sms=132)
    assert p.blocks == blocks == min(132, -(-sq // 128) * b * h)
    assert p.fields()[:4] == [128, 128, flash_plan.smem_bytes(d), blocks]


@pytest.mark.parametrize("b,sq,sk,h,kv,d,seq_k", [
    GRANITE + (2048,), ZAMBA2 + (2048,), (2, 1000, 1100, 16, 4, 128, 1050),
    (1, 1, 129, 4, 1, 64, 129), (1, 100, 100, 2, 2, 128, 100), (1, 200, 200, 8, 2, 64, 200),
    (1, 130, 300, 4, 4, 128, 300), (2, 64, 192, 4, 4, 64, 150), (1, 80, 128, 4, 2, 64, 77),
])
def test_tensor_maps_are_the_model_layout_views(b, sq, sk, h, kv, d, seq_k):
    q, k, v, out = _views(b, sq, sk, h, kv, d)
    p = flash_plan.plan(q, k, v, out, seq_k, sms=132)
    assert (p.route, p.d) == ("wgmma", d)
    # (B, S, H, d) storage: rows H d apart, heads d apart, batches S H d apart.
    want = {"q": ((d, sq, h, b), (2 * h * d, 2 * d, 2 * sq * h * d), (64, 128)),
            "k": ((d, seq_k, kv, b), (2 * kv * d, 2 * d, 2 * sk * kv * d), (64, 128)),
            "v": ((d, seq_k, kv, b), (2 * kv * d, 2 * d, 2 * sk * kv * d), (64, 128)),
            "out": ((d, sq, h, b), (2 * h * d, 2 * d, 2 * sq * h * d), (64, 64))}
    for name, (dims, strides, box) in want.items():
        m = p.maps[name]
        assert (m.dims, m.strides, m.box) == (dims, strides, box), name
        assert all(s > 0 and s % 16 == 0 for s in m.strides), name
    fields = dict(zip(flash_plan.PLAN_FIELDS, p.fields(), strict=True))
    work = -(-sq // 128) * b * h
    assert fields["blocks"] == min(132, work)
    assert fields["smem_bytes"] == flash_plan.smem_bytes(d)
    assert (fields["k_dim1"], fields["out_stride1"], fields["out_box1"]) == \
        (seq_k, 2 * h * d, 64)


def test_tensor_map_of_a_strided_out_follows_its_strides():
    """An out view inside a wider buffer: the map takes its own strides,
    not q's."""
    b, sq, h, d = 2, 200, 4, 64
    q, k, v, _ = _views(b, sq, sq, h, 2, d)
    wide = torch.empty((b, sq, h, 3 * d), dtype=torch.bfloat16)
    out = wide[..., d:2 * d].transpose(1, 2)  # (B, H, Sq, d), rows 3 d apart
    p = flash_plan.plan(q, k, v, out, sq)
    assert p.maps["out"].strides == (2 * h * 3 * d, 2 * 3 * d, 2 * sq * h * 3 * d)
    assert p.maps["q"].strides == (2 * h * d, 2 * d, 2 * sq * h * d)
    assert p.maps["out"].dims == (d, sq, h, b)


def test_launch_passes_the_plan_to_the_wgmma_entry_point(monkeypatch):
    """``_launch_fwd``'s call of the C entry point, recorded on the CPU: the
    shapes, then the plan's integers in ``PLAN_FIELDS`` order; the launch
    is counted under its route."""
    calls = []

    def fake_function(lib, symbol, argtypes):
        def fn(*args):
            calls.append((symbol, argtypes, args))
            return 0
        return fn

    monkeypatch.setattr(_build, "function", fake_function)
    monkeypatch.setattr(_build, "stream_of", lambda dev: 0)
    monkeypatch.setattr(flash_attention, "route_launches", dict.fromkeys(flash_plan.ROUTES, 0))
    monkeypatch.setattr(flash_attention, "launches", 0)
    b, sq, sk, h, kv, d = 1, 200, 300, 8, 2, 128
    q, k, v, out = _views(b, sq, sk, h, kv, d)
    lse = torch.empty((b, h, sq))
    p = flash_plan.plan(q, k, v, out, 250)
    flash_attention._launch_fwd(p, q, k, v, out, lse, True, 250)
    (symbol, argtypes, args), = calls
    assert symbol == "flash_attention_wgmma_launch"
    assert len(argtypes) == len(args) == 14
    assert args[5:12] == (d, b, h, kv, sq, 250, 1)
    assert list(args[12]) == p.fields()
    assert isinstance(args[12], ctypes.Array)
    assert flash_attention.route_launches == {"wgmma": 1, "mma_sync": 0, "scalar": 0}
    assert flash_attention.launches == 1

    q, k, v, out = _views(b, sq, sk, h, kv, 80)
    flash_attention._launch_fwd(flash_plan.plan(q, k, v, out, sk), q, k, v, out, lse, False,
                                sk)
    symbol, argtypes, args = calls[-1]
    assert symbol == "flash_attention_launch" and len(args) == len(argtypes) == 27
    assert args[5:14] == (1, 80, b, h, kv, sq, sk, sk, 0)
    assert flash_attention.route_launches["mma_sync"] == 1 and flash_attention.launches == 2
