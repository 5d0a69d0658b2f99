"""The flash backward's launch plan (``flash_plan.bwd_plan``), on the CPU:
the route of each (dtype, head dim), the wgmma kernels' shared bytes and
persistent grids, the tensor maps of the views ``_bwd_operands`` allocates
or receives, at granite-3-2b's training shape and at ragged ones, and the
C entry points' arguments through a fake ``_build.function``. The kernels
themselves are held against their plain version on the card
(``tests/test_torch_cuda.py``)."""
import ctypes

import pytest
import torch

from repro_torch.kernels import _build, flash_attention, flash_plan

SMEM_LIMIT = 232448  # bytes a block may use on the H100
GRANITE = (4, 2048, 2048, 32, 8, 64)  # b, sq, sk, h, kv, d: the training shape
ZAMBA2 = (4, 2048, 2048, 32, 32, 64)  # zamba2's shared block: group 1


@pytest.fixture(autouse=True)
def _h100(monkeypatch):
    """Plan for an H100's 132 multiprocessors (the CPU has none to ask)."""
    monkeypatch.setattr(flash_attention, "_multiprocessors", lambda dev: 132)


def _operands(b, sq, sk, h, kv, d, dtype=torch.bfloat16, seq_k=None, causal=True,
              strided_do=False):
    """q, k, v, out, do as ``FlashAttention.backward`` passes them (the (B, S,
    H, d) model layout, transposed), lse, then ``_bwd_operands`` on them."""
    q, k, v = (torch.zeros(s, dtype=dtype).transpose(1, 2)
               for s in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d)))
    out = torch.zeros((b, sq, h, d), dtype=dtype).transpose(1, 2)
    if strided_do:  # a gradient inside a wider buffer: rows 3 d apart
        do = torch.zeros((b, sq, h, 3 * d), dtype=dtype)[..., d:2 * d].transpose(1, 2)
    else:
        do = torch.zeros((b, sq, h, d), dtype=dtype).transpose(1, 2)
    lse = torch.zeros((b, h, sq))
    return flash_attention._bwd_operands(q, k, v, out, lse, do, causal, seq_k)


@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 32, "mma_sync"), (torch.bfloat16, 80, "mma_sync"),
    (torch.float32, 64, "scalar"), (torch.float32, 128, "scalar"),
])
def test_bwd_route_by_dtype_and_head_dim(dtype, d, route):
    o = _operands(1, 100, 100, 4, 2, d, dtype)
    p = o["plan"]
    assert p.route == route == flash_plan.route(dtype, d)
    if route == "wgmma":
        assert set(p.kernels) == {"dq", "dkv"}
        assert p.ld == 128 and o["delta"].shape == o["lse2"].shape == (1, 4, 128)
    else:  # the mma_sync and scalar kernels take delta (B, H, Sq), no lse2
        assert p.kernels is None and p.ld == 100 and o["lse2"] is None
        assert o["delta"].shape == (1, 4, 100)


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
@pytest.mark.parametrize("d", [64, 128])
def test_bwd_shared_bytes_stay_under_the_limit(kernel, d):
    """Each built instance: its tiles, ring and barriers, 1024-aligned, fit
    the 232,448 bytes a block may use."""
    t = flash_plan.BWD_TILING[kernel, d]
    tiles = (3 * t.bq + 2 * t.stages * t.bk if kernel == "dq"
             else 4 * t.bk + 2 * t.stages * t.bq)
    rows = 0 if kernel == "dq" else 2 * 4 * t.stages * t.bq  # lse2 and delta slices
    want = 2 * d * tiles + rows + 8 * (2 + 2 * t.stages) + 1024
    assert flash_plan.bwd_smem_bytes(kernel, d) == want <= SMEM_LIMIT


def test_bwd_tiling_of_the_training_shape():
    """dq: 128 q rows (64 a consumer warpgroup) over 128-key tiles at d 64
    and 64-key tiles at d 128, three stages; dk/dv: 128 keys over q tiles
    of 128 rows in two stages at d 64, of 64 rows in three at d 128."""
    assert flash_plan.BWD_TILING["dq", 64] == (128, 128, 3)
    assert flash_plan.BWD_TILING["dq", 128] == (128, 64, 3)
    assert flash_plan.BWD_TILING["dkv", 64] == (128, 128, 2)
    assert flash_plan.BWD_TILING["dkv", 128] == (64, 128, 3)


@pytest.mark.parametrize("b,sq,sk,h,kv,d,dq_blocks,dkv_blocks", [
    (4, 2048, 2048, 32, 8, 64, 132, 132),  # 2048 and 512 work tiles
    (2, 1000, 1100, 16, 4, 128, 132, 72),  # 256 and 72
    (1, 130, 300, 4, 4, 128, 8, 12),
    (2, 1, 129, 4, 1, 64, 8, 4),
])
def test_bwd_persistent_grid_is_a_block_a_multiprocessor_while_the_tiles_last(
        b, sq, sk, h, kv, d, dq_blocks, dkv_blocks):
    p = _operands(b, sq, sk, h, kv, d)["plan"]
    dq, dkv = p.kernels["dq"], p.kernels["dkv"]
    assert dq.blocks == dq_blocks == min(132, -(-sq // dq.tiling.bq) * b * h)
    assert dkv.blocks == dkv_blocks == min(132, -(-sk // dkv.tiling.bk) * b * kv)
    for kp in (dq, dkv):
        head = dict(zip(flash_plan.BWD_PLAN_HEAD, kp.fields()))
        assert head == {"bq": kp.tiling.bq, "bk": kp.tiling.bk, "stages": kp.tiling.stages,
                        "smem_bytes": flash_plan.bwd_smem_bytes(kp.kernel, d),
                        "blocks": kp.blocks, "ld": -(-sq // 128) * 128}


@pytest.mark.parametrize("b,sq,sk,h,kv,d,seq_k,strided_do", [
    GRANITE + (None, False), GRANITE + (None, True), ZAMBA2 + (None, False),
    (1, 130, 300, 4, 4, 128, None, False), (1, 130, 300, 4, 1, 64, 250, True),
    (2, 1000, 1100, 16, 4, 128, 950, False),
])
def test_bwd_tensor_maps_are_the_views(b, sq, sk, h, kv, d, seq_k, strided_do):
    """Every map's dims and byte strides are its view's: q, do and dq (B, Sq,
    H, d) storage (do's own strides where it is strided), k, v, dk and dv
    (B, Sk, KV, d); k and v end at seq_k, dk and dv at Sk."""
    o = _operands(b, sq, sk, h, kv, d, seq_k=seq_k, strided_do=strided_do)
    p = o["plan"]
    seq_k = sk if seq_k is None else seq_k
    cols = 3 * d if strided_do else d
    q_strides = (2 * h * d, 2 * d, 2 * sq * h * d)
    k_strides = (2 * kv * d, 2 * d, 2 * sk * kv * d)
    want = {"q": ((d, sq, h, b), q_strides), "dq": ((d, sq, h, b), q_strides),
            "do": ((d, sq, h, b), (2 * h * cols, 2 * cols, 2 * sq * h * cols)),
            "k": ((d, seq_k, kv, b), k_strides), "v": ((d, seq_k, kv, b), k_strides),
            "dk": ((d, sk, kv, b), k_strides), "dv": ((d, sk, kv, b), k_strides)}
    for kernel in ("dq", "dkv"):
        kp = p.kernels[kernel]
        t = kp.tiling
        box_rows = {"q": t.bq, "do": t.bq, "k": t.bk, "v": t.bk, "dq": 64, "dk": 64, "dv": 64}
        for name in flash_plan.BWD_MAPS[kernel]:
            m = kp.maps[name]
            assert (m.dims, m.strides, m.box) == (*want[name], (64, box_rows[name])), \
                (kernel, name)
            assert all(s > 0 and s % 16 == 0 for s in m.strides), (kernel, name)
            view = o[name]
            el = view.element_size()
            assert m.strides == tuple(el * s for s in view.stride()[2::-1]), (kernel, name)
        fields = kp.fields()
        n_maps = len(flash_plan.BWD_MAPS[kernel])
        assert len(fields) == len(flash_plan.BWD_PLAN_HEAD) + 9 * n_maps


def test_bwd_launch_passes_the_plan_to_the_entry_points(monkeypatch):
    """``flash_attention_bwd``'s calls of the C entry points, recorded on the
    CPU: the delta kernel with lse2 and the padded row length, then the dq
    and dk/dv kernels of the wgmma route with their plans' integers. A
    d-80 call takes the mma_sync entry point for all three, with no lse2
    and ld = Sq. The operands are meta tensors (shapes and strides, no
    storage), so nothing is launched or read."""
    calls = []

    def fake_function(lib, symbol, argtypes):
        def fn(*args):
            calls.append((symbol, argtypes, args))
            return 0
        return fn

    monkeypatch.setattr(_build, "function", fake_function)
    monkeypatch.setattr(_build, "stream_of", lambda dev: 0)
    monkeypatch.setattr(flash_attention, "_check_view", lambda *a: None)
    fake = torch.device("meta")
    b, sq, sk, h, kv, d = 1, 200, 300, 8, 2, 128
    q, out, do = (torch.empty((b, sq, h, d), dtype=torch.bfloat16, device=fake).transpose(1, 2)
                  for _ in range(3))
    k, v = (torch.empty((b, sk, kv, d), dtype=torch.bfloat16, device=fake).transpose(1, 2)
            for _ in range(2))
    lse = torch.empty((b, h, sq), device=fake)
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda t: 0x1000)
    monkeypatch.setattr(_build, "require", lambda *a: None)
    o = flash_attention._bwd_operands(q, k, v, out, lse, do, True, 250)
    for kernel in flash_attention.BWD_KERNELS:
        flash_attention._launch_bwd(kernel, o)
    (s0, a0, x0), (s1, a1, x1), (s2, a2, x2) = calls
    assert s0 == "flash_attention_bwd_launch" and len(a0) == len(x0) == 24
    assert x0[0] == 0 and x0[8] == 0x1000  # which, lse2
    assert x0[12:22] == (1, d, b, h, kv, sq, sk, 250, 1, 256)  # ..., causal, ld
    for which, (sym, argtypes, args) in ((1, (s1, a1, x1)), (2, (s2, a2, x2))):
        kp = o["plan"].kernels[flash_attention.BWD_KERNELS[which]]
        assert sym == "flash_attention_bwd_wgmma_launch"
        assert len(argtypes) == len(args) == 20
        assert args[0] == which and args[10:18] == (d, b, h, kv, sq, sk, 250, 1)
        assert isinstance(args[18], ctypes.Array) and list(args[18]) == kp.fields()

    calls.clear()
    q80, out80, do80 = (x[..., :80] for x in (q, out, do))
    k80, v80 = k[..., :80], v[..., :80]
    o = flash_attention._bwd_operands(q80, k80, v80, out80, lse, do80, False, None)
    for kernel in flash_attention.BWD_KERNELS:
        flash_attention._launch_bwd(kernel, o)
    assert [c[0] for c in calls] == ["flash_attention_bwd_launch"] * 3
    for which, (_, _, args) in enumerate(calls):
        assert args[0] == which and args[8] is None and args[21] == sq  # no lse2; ld = Sq
