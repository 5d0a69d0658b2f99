"""The flash-attention launch plans, forward and backward, in plain Python.

The wrapper (``kernels/flash_attention.py``) and ``chip_smoke.py`` both take
the forward's launch from ``plan`` here and the backward's from
``bwd_plan``; the C entry points of ``csrc/flash_attention.cu`` and
``csrc/flash_attention_bwd.cu`` check what they are given against the
shapes.

Routes, by (dtype, head dim), each a hand-written kernel:

  * ``"wgmma"``: bf16 at d 64 and 128. Work tiles of one q head's 128-row
    q tile, heaviest first (every (batch, head) of the last q tile, then of
    the one before); a persistent grid of one block a multiprocessor
    (``sms``) while the tiles last, block i taking tiles i, i + blocks, ...
    The q, k, v and out views are read and written by TMA through 4-D
    tensor maps (innermost first: d, rows, heads, batch) with the views'
    own byte strides, boxes of 64 columns (128 bytes, one swizzle row); K
    and V tiles of ``WGMMA_BK`` keys in a ring of ``WGMMA_STAGES`` stages.
    The k and v maps end at ``seq_k`` rows, so keys past it load as zeros.
    At d 128 the two consumer warpgroups take turns to issue their products
    (ping-pong); at d 64 they do not. That tiling was the fastest of those
    timed at granite-3-2b's prefill shape (``PERF.md``).
  * ``"mma_sync"``: bf16 at d 32 and 80 (80 columns do not fill 128-byte
    swizzle rows evenly), and ``"scalar"``: f32 at every head dim. Their
    tiling and grid are the C entry point's own; the plan holds only the
    route.

The backward takes the same routes by (dtype, head dim). Its "wgmma" route
has two kernels, each with a persistent grid of one block a multiprocessor
while the work tiles last, both reading q, k, v and do by TMA through the
views' own strides and storing their outputs by TMA:

  * ``"dq"``: work tiles of one q head's ``bq``-row q tile (64 rows a
    consumer warpgroup), heaviest first; q and do loaded once a tile, K
    and V tiles of ``bk`` keys in a ring of ``stages``.
  * ``"dkv"``: work tiles of one kv head's ``bk``-key tile (64 keys a
    consumer warpgroup), heaviest first; K and V loaded once a tile, the
    group's q and do tiles of ``bq`` rows, each with its slices of lse
    (times log2 e) and delta, in a ring of ``stages``.

Each tiling was the fastest of those timed at granite-3-2b's training
shape (``tools/flash_bwd_variants.py``, ``PERF.md``).

lse2 = lse log2 e and delta are (B, H, ``ld``) f32 with rows padded to a
multiple of ``LD_ROWS`` (the delta kernel writes both, zeros past Sq), so
each q tile's slices are 16-byte aligned for a bulk copy at any Sq.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

ROUTES = ("wgmma", "mma_sync", "scalar")
HEAD_DIMS = (32, 64, 80, 128)  # the kernels' compile-time head dims
BOX_COLS = 64  # a TMA box row: 64 bf16, 128 bytes
WGMMA_BQ = 128  # q rows a block: 64 for each of two consumer warpgroups
WGMMA_BK = 128  # keys a K/V tile
WGMMA_STAGES = 2  # K/V tiles in flight
OUT_BOX_ROWS = 64  # each consumer warpgroup stores its own 64 rows
H100_SMS = 132  # streaming multiprocessors: the persistent grid's size where none is given
MAP_NAMES = ("q", "k", "v", "out")
LD_ROWS = 128  # the backward's lse2 and delta rows are padded to a multiple of this
# The integers the wgmma entry point takes, in order.
PLAN_FIELDS = ("bq", "bk", "smem_bytes", "blocks") + tuple(
    f"{name}_{field}" for name in MAP_NAMES
    for field in ("dim0", "dim1", "dim2", "dim3", "stride1", "stride2", "stride3",
                  "box0", "box1"))


class TensorMap(NamedTuple):
    dims: tuple[int, int, int, int]  # (d, rows, heads, batch), innermost first
    strides: tuple[int, int, int]  # bytes between rows, heads and batches
    box: tuple[int, int]  # (columns, rows) a copy moves


class FlashPlan(NamedTuple):
    route: str
    d: int
    blocks: int | None = None  # the persistent grid (wgmma route)
    maps: dict | None = None  # name -> TensorMap (wgmma route)

    def fields(self) -> list[int]:
        """The wgmma entry point's integers, in ``PLAN_FIELDS`` order."""
        out = [WGMMA_BQ, WGMMA_BK, smem_bytes(self.d), self.blocks]
        for name in MAP_NAMES:
            m = self.maps[name]
            out += [*m.dims, *m.strides, *m.box]
        return out


def route(dtype: torch.dtype, d: int) -> str:
    """The kernel that serves (dtype, d); raises for a pair no kernel takes."""
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d}; the kernels are built for "
                         f"{HEAD_DIMS}")
    if dtype == torch.bfloat16:
        return "wgmma" if d in (64, 128) else "mma_sync"
    if dtype == torch.float32:
        return "scalar"
    raise TypeError(f"flash_attention: dtype {dtype}; the kernels take bf16 or f32")


def smem_bytes(d: int) -> int:
    """Shared bytes a block of the wgmma kernel at head dim ``d`` uses: the
    q and out tiles, the ring's K and V tiles, 2 + 4 stages mbarriers, and
    1024 bytes of slack that align the base for the 128-byte swizzle."""
    return 2 * d * (2 * WGMMA_BQ + 2 * WGMMA_STAGES * WGMMA_BK) + 8 * (2 + 4 * WGMMA_STAGES) \
        + 1024


def tensor_map(t: torch.Tensor, rows: int, box_rows: int) -> TensorMap:
    """The 4-D map of a (batch, heads, rows, d) view with a contiguous last
    dimension: its first ``rows`` rows, a box of 64 columns by ``box_rows``."""
    b, h, _, d = t.shape
    el = t.element_size()
    return TensorMap((d, rows, h, b), (el * t.stride(2), el * t.stride(1), el * t.stride(0)),
                     (BOX_COLS, box_rows))


def plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
         seq_k: int, sms: int = H100_SMS) -> FlashPlan:
    """The launch of the forward on q (B, H, Sq, d), k, v (B, KV, Sk, d) and
    out (B, H, Sq, d), keys past ``seq_k`` masked, on a card of ``sms``
    multiprocessors."""
    b, h, sq, d = q.shape
    r = route(q.dtype, d)
    if r != "wgmma":
        return FlashPlan(r, d)
    work = -(-sq // WGMMA_BQ) * b * h
    maps = {"q": tensor_map(q, sq, WGMMA_BQ), "k": tensor_map(k, seq_k, WGMMA_BK),
            "v": tensor_map(v, seq_k, WGMMA_BK), "out": tensor_map(out, sq, OUT_BOX_ROWS)}
    return FlashPlan(r, d, min(sms, work), maps)


class BwdTiling(NamedTuple):
    bq: int  # q rows a tile
    bk: int  # keys a tile
    stages: int  # ring stages: K/V tiles (dq) or q/do tiles (dk/dv)


# The backward's wgmma instances, by (kernel, head dim); the C instances
# (csrc/flash_attention_bwd.cu: DqTiling, DkvTiling) hold the same.
BWD_TILING = {
    ("dq", 64): BwdTiling(128, 128, 3), ("dq", 128): BwdTiling(128, 64, 3),
    ("dkv", 64): BwdTiling(128, 128, 2), ("dkv", 128): BwdTiling(64, 128, 3),
}
BWD_MAPS = {"dq": ("q", "k", "v", "do", "dq"), "dkv": ("q", "k", "v", "do", "dk", "dv")}
# The integers the backward's wgmma entry point takes ahead of its maps.
BWD_PLAN_HEAD = ("bq", "bk", "stages", "smem_bytes", "blocks", "ld")


def bwd_smem_bytes(kernel: str, d: int) -> int:
    """Shared bytes a block of the backward's wgmma kernel ``kernel`` uses at
    head dim ``d``. dq: the q, do and dq tiles, the ring's K and V tiles.
    dk/dv: the K, V, dk and dv tiles, the ring's q and do tiles and lse2
    and delta slices. Then 2 + 2 stages mbarriers and 1024 bytes of slack
    that align the base for the 128-byte swizzle."""
    t = BWD_TILING[kernel, d]
    bars = 8 * (2 + 2 * t.stages) + 1024
    if kernel == "dq":
        return 2 * d * (3 * t.bq + 2 * t.stages * t.bk) + bars
    return 2 * d * (4 * t.bk + 2 * t.stages * t.bq) + 8 * t.stages * t.bq + bars


class BwdKernelPlan(NamedTuple):
    kernel: str  # "dq" or "dkv"
    tiling: BwdTiling
    smem: int
    blocks: int  # the persistent grid
    ld: int
    maps: dict  # name -> TensorMap, the names of BWD_MAPS[kernel]

    def fields(self) -> list[int]:
        """The entry point's integers: ``BWD_PLAN_HEAD``, then each map's
        dims, byte strides and box in ``BWD_MAPS`` order."""
        t = self.tiling
        out = [t.bq, t.bk, t.stages, self.smem, self.blocks, self.ld]
        for name in BWD_MAPS[self.kernel]:
            m = self.maps[name]
            out += [*m.dims, *m.strides, *m.box]
        return out


class BwdPlan(NamedTuple):
    route: str
    d: int
    ld: int  # row length of delta (and lse2): Sq, padded to LD_ROWS on the wgmma route
    kernels: dict | None = None  # "dq", "dkv" -> BwdKernelPlan (wgmma route)


def bwd_plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
             dq: torch.Tensor, dk: torch.Tensor, dv: torch.Tensor, seq_k: int,
             sms: int = H100_SMS) -> BwdPlan:
    """The launch of the backward on q, do, dq (B, H, Sq, d) and k, v, dk, dv
    (B, KV, Sk, d), keys past ``seq_k`` masked, on a card of ``sms``
    multiprocessors."""
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    r = route(q.dtype, d)
    if r != "wgmma":
        return BwdPlan(r, d, sq)
    ld = -(-sq // LD_ROWS) * LD_ROWS
    kernels = {}
    for kernel, units, rows in (("dq", b * h, sq), ("dkv", b * kv, sk)):
        t = BWD_TILING[kernel, d]
        maps = {"q": tensor_map(q, sq, t.bq), "do": tensor_map(do, sq, t.bq),
                "k": tensor_map(k, seq_k, t.bk), "v": tensor_map(v, seq_k, t.bk)}
        outs = {"dq": (dq,), "dkv": (dk, dv)}[kernel]
        for name, out in zip(BWD_MAPS[kernel][4:], outs):
            maps[name] = tensor_map(out, rows, OUT_BOX_ROWS)
        work = -(-rows // (t.bq if kernel == "dq" else t.bk)) * units
        kernels[kernel] = BwdKernelPlan(kernel, t, bwd_smem_bytes(kernel, d), min(sms, work),
                                        ld, maps)
    return BwdPlan(r, d, ld, kernels)
