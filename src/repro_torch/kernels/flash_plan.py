"""The flash-attention forward's launch plan, in plain Python.

The wrapper (``kernels/flash_attention.py``) and ``chip_smoke.py`` both take
the forward's launch from ``plan`` here, and the C entry point of
``csrc/flash_attention.cu`` checks what it is given against the shapes.

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
