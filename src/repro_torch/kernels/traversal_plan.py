"""The launch plan of the forest-traversal kernels, in plain Python.

``csrc/forest_traversal.cu`` runs a traversal as three kernels a slab of
rows: a pre-pass narrows the slab's int32 bin rows to u8 (a cell outside
[0, 254] becomes the sentinel 255, which sends the walk to the int32 row),
the walk, and the slot-order sum. ``plan`` picks their shape from (N, F,
slots, depth, the packed types) and the SM count alone; the C entry point
checks it again (``check`` here is the same set of rules).

How the work is cut:

  * a walk block owns ``samples`` consecutive rows (a multiple of 32: a
    warp's lanes are 32 samples) and a group of ``group`` consecutive
    slots; its ``threads`` are ``samples`` x ``threads // samples`` tree
    lanes. It copies its rows' u8 bins (``row_bytes`` a row: F rounded up
    to an odd number of 4-byte words, so 32 rows that read one feature fall
    on 32 banks) into shared memory once, then stages its group ``chunk``
    trees at a time (each node packed into one word) and walks them there;
  * each walk writes its leaf, widened to f32, to a (slots, rows) scratch;
    the sum kernel then adds each (sample, column) chain in slot order,
    slot t into column t % K, so the tree split changes no bit;
  * rows are cut into slabs of ``slab`` rows so that the scratch stays
    under ``SCRATCH_CAP`` bytes.

Rows too wide for 32 of them to fit in shared memory (``row_bytes`` 0) are
read from device memory, trees too (through L1).

The sample tile follows one rule (measured at the realsim and multiclass
shapes, ``tools/traversal_variants.py``): the largest tile whose rows fit
beside a chunk of trees, or half of it where the half lets two blocks share
an SM and the whole does not; then the tree axis is split until the grid is
one wave of the blocks the SMs hold at once (shared memory, threads,
registers), every tree lane a tree.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

SMEM_LIMIT = 232448  # bytes of shared memory a block may use (H100)
SMEM_PER_SM = 233472  # bytes of shared memory an SM holds
SMEM_RESERVED = 1024  # bytes an SM keeps a resident block
THREADS_PER_SM = 2048
REGISTERS_PER_SM = 65536
REGISTERS = 64  # the most a walk thread holds where two 512-thread blocks share an SM
MAX_THREADS = 512  # the walk kernels' launch bound
SAMPLE_TILES = (32, 64, 128, 256, 512)
MIN_THREADS = 512
# Nodes and leaves a thread stages a chunk (``stage_of`` in the kernel), by
# the chunks in flight: one (two blocks an SM, 64 registers) or two.
STAGE = {1: 6, 2: 8}
MAX_CHUNK = 64  # trees a walk block stages at a time
SCRATCH_CAP = 64 << 20  # scratch bytes a slab may take
SCRATCH_ALIGN = 256
MAX_TILES = 65535  # grid.y
MAX_SLAB = 1 << 22  # rows a slab, so rows x K chains stay an int


class TraversalPlan(NamedTuple):
    samples: int  # rows a walk block owns (a multiple of 32)
    threads: int  # threads a walk block: samples x tree lanes
    group: int  # slots a walk block walks
    chunk: int  # trees a walk block stages at a time
    ahead: int  # chunks whose loads are in flight during a walk (2: one block an SM)
    slab: int  # rows a slab (a multiple of samples)
    row_bytes: int  # a staged u8 row's stride; 0: rows read from device memory
    scratch_bytes: int  # the narrowed rows and their flags, then the (slots, slab) leaves

    @property
    def staged(self) -> bool:
        return self.row_bytes > 0

    @property
    def lanes(self) -> int:
        """Tree lanes: the warps of one sample column that walk other slots."""
        return self.threads // self.samples

    def smem_bytes(self, depth: int, leaf_bytes: int) -> int:
        """The walk block's dynamic shared bytes."""
        return (staged_smem(self.samples, self.row_bytes, self.chunk, depth, leaf_bytes)
                if self.staged else 0)

    def grid(self, rows: int, slots: int) -> tuple[int, int]:
        """The walk's (groups, sample tiles) for a slab of ``rows`` rows."""
        return -(-slots // self.group), -(-rows // self.samples)


def row_bytes(n_feat: int) -> int:
    """A staged row's bytes: F rounded up to an odd number of words."""
    return 4 * (-(-n_feat // 4) | 1)


def _align16(b: int) -> int:
    return (b + 15) & ~15


def staged_smem(samples: int, rb: int, chunk: int, depth: int, leaf_bytes: int) -> int:
    """The rows, then ``chunk`` trees' packed nodes, then their leaves."""
    return (_align16(samples * rb) + _align16(chunk * ((1 << depth) - 1) * 4)
            + chunk * (1 << depth) * leaf_bytes)


def staged_row_bytes(n_feat: int) -> int:
    """A staged row's bytes, or 0 where 32 rows do not fit in shared memory
    beside a tree of the deepest depth (the walk then reads the int32 rows
    from device memory)."""
    rb = row_bytes(n_feat)
    fits = staged_smem(SAMPLE_TILES[0], rb, 1, 10, 4) <= SMEM_LIMIT
    return rb if fits else 0


def scratch_bytes(slab: int, slots: int, rb: int) -> int:
    """The narrowed rows of a slab and their sentinel flags (staged only),
    then its f32 leaves."""
    def align(b: int) -> int:
        return -(-b // SCRATCH_ALIGN) * SCRATCH_ALIGN
    return (align(slab * rb) + align(4 * slab) if rb else 0) + 4 * slots * slab


def blocks_per_sm(threads: int, smem: int) -> int:
    """Walk blocks an SM holds at once: by shared memory, threads and
    registers."""
    by_smem = SMEM_PER_SM // (smem + SMEM_RESERVED)
    by_regs = REGISTERS_PER_SM // (REGISTERS * threads)
    return max(1, min(by_smem, THREADS_PER_SM // threads, by_regs, 32))


def chunk_for(samples: int, threads: int, rb: int, depth: int, leaf_bytes: int,
              stage: int) -> int:
    """The most trees a walk block stages beside its rows: up to
    ``MAX_CHUNK``, and up to ``stage`` leaves a thread; within half an SM
    where that holds a tree a lane, else within a block's limit, a
    multiple of the lanes where it can be; 0 if not even one tree fits."""
    lanes = threads // samples
    cap = min(MAX_CHUNK, stage * threads >> depth)
    if not rb:
        return MAX_CHUNK
    half = SMEM_PER_SM // 2 - SMEM_RESERVED
    for budget, steps in ((half, (lanes,)), (SMEM_LIMIT, (lanes, 1))):
        most = 0
        while most < cap and staged_smem(samples, rb, most + 1, depth, leaf_bytes) <= budget:
            most += 1
        for step in steps:
            if most >= step:
                return most // step * step
    return 0


def shaped(n: int, n_feat: int, slots: int, depth: int, leaf_bytes: int, samples: int,
           threads: int, groups: int) -> TraversalPlan:
    """The plan of ``samples`` rows and ``threads`` threads a block, the
    slots cut into about ``groups`` groups of even chunks: its chunk, the
    chunks in flight, slab and scratch follow (chunk 0: the rows and one
    tree a lane do not fit). A block alone on its SM (by shared memory)
    keeps two chunks in flight, and stages more a thread."""
    rb = staged_row_bytes(n_feat)
    chunk = chunk_for(samples, threads, rb, depth, leaf_bytes, STAGE[1])
    alone = bool(rb) and chunk > 0 and blocks_per_sm(
        threads, staged_smem(samples, rb, chunk, depth, leaf_bytes)) == 1
    ahead = 2 if alone else 1
    if alone:
        chunk = chunk_for(samples, threads, rb, depth, leaf_bytes, STAGE[2])
    # Rows a slab: its narrowed rows, their flags and (slots, slab) leaves
    # under the cap.
    per_row = rb + (4 if rb else 0) + 4 * max(1, slots)
    slab_max = min(MAX_SLAB, max(SAMPLE_TILES[-1], SCRATCH_CAP // per_row))
    slab = min(-(-n // samples) * samples, slab_max // samples * samples, MAX_TILES * samples)
    group = max(1, -(-slots // max(1, groups)))
    if chunk:  # the group in chunks of even size
        chunk = -(-group // -(-group // chunk))
    return TraversalPlan(samples, threads, group, chunk, ahead, slab, rb,
                         scratch_bytes(slab, slots, rb))


@functools.lru_cache(maxsize=256)
def plan(n: int, n_feat: int, slots: int, depth: int, leaf_bytes: int,
         sms: int = 132) -> TraversalPlan:
    """The launch shape for N rows of F bins and a forest of ``slots``
    trees of ``depth`` whose leaves take ``leaf_bytes`` each."""
    if n < 1 or n_feat < 1 or slots < 0 or not 0 <= depth <= 10:
        raise ValueError(f"forest traversal: no plan for N={n}, F={n_feat}, T={slots}, "
                         f"depth={depth}")
    fits = []  # (sample tile, threads, blocks an SM), smallest tile first
    for s in SAMPLE_TILES:
        if s > SAMPLE_TILES[0] and s // 2 >= n:
            break
        for threads in dict.fromkeys((max(MIN_THREADS, s), s)):  # one warp a sample
            p = shaped(n, n_feat, slots, depth, leaf_bytes, s, threads, 1)  # column if need be
            if p.chunk:
                fits.append((s, threads, blocks_per_sm(threads, p.smem_bytes(depth,
                                                                             leaf_bytes))))
                break
    s, threads, per_sm = fits[-1]
    if per_sm == 1 and len(fits) > 1 and fits[-2][2] > 1:
        s, threads, per_sm = fits[-2]  # half the tile, two blocks an SM
    tiles = -(-min(n, shaped(n, n_feat, slots, depth, leaf_bytes, s, threads, 1).slab) // s)
    lanes = threads // s
    p = shaped(n, n_feat, slots, depth, leaf_bytes, s, threads,
               min(sms * per_sm // tiles, -(-slots // lanes)))
    check(p, n_feat, slots, depth, leaf_bytes)
    return p


def check(p: TraversalPlan, n_feat: int, slots: int, depth: int, leaf_bytes: int) -> None:
    """The rules the C entry point checks again before it launches."""
    ok = (p.samples >= 32 and p.samples % 32 == 0 and p.threads % p.samples == 0
          and 0 < p.threads <= MAX_THREADS and p.group >= 1 and p.chunk >= 1
          and p.ahead in (1, 2)
          and (p.row_bytes == 0 or p.chunk << depth <= STAGE.get(p.ahead, 0) * p.threads)
          and p.slab >= p.samples and p.slab % p.samples == 0
          and p.slab // p.samples <= MAX_TILES and p.slab <= MAX_SLAB
          and (p.row_bytes == 0 or (p.row_bytes >= n_feat and p.row_bytes % 4 == 0
                                    and p.smem_bytes(depth, leaf_bytes) <= SMEM_LIMIT))
          and p.scratch_bytes >= scratch_bytes(p.slab, slots, p.row_bytes))
    if not ok:
        raise ValueError(f"forest traversal: plan {p} breaks the kernel's rules at "
                         f"F={n_feat}, T={slots}, depth={depth}")
