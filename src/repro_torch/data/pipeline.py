"""Token data pipeline: deterministic, shardable, resumable batching (twin
of ``repro.data.pipeline``, a copy of its numpy code).

Documents of uneven length are PACKED into fixed (B, S) rows, each token
tagged with the id of its document in the row, so attention can be masked
to stay inside a document; every host draws a disjoint shard; and a
restart from step N reproduces batch N exactly:

  * ``pack_documents`` — greedy sequence packing with segment ids.
  * ``TokenPipeline``  — a seeded permutation of the rows each epoch
    (``np.random.default_rng((seed, epoch))``), host sharding
    (``shard_id``/``num_shards``) and O(1) random access (``batch_at``,
    ``iterate(start_step)``).

Batches are numpy arrays, bit for bit the reference's; ``torch.from_numpy``
and ``.to(device)`` carry them to the card. The paper's Bernoulli sampling
composes on top: ``launch.steps.make_train_step`` attaches per-sequence
weights, which ``forward_train`` consumes beside ``segments``.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


def pack_documents(
    docs: list[np.ndarray],
    seq_len: int,
    pad_id: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Greedy-pack variable-length docs into rows of ``seq_len`` tokens.

    Returns (tokens (N, S), segments (N, S)) int32: segment 0 = padding,
    k >= 1 = the k-th document piece in the row. A document that does not
    fit the rest of a row continues in the next one.
    """
    rows: list[np.ndarray] = []
    segs: list[np.ndarray] = []
    cur = np.full(seq_len, pad_id, np.int32)
    cseg = np.zeros(seq_len, np.int32)
    fill = 0
    seg_id = 0

    def flush():
        nonlocal cur, cseg, fill, seg_id
        if fill > 0:
            rows.append(cur)
            segs.append(cseg)
        cur = np.full(seq_len, pad_id, np.int32)
        cseg = np.zeros(seq_len, np.int32)
        fill = 0
        seg_id = 0

    for doc in docs:
        doc = np.asarray(doc, np.int32)
        while doc.size:
            space = seq_len - fill
            if space == 0:
                flush()
                space = seq_len
            take = min(space, doc.size)
            seg_id += 1
            cur[fill:fill + take] = doc[:take]
            cseg[fill:fill + take] = seg_id
            fill += take
            doc = doc[take:]
    flush()
    if not rows:
        return (np.zeros((0, seq_len), np.int32),) * 2
    return np.stack(rows), np.stack(segs)


@dataclasses.dataclass
class TokenPipeline:
    """Deterministic sharded batch stream over a packed token matrix.

    Every (epoch, step) pair maps to a fixed set of rows: the epoch order is
    a seeded permutation of this shard's rows, shards take strided slices
    (row r belongs to shard r % num_shards), and ``batch_at`` or
    ``iterate`` from any step reproduce the original stream. A batch is
    ``{"tokens", "labels"}`` (B, S) int32, the labels shifted by one, and
    ``"segments"`` (B, S) when the pipeline has them (a row's first S
    segment ids, those of its tokens).
    """

    tokens: np.ndarray  # (N, S+1) int32 — +1 for the shifted labels
    batch_size: int  # per-shard batch
    seed: int = 0
    shard_id: int = 0
    num_shards: int = 1
    segments: np.ndarray | None = None  # (N, S+1) from pack_documents

    def __post_init__(self):
        if self.tokens.ndim != 2:
            raise ValueError("tokens must be (N, S+1)")
        n = self.tokens.shape[0]
        self._shard_rows = np.arange(self.shard_id, n, self.num_shards)
        if len(self._shard_rows) < self.batch_size:
            raise ValueError("shard smaller than one batch")

    @property
    def steps_per_epoch(self) -> int:
        return len(self._shard_rows) // self.batch_size

    def _epoch_order(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, epoch))
        return rng.permutation(self._shard_rows)

    def batch_at(self, step: int) -> dict:
        """The batch for global step ``step`` (deterministic, random access)."""
        epoch, idx = divmod(step, self.steps_per_epoch)
        order = self._epoch_order(epoch)
        rows = order[idx * self.batch_size:(idx + 1) * self.batch_size]
        chunk = self.tokens[rows]
        out = {
            "tokens": chunk[:, :-1].astype(np.int32),
            "labels": chunk[:, 1:].astype(np.int32),
        }
        if self.segments is not None:
            out["segments"] = self.segments[rows][:, :-1]
        return out

    def __iter__(self) -> Iterator[dict]:
        return self.iterate(0)

    def iterate(self, start_step: int) -> Iterator[dict]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1
