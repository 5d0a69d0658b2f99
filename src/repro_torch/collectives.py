"""Byte-counted collectives: psum / pmax / pmin with a recorder (twin of
``repro.collectives``).

The GBDT build's collectives (the histogram merges over the ``'data'``
axis, the 2D mesh's split-decision merge over ``'feature'``, the
partition column's psum) all go through this module. Each wrapper runs
``torch.distributed.all_reduce`` (SUM, MAX or MIN) over the process group
of one mesh axis (a ``launch.mesh.MeshAxis``), and every active
``ByteRecorder`` records the call: its kind, axis, payload bytes, shapes
and the axis's size. The reference counts at trace time; the port counts
the payload it hands to the collective, so the sizes are the same.

Realized vs payload bytes: an all-reduce over a size-1 axis moves nothing
on the wire. ``payload_bytes`` counts every call, ``realized_bytes`` only
the calls whose axis spans more than one rank. Such a call is recorded and
returns its input, as a psum over a one-device axis is the identity in the
reference: no ``all_reduce`` is issued for it.

The dry form (``dry``) records and does not reduce: it serves
``ps.sharded.collective_bytes_per_build``, which runs one shard's build in
one process because the counts depend on shapes alone. A collective on an
axis without a process group (a dry mesh) raises outside that block, so a
training path can never reach it.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field

import torch
import torch.distributed as dist


@dataclass
class CollectiveEvent:
    kind: str  # 'psum' | 'pmax' | 'pmin'
    axis: str
    bytes: int
    shapes: tuple
    axis_size: int


@dataclass
class ByteRecorder:
    """Accumulates one ``CollectiveEvent`` per wrapped collective call."""

    events: list = field(default_factory=list)

    def add(self, kind: str, axis, x: torch.Tensor) -> None:
        self.events.append(CollectiveEvent(
            kind=kind, axis=axis.name, bytes=x.numel() * x.element_size(),
            shapes=(tuple(x.shape),), axis_size=axis.size,
        ))

    def payload_bytes(self) -> int:
        return sum(e.bytes for e in self.events)

    def realized_bytes(self) -> int:
        """Bytes of collectives whose axis spans more than one rank."""
        return sum(e.bytes for e in self.events if e.axis_size != 1)

    def summary(self) -> dict:
        by_kind: dict[str, int] = {}
        by_axis: dict[str, int] = {}
        for e in self.events:
            if e.axis_size == 1:
                continue
            by_kind[e.kind] = by_kind.get(e.kind, 0) + e.bytes
            by_axis[e.axis] = by_axis.get(e.axis, 0) + e.bytes
        return {
            "n_collectives": len(self.events),
            "payload_bytes": self.payload_bytes(),
            "realized_bytes": self.realized_bytes(),
            "realized_by_kind": by_kind,
            "realized_by_axis": by_axis,
        }


_ACTIVE: list[ByteRecorder] = []
_DRY = threading.local()


@contextlib.contextmanager
def recording(recorder: ByteRecorder):
    """Route every wrapped collective called inside the block into
    ``recorder``. Nestable; every active recorder sees every event."""
    _ACTIVE.append(recorder)
    try:
        yield recorder
    finally:
        _ACTIVE.remove(recorder)


@contextlib.contextmanager
def dry():
    """Inside the block, collectives on a dry axis (no process group) are
    recorded and return their input unreduced. For the byte count alone
    (``ps.sharded.collective_bytes_per_build``)."""
    before = getattr(_DRY, "on", False)
    _DRY.on = True
    try:
        yield
    finally:
        _DRY.on = before


_OPS = {"psum": dist.ReduceOp.SUM, "pmax": dist.ReduceOp.MAX, "pmin": dist.ReduceOp.MIN}


def _reduce(kind: str, x: torch.Tensor, axis) -> torch.Tensor:
    for rec in _ACTIVE:
        rec.add(kind, axis, x)
    if axis.group is None and not getattr(_DRY, "on", False):
        raise RuntimeError(
            f"{kind} over axis {axis.name!r} of a dry mesh: a dry mesh only "
            "counts bytes (ps.sharded.collective_bytes_per_build)")
    if axis.size == 1 or axis.group is None:
        return x
    out = x.contiguous().clone()
    dist.all_reduce(out, op=_OPS[kind], group=axis.group)
    return out


def psum(x: torch.Tensor, axis) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis`` (a ``MeshAxis``)."""
    return _reduce("psum", x, axis)


def pmax(x: torch.Tensor, axis) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the ranks of ``axis``."""
    return _reduce("pmax", x, axis)


def pmin(x: torch.Tensor, axis) -> torch.Tensor:
    """The elementwise minimum of ``x`` over the ranks of ``axis``."""
    return _reduce("pmin", x, axis)
