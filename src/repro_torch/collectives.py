"""Byte-counted collectives: psum / pmax / pmin, gather and reduce-scatter
with a recorder (twin of ``repro.collectives``), and the autograd pair of
the sharded LM step.

The GBDT build's collectives (the histogram merges over the ``'data'``
axis, the 2D mesh's split-decision merge over ``'feature'``, the
partition column's psum) all go through this module. Each wrapper runs
``torch.distributed.all_reduce`` (SUM, MAX or MIN) over the process group
of one mesh axis (a ``launch.mesh.MeshAxis``), and every active
``ByteRecorder`` records the call: its kind, axis, payload bytes, shapes
and the axis's size. The reference counts at trace time; the port counts
the payload it hands to the collective, so the sizes are the same.

The sharded LM step (``launch.steps``) adds:

* ``gather``: this rank's block of a tensor along one dim, assembled into
  the whole from the axis's ranks. Gloo gathers only CPU tensors, so a
  CUDA tensor over gloo (ranks that share a card) is gathered as the psum
  of a zero-filled whole with this rank's block written in, summed as
  bytes (``uint8``), which is exact: each byte has one non-zero addend;
* ``psum_scatter``: the reduce-scatter, a psum followed by
  ``sharding.rules.block``;
* ``psum`` over a tuple of axes: one all-reduce an axis, in order;
* ``copy_to`` and ``reduce_from``, Megatron's *f* and *g*:
  ``dist.all_reduce`` has no autograd, so *f* is the identity forward with
  a psum of its gradient, and *g* a psum forward passing its gradient
  through.

A ``tag`` names what a call carries (a parameter's path, "moe.out");
``ByteRecorder.by_tag`` sums the bytes by it.

Realized vs payload bytes: an all-reduce over a size-1 axis moves nothing
on the wire. ``payload_bytes`` counts every call, ``realized_bytes`` only
the calls whose axis spans more than one rank. Such a call is recorded and
returns its input, as a psum over a one-device axis is the identity in the
reference: no ``all_reduce`` is issued for it, and a one-rank axis needs
no process group (``launch.mesh.make_host_mesh``).

The dry form (``dry``) records and does not reduce: it serves
``ps.sharded.collective_bytes_per_build``, which runs one shard's build in
one process because the counts depend on shapes alone. A collective on an
axis of a dry mesh raises outside that block, whatever its size, so a
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
    kind: str  # 'psum' | 'pmax' | 'pmin' | 'gather' | 'psum_scatter'
    axis: str
    bytes: int
    shapes: tuple
    axis_size: int
    tag: str = ""  # what the call carries


@dataclass
class ByteRecorder:
    """Accumulates one ``CollectiveEvent`` per wrapped collective call."""

    events: list = field(default_factory=list)

    def add(self, kind: str, axis, x: torch.Tensor, tag: str = "") -> None:
        self.events.append(CollectiveEvent(
            kind=kind, axis=axis.name, bytes=x.numel() * x.element_size(),
            shapes=(tuple(x.shape),), axis_size=axis.size, tag=tag,
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

    def by_tag(self, axis: str | None = None) -> dict:
        """Realized bytes by (kind, tag), over one axis or all."""
        out: dict = {}
        for e in self.events:
            if e.axis_size != 1 and axis in (None, e.axis):
                out[(e.kind, e.tag)] = out.get((e.kind, e.tag), 0) + e.bytes
        return out


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


_OPS = {"psum": dist.ReduceOp.SUM, "pmax": dist.ReduceOp.MAX, "pmin": dist.ReduceOp.MIN,
        "psum_scatter": dist.ReduceOp.SUM}


def _passes(kind: str, axis, x: torch.Tensor, tag: str) -> bool:
    """Record the call; True where it is the identity (a one-rank axis, a
    dry axis inside ``dry``), and raise where it cannot run."""
    for rec in _ACTIVE:
        rec.add(kind, axis, x, tag)
    if axis.dry:
        if not getattr(_DRY, "on", False):
            raise RuntimeError(
                f"{kind} over axis {axis.name!r} of a dry mesh: a dry mesh only "
                "counts bytes (ps.sharded.collective_bytes_per_build)")
        return True
    if axis.size == 1:
        return True
    if axis.group is None:
        raise RuntimeError(f"{kind} over axis {axis.name!r}: {axis.size} ranks and no "
                           "process group")
    return False


def _reduce(kind: str, x: torch.Tensor, axis, tag: str = "") -> torch.Tensor:
    if _passes(kind, axis, x, tag):
        return x
    out = x.contiguous().clone()
    dist.all_reduce(out, op=_OPS[kind], group=axis.group)
    return out


def _axes(axis) -> tuple:
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def psum(x: torch.Tensor, axis, tag: str = "") -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis`` (a ``MeshAxis``), or over
    a tuple of axes: one all-reduce an axis, in order."""
    for a in _axes(axis):
        x = _reduce("psum", x, a, tag)
    return x


def pmax(x: torch.Tensor, axis) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the ranks of ``axis``."""
    return _reduce("pmax", x, axis)


def pmin(x: torch.Tensor, axis) -> torch.Tensor:
    """The elementwise minimum of ``x`` over the ranks of ``axis``."""
    return _reduce("pmin", x, axis)


def gather(x: torch.Tensor, axis, dim: int, tag: str = "",
           by_psum: bool | None = None) -> torch.Tensor:
    """The whole tensor of which ``x`` is this rank's block along ``dim``
    over ``axis`` (blocks in rank order, as ``torch.cat`` would join
    them). ``by_psum`` picks the form: an ``all_gather``, or the psum of a
    zero-filled whole with the block written in, summed as bytes; None
    takes the psum form for a CUDA tensor over gloo (gloo gathers only CPU
    tensors), else the ``all_gather``. Recorded as one "gather" of the
    whole's bytes."""
    from repro_torch.sharding.rules import block

    full = list(x.shape)
    full[dim] *= axis.size
    if _passes("gather", axis, x.new_empty(full, device="meta"), tag):
        return x
    if by_psum is None:
        by_psum = x.is_cuda and dist.get_backend(axis.group) == "gloo"
    if not by_psum:
        parts = [torch.empty_like(x) for _ in range(axis.size)]
        dist.all_gather(parts, x.contiguous(), group=axis.group)
        return torch.cat(parts, dim=dim)
    whole = x.new_zeros(full)
    block(whole, dim, axis).copy_(x)
    dist.all_reduce(whole.view(-1).view(torch.uint8), op=dist.ReduceOp.SUM, group=axis.group)
    return whole


def psum_scatter(x: torch.Tensor, axis, dim: int, tag: str = "") -> torch.Tensor:
    """The reduce-scatter: this rank's block along ``dim`` of the sum of
    ``x`` over ``axis``, a psum followed by ``rules.block``."""
    from repro_torch.sharding.rules import block

    return block(_reduce("psum_scatter", x, axis, tag), dim, axis)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, tag):
        ctx.axes, ctx.tag = axes, tag
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum(g, ctx.axes, ctx.tag + ".grad"), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, tag):
        return psum(x, axes, tag)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def copy_to(x: torch.Tensor, axes, tag: str = "") -> torch.Tensor:
    """Megatron's *f*: ``x`` forward; backward, its gradient summed over
    ``axes`` (a ``MeshAxis`` or a tuple). Put where a replicated tensor
    enters a computation each rank does only a part of."""
    return _CopyTo.apply(x, _axes(axes), tag)


def reduce_from(x: torch.Tensor, axes, tag: str = "") -> torch.Tensor:
    """Megatron's *g*: the psum of ``x`` over ``axes`` forward; backward,
    the gradient passed through unchanged to every rank's part."""
    return _ReduceFrom.apply(x, _axes(axes), tag)
