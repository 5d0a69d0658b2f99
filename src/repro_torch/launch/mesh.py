"""Meshes over ``torch.distributed`` (twin of ``repro.launch.mesh``): the
GBDT training mesh and the LM's (data, model) mesh.

A mesh is a grid of ranks. The GBDT mesh (``make_gbdt_mesh``) is
``n_data`` rows of samples by ``n_feature`` columns of features; the LM
mesh (``make_lm_mesh``) is ``n_data`` batch shards by ``n_model`` expert
(and tensor) shards. Rank r sits at (r // n_cols, r % n_cols), as
``jax.make_mesh`` lays out devices. Each axis carries the
``torch.distributed`` subgroup of this rank's row or column, its size and
this rank's index on it (``MeshAxis``); ``collectives`` reduces over those
groups. ``make_host_mesh`` is the reference's degenerate 1 x 1 LM mesh in
one process: its one-rank axes hold no process group, and a collective
over them is the identity.

Ranks are started by ``spawn`` (one command starts them all, through
``torch.multiprocessing``) or joined from the environment ``torchrun`` sets
(``init_from_env``). The backend is an explicit choice; its default follows
the device: ``"gloo"`` on the CPU, ``"nccl"`` on CUDA. NCCL refuses two
ranks on one card, so ranks that share a card run over ``"gloo"``, which
reduces CUDA tensors too.
"""
from __future__ import annotations

import dataclasses
import datetime
import itertools
import math
import os
import socket

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class MeshAxis:
    """One axis of the mesh as this rank sees it."""

    name: str
    size: int
    index: int  # this rank's coordinate on the axis
    group: object | None  # the axis's process group; None on a dry or one-rank axis
    dry: bool = False  # a dry mesh's axis: its collectives only count bytes


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """The rank grid: its axes in order, the device and the backend."""

    axes: tuple[MeshAxis, ...]
    device: torch.device
    backend: str | None  # None where no process group is held (dry, host)

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(a.name for a in self.axes)

    @property
    def shape(self) -> dict[str, int]:
        return {a.name: a.size for a in self.axes}

    def axis(self, name: str) -> MeshAxis:
        for a in self.axes:
            if a.name == name:
                return a
        raise KeyError(f"mesh has no axis {name!r} (axes {self.axis_names})")


def default_backend(device: torch.device) -> str:
    """The backend that follows the device: NCCL on CUDA, gloo on the CPU."""
    return "nccl" if device.type == "cuda" else "gloo"


def _make_grid(shape: tuple[tuple[str, int], ...], backend: str | None,
               device: str | torch.device | None) -> Mesh:
    """The mesh of ``shape`` ((axis, size) pairs, major first) over the
    default process group, which must hold every rank of the grid. Every
    rank makes every subgroup, in one order (``new_group`` requires it):
    axis by axis, one group for each coordinate of the other axes."""
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs ranks: the default process group is not initialised "
                           "(start the ranks with launch.mesh.spawn or torchrun)")
    sizes = [n for _, n in shape]
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != math.prod(sizes):
        raise ValueError(f"a {tuple(sizes)} mesh needs {math.prod(sizes)} "
                         f"ranks, the process group has {world}")
    dev = resolve_device(device)
    backend = backend or default_backend(dev)
    coords = [int(c) for c in np.unravel_index(rank, sizes)]
    axes = []
    for i, (name, size) in enumerate(shape):
        mine = None
        for rest in itertools.product(*(range(n) for j, n in enumerate(sizes) if j != i)):
            members = [int(np.ravel_multi_index(rest[:i] + (k,) + rest[i:], sizes))
                       for k in range(size)]
            g = dist.new_group(members, backend=backend)
            if list(rest) == coords[:i] + coords[i + 1:]:
                mine = g
        axes.append(MeshAxis(name, size, coords[i], mine))
    return Mesh(tuple(axes), dev, backend)


def make_gbdt_mesh(
    n_data: int = 1,
    n_feature: int = 1,
    *,
    backend: str | None = None,
    device: str | torch.device | None = None,
    feature_axis: bool = True,
) -> Mesh:
    """The block-distributed GBDT mesh: ``n_data`` sample shards by
    ``n_feature`` feature shards, axes ``("data", "feature")``.
    ``feature_axis=False`` (with ``n_feature`` 1) gives the 1-D
    ``("data",)`` mesh.

    The default process group must be initialised with ``n_data *
    n_feature`` ranks. Every rank makes the same meshes in the same order.
    The device is the card unless one is given.
    """
    if n_data < 1 or n_feature < 1:
        raise ValueError(f"mesh shape must be positive, got ({n_data}, {n_feature})")
    if not feature_axis and n_feature != 1:
        raise ValueError("a 1-D ('data',) mesh has no feature shards")
    shape = (("data", n_data), ("feature", n_feature)) if feature_axis else (("data", n_data),)
    return _make_grid(shape, backend, device)


def make_lm_mesh(n_data: int = 1, n_model: int = 1, *, backend: str | None = None,
                 device: str | torch.device | None = None) -> Mesh:
    """The LM's mesh: ``n_data`` batch (and FSDP) shards by ``n_model``
    expert shards, axes ``("data", "model")``, over a default process group
    of ``n_data * n_model`` ranks, made as ``make_gbdt_mesh`` makes its."""
    if n_data < 1 or n_model < 1:
        raise ValueError(f"mesh shape must be positive, got ({n_data}, {n_model})")
    return _make_grid((("data", n_data), ("model", n_model)), backend, device)


def make_host_mesh(*, device: str | torch.device | None = None) -> Mesh:
    """The reference's degenerate 1 x 1 ``("data", "model")`` mesh, in this
    process alone: no process group, no ``torch.distributed`` world; every
    collective over it returns its input. GBDT callers use
    ``make_gbdt_mesh(1, 1)``."""
    axes = (MeshAxis("data", 1, 0, None), MeshAxis("model", 1, 0, None))
    return Mesh(axes, resolve_device(device), None)


def make_dry_mesh(shape: dict[str, int], device: str | torch.device = "cpu") -> Mesh:
    """A mesh of the given ``{axis: size}`` without process groups, seen from
    the rank at the origin: its collectives only count bytes, inside
    ``collectives.dry`` (``ps.sharded.collective_bytes_per_build``)."""
    axes = tuple(MeshAxis(name, int(size), 0, None, dry=True) for name, size in shape.items())
    return Mesh(axes, torch.device(device), None)


def rank_device(rank: int, device: str | torch.device) -> torch.device:
    """The card of ``rank`` among the visible ones (ranks beyond the count
    share them round robin), or the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", rank % torch.cuda.device_count())


def free_port() -> int:
    """A free TCP port on localhost for the ranks' rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_ranks(rank: int, world: int, init_method: str, backend: str,
               device: torch.device) -> None:
    """Join the default process group as ``rank`` of ``world``."""
    if device.type == "cuda":
        torch.cuda.set_device(resolve_device(device))
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=600))


def _rank_main(rank, fn, world, init_method, backend, device, args):
    dev = rank_device(rank, device)
    init_ranks(rank, world, init_method, backend, dev)
    try:
        fn(rank, dev, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, args: tuple = (), *, backend: str | None = None,
          device: str | torch.device = "cuda") -> None:
    """Start ``world`` rank processes, each running ``fn(rank, device,
    *args)`` in an initialised process group (``tcp://localhost``, a free
    port), and wait for all. ``fn`` must be importable (a module-level
    function). A rank that fails fails the call."""
    import torch.multiprocessing as mp

    dev = torch.device(device)
    backend = backend or default_backend(dev)
    init_method = f"tcp://127.0.0.1:{free_port()}"
    mp.start_processes(_rank_main, args=(fn, world, init_method, backend, str(dev), args),
                       nprocs=world, join=True, start_method="spawn")


def init_from_env(device: str | torch.device, backend: str | None = None
                  ) -> tuple[int, int, torch.device]:
    """Join the process group ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``): (rank, world,
    device)."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = rank_device(int(os.environ.get("LOCAL_RANK", rank)), device)
    init_ranks(rank, world, "env://", backend or default_backend(dev), dev)
    return rank, world, dev
