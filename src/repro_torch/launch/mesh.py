"""The GBDT training mesh over ``torch.distributed`` (twin of the GBDT part
of ``repro.launch.mesh``).

A mesh is the grid of ranks the sharded build runs on: ``n_data`` rows of
samples by ``n_feature`` columns of features. Rank r sits at (r //
n_feature, r % n_feature), as ``jax.make_mesh((n_data, n_feature))`` lays
out devices. Each axis carries the ``torch.distributed`` subgroup of this
rank's row or column, its size and this rank's index on it
(``MeshAxis``); ``collectives`` reduces over those groups.

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
import os
import socket

import torch
import torch.distributed as dist

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class MeshAxis:
    """One axis of the mesh as this rank sees it."""

    name: str
    size: int
    index: int  # this rank's coordinate on the axis
    group: object | None  # the axis's process group; None on a dry mesh


@dataclasses.dataclass(frozen=True, eq=False)
class GbdtMesh:
    """The rank grid: its axes in order, the device and the backend."""

    axes: tuple[MeshAxis, ...]
    device: torch.device
    backend: str | None  # None on a dry mesh

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


def make_gbdt_mesh(
    n_data: int = 1,
    n_feature: int = 1,
    *,
    backend: str | None = None,
    device: str | torch.device | None = None,
    feature_axis: bool = True,
) -> GbdtMesh:
    """The block-distributed GBDT mesh: ``n_data`` sample shards by
    ``n_feature`` feature shards, axes ``("data", "feature")``.
    ``feature_axis=False`` (with ``n_feature`` 1) gives the 1-D
    ``("data",)`` mesh.

    The default process group must be initialised with ``n_data *
    n_feature`` ranks. Every rank makes the same meshes in the same order
    (each makes every subgroup, as ``new_group`` requires). The device is
    the card unless one is given.
    """
    if n_data < 1 or n_feature < 1:
        raise ValueError(f"mesh shape must be positive, got ({n_data}, {n_feature})")
    if not feature_axis and n_feature != 1:
        raise ValueError("a 1-D ('data',) mesh has no feature shards")
    if not dist.is_initialized():
        raise RuntimeError("make_gbdt_mesh: the default process group is not initialised "
                           "(start the ranks with launch.mesh.spawn or torchrun)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != n_data * n_feature:
        raise ValueError(f"a ({n_data}, {n_feature}) mesh needs {n_data * n_feature} "
                         f"ranks, the process group has {world}")
    dev = resolve_device(device)
    backend = backend or default_backend(dev)
    d, f = divmod(rank, n_feature)
    data_group = feature_group = None
    for col in range(n_feature):  # every rank makes every group, in one order
        g = dist.new_group([row * n_feature + col for row in range(n_data)], backend=backend)
        if col == f:
            data_group = g
    axes = [MeshAxis("data", n_data, d, data_group)]
    if feature_axis:
        for row in range(n_data):
            g = dist.new_group([row * n_feature + col for col in range(n_feature)],
                               backend=backend)
            if row == d:
                feature_group = g
        axes.append(MeshAxis("feature", n_feature, f, feature_group))
    return GbdtMesh(tuple(axes), dev, backend)


def make_host_mesh(*, backend: str | None = None,
                   device: str | torch.device | None = None) -> GbdtMesh:
    """The degenerate 1 x 1 mesh on a world of one rank."""
    return make_gbdt_mesh(1, 1, backend=backend, device=device)


def make_dry_mesh(shape: dict[str, int], device: str | torch.device = "cpu") -> GbdtMesh:
    """A mesh of the given ``{axis: size}`` without process groups, seen from
    the rank at the origin: its collectives only count bytes, inside
    ``collectives.dry`` (``ps.sharded.collective_bytes_per_build``)."""
    axes = tuple(MeshAxis(name, int(size), 0, None) for name, size in shape.items())
    return GbdtMesh(axes, torch.device(device), None)


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
