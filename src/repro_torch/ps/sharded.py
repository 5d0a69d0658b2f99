"""Data-parallel and 2D (data x feature) sharded tree builds over
``torch.distributed`` (twin of ``repro.ps.sharded``).

The synchronous parameter-server build the paper sets asynch-SGBDT
against: every rank of the ``'data'`` axis histograms its own samples with
the same kernels, and one psum merges the level (the server's aggregation
as an all-reduce). Split search then runs on the merged histograms on
every rank, so every rank routes its samples through the same tree.

On the 2D mesh each rank histograms only its (N / P_d, F / P_f) block: the
psums over the data axis come first, then each node's split merges over
the feature axis with the (L,)-sized pmax / pmin (never a full histogram
psum), and the dense partition rebuilds the winning column with a
one-byte-a-sample psum (``trees.learner``).

Every rank holds the whole dataset, as the reference's global arrays are
whole outside ``shard_map``: a builder takes the whole (bins, g, h) and the
global feature mask, cuts the rank's block out (``sharding.shard_bins``) and
returns the tree, the same on every rank. The server state and the fold
stay replicated; only the build is sharded. Sample counts must divide the
data axis and feature counts the feature axis.
"""
from __future__ import annotations

import torch

from repro_torch import collectives
from repro_torch.kernels import ops
from repro_torch.launch.mesh import Mesh, make_dry_mesh
from repro_torch.sharding.rules import block, shard_bins
from repro_torch.trees.binning import SparseBins
from repro_torch.trees.learner import LearnerConfig, build_tree


def _shard_cache(cut):
    """``cut(bins)`` remembered for the last ``bins`` object: the dataset's
    block is cut once, not once a round."""
    last = [None, None]

    def get(bins):
        if last[0] is not bins:
            last[0], last[1] = bins, cut(bins)
        return last[1]

    return get


def make_sharded_builder(cfg: LearnerConfig, mesh: Mesh, axis_name: str = "data"):
    """A tree builder ``(bins, g, h, feat_mask) -> Tree`` running
    data-parallel over ``axis_name``: this rank builds on its samples, the
    histograms, smaller-child counts and leaf statistics psum across the
    axis, and the tree is the same on every rank. ``backend="fused"``
    builds staged (the fused level would decide on local histograms)."""
    axis = mesh.axis(axis_name)
    local_cfg = cfg._replace(axis_name=axis_name)
    local_bins = _shard_cache(lambda bins: shard_bins(bins, axis, None))

    def builder(bins, g, h, feat_mask):
        if isinstance(bins, SparseBins):
            raise ValueError(
                "SparseBins cannot shard over a 1D data axis (the "
                "feature-major store holds global sample ids); use "
                "make_sharded_builder_2d on a (1, P_f) mesh"
            )
        return build_tree(local_cfg, local_bins(bins), block(g, 0, axis).contiguous(),
                          block(h, 0, axis).contiguous(), feat_mask, mesh)

    return builder


def make_sharded_builder_2d(
    cfg: LearnerConfig,
    mesh: Mesh,
    data_axis: str = "data",
    feature_axis: str = "feature",
):
    """A tree builder on the block-distributed 2D mesh: rows over
    ``data_axis``, feature columns over ``feature_axis``.

    Dense bins shard on both dims. A ``SparseBins`` shards its
    feature-major store over ``feature_axis``; the row-major store and
    ``zero_bin`` stay whole (they route samples by global feature id, with
    no collective), and the data axis must have one shard (the
    feature-major entries hold global sample ids)."""
    d_axis, f_axis = mesh.axis(data_axis), mesh.axis(feature_axis)
    local_cfg = cfg._replace(axis_name=data_axis, feature_axis=feature_axis)
    local_bins = _shard_cache(lambda bins: shard_bins(bins, d_axis, f_axis))

    def builder(bins, g, h, feat_mask):
        return build_tree(local_cfg, local_bins(bins), block(g, 0, d_axis).contiguous(),
                          block(h, 0, d_axis).contiguous(), feat_mask, mesh)

    return builder


def _cpu_bins(bins):
    """A CPU stand-in of ``bins`` with its shapes: zeros for a dense matrix
    (or an (N, F) shape), the store itself for a ``SparseBins``."""
    if isinstance(bins, SparseBins):
        return SparseBins(*(t.cpu() for t in bins))
    shape = tuple(bins.shape) if isinstance(bins, torch.Tensor) else tuple(bins)
    return torch.zeros(shape, dtype=torch.int32)


def collective_bytes_per_build(
    cfg: LearnerConfig,
    mesh_or_shape,  # a Mesh, or its {axis: size} shape
    bins,  # (N, F) tensor or shape, or a SparseBins
    data_axis: str = "data",
    feature_axis: str | None = None,
) -> dict:
    """The collective bytes of one tree build on the mesh, as
    ``collectives.ByteRecorder.summary()`` gives them; ``realized_bytes``
    counts only collectives whose axis spans more than one rank.

    The counts depend on shapes alone (every level's sizes are fixed by
    the depth and the histogram mode), as the reference's ``eval_shape``
    count does. So this runs the build of the rank at the origin, in this
    process, on the CPU and on zero gradients, over a dry mesh of the same
    shape: its collectives are recorded and not reduced
    (``collectives.dry``). No kernel is launched and no rank is needed.
    """
    mesh = make_dry_mesh(dict(getattr(mesh_or_shape, "shape", mesh_or_shape)))
    if feature_axis is not None:
        builder = make_sharded_builder_2d(cfg, mesh, data_axis, feature_axis)
    else:
        builder = make_sharded_builder(cfg, mesh, data_axis)
    bins = _cpu_bins(bins)
    n, f = bins.shape
    zeros = torch.zeros(n, dtype=torch.float32)
    rec = collectives.ByteRecorder()
    with collectives.dry(), collectives.recording(rec):
        builder(bins, zeros, zeros, torch.ones(f, dtype=torch.bool))
    return rec.summary()


def build_histogram_sharded(
    mesh: Mesh,
    bins: torch.Tensor,
    node_ids: torch.Tensor,
    grad: torch.Tensor,
    hess: torch.Tensor,
    n_nodes: int,
    n_bins: int,
    axis_name: str = "data",
) -> torch.Tensor:
    """The (2, n_nodes, F, n_bins) histogram of the whole inputs: this
    rank's samples through the kernel, merged by a psum over ``axis_name``.
    Each cell is a sum over disjoint sample subsets, so it equals the
    one-device histogram up to f32 summation order."""
    axis = mesh.axis(axis_name)
    return ops.build_histogram(
        block(bins, 0, axis).contiguous(), block(node_ids, 0, axis).contiguous(),
        block(grad, 0, axis).contiguous(), block(hess, 0, axis).contiguous(),
        n_nodes, n_bins, axis=axis)
