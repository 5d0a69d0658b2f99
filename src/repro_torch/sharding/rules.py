"""Sharding rules of the GBDT dataset (twin of ``repro.sharding.rules``,
``gbdt_data_specs``).

The reference names a ``PartitionSpec`` per leaf and lets ``shard_map``
cut the blocks. Here every rank holds the whole dataset (the server state
and the fold stay replicated, as the reference's global arrays are) and
cuts its own block out: ``block`` takes this rank's contiguous 1/size of
one dim, as a ``PartitionSpec`` entry does. Shard s of an axis owns
elements ``[s * n / size, (s + 1) * n / size)``. ``shard_bins`` is the
bins' rule, which ``gbdt_data_specs`` and the sharded builders
(``ps.sharded``) share.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.trees.binning import BinnedData, SparseBins


def block(x: torch.Tensor, dim: int, axis) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` over ``axis`` (a
    ``MeshAxis``, or None for the whole). The dim must divide the axis."""
    if axis is None or axis.size == 1:
        return x
    n = x.shape[dim]
    if n % axis.size:
        raise ValueError(f"dim {dim} of size {n} does not divide the {axis.name!r} "
                         f"axis of {axis.size} shards (pad the dataset)")
    step = n // axis.size
    return x.narrow(dim, axis.index * step, step)


def _one_data_shard(axis) -> None:
    """A ``SparseBins`` keeps its sample dim whole: its feature-major
    entries hold global sample ids, so the data axis must have one shard."""
    if axis is not None and axis.size != 1:
        raise ValueError("sparse 2D builds need a (1, P_f) mesh: the feature-major "
                         f"store holds global sample ids, but {axis.name!r} has "
                         f"size {axis.size}")


def shard_bins(bins: torch.Tensor | SparseBins, data_axis, feature_axis):
    """This rank's block of a dataset's bins: dense (N, F) bins over
    ``data_axis`` (samples), then ``feature_axis`` (columns); a
    ``SparseBins`` shards only its feature-major store over
    ``feature_axis``, and ``indices``, ``codes`` and ``zero_bin`` stay whole
    (they route samples by global feature id). Either axis may be None.
    The blocks are contiguous."""
    if not isinstance(bins, SparseBins):
        return block(block(bins, 0, data_axis), 1, feature_axis).contiguous()
    _one_data_shard(data_axis)
    return bins._replace(feat_rows=block(bins.feat_rows, 0, feature_axis).contiguous(),
                         feat_codes=block(bins.feat_codes, 0, feature_axis).contiguous())


def gbdt_data_specs(mesh, sparse: bool = False) -> Callable[[BinnedData], BinnedData]:
    """The function that cuts this rank's shard of a ``BinnedData`` on the
    PS mesh (the reference's rules, ``rules.py:54-94``): samples over
    ``'data'``, feature columns and their bin edges over ``'feature'`` where
    the mesh has it, the bins by ``shard_bins``. ``sparse=True`` takes a
    ``SparseBins`` and needs one data shard. (The reference's
    ``shard_features`` shards features over a ``'model'`` axis, which a
    port mesh does not have.)
    """
    names = mesh.shape
    d = mesh.axis("data") if "data" in names else None
    m = mesh.axis("feature") if "feature" in names else None
    if sparse:
        _one_data_shard(d)

    def shard(data: BinnedData) -> BinnedData:
        if sparse != isinstance(data.bins, SparseBins):
            raise ValueError(f"gbdt_data_specs(sparse={sparse}) got "
                             f"{'dense bins' if sparse else 'a SparseBins'}")
        return data._replace(
            bins=shard_bins(data.bins, d, m),
            bin_edges=block(data.bin_edges, 0, m),
            labels=block(data.labels, 0, d),
            multiplicity=block(data.multiplicity, 0, d),
            qid=None if data.qid is None else block(data.qid, 0, d),
        )

    return shard
