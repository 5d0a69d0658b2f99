"""Sharding rules (twin of ``repro.sharding.rules``): the logical-axis rule
table of the LM zoo and the cut of a rank's shard of the GBDT dataset.

LM part. Every parameter is declared with logical axis names
(``models.transformer.param_schema``); ``spec_for`` maps them to mesh axes
by ``DEFAULT_RULES``: megatron-style tensor parallelism on 'model' (ff,
heads, vocab) with FSDP-style parameter sharding on 'data' (+ 'pod') along
the embed dimension. Assignment is greedy per tensor: for each dim, left
to right, every candidate mesh axis that is in the mesh with more than one
shard, is not used by an earlier dim of the same tensor, and divides what
is left of the dim, is taken. A ``PartitionSpec`` here is a tuple of
entries (an axis name, a tuple of names, or None), normalised as the
reference's is. These functions read only ``mesh.shape``, so a
``launch.mesh.make_dry_mesh`` stands in for a mesh of any size.

Placing tensors by the specs: ``named(mesh, spec)`` is the reference's
``NamedSharding``, a ``Placement`` whose ``shard`` cuts this rank's block
of a whole tensor along every dim the spec names (a tuple entry is taken
major first, as a ``PartitionSpec``'s is) and whose ``gather`` gives the
whole back (``collectives.gather``); ``tree_shardings`` maps ``named``
over a tree of specs (``sharding.policy``'s), and ``map_specs`` maps a
function over such a tree and the trees that match it. ``reshard`` moves a
tensor from one spec's block to another's, gathering only the axes the
first has and the second lacks on a dim.

GBDT part. The reference names a ``PartitionSpec`` per leaf and lets
``shard_map`` cut the blocks. Here every rank holds the whole dataset (the
server state and the fold stay replicated, as the reference's global
arrays are) and cuts its own block out: ``block`` takes this rank's
contiguous 1/size of one dim, as a ``PartitionSpec`` entry does. Shard s
of an axis owns elements ``[s * n / size, (s + 1) * n / size)``.
``shard_bins`` is the bins' rule, which ``gbdt_data_specs`` and the
sharded builders (``ps.sharded``) share.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Sequence

import torch

from repro_torch import collectives
from repro_torch.trees.binning import BinnedData, SparseBins

# Logical axis -> mesh-axis candidates, in order (the reference's table).
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    # --- parameters ---
    "vocab": ("model",),
    "ff": ("model",),
    "q_flat": ("model",),
    "kv_flat": ("model",),
    "experts": ("model",),
    "gates": ("model",),  # slstm 4d gate stack
    "inner": ("model",),  # mamba d_inner
    "inner_proj": ("model",),  # mamba fused in_proj output
    "conv_ch": ("model",),
    "head_dim": ("model",),  # only reached when heads were unshardable
    "embed": ("data", "pod"),  # FSDP / ZeRO-3 axis for weights
    "layers": (),  # the layer-stack axis, never sharded
    # --- activations / caches ---
    "batch": ("pod", "data"),
    "seq": ("model",),  # long-context fallback: shard positions
    "kv_heads": ("model",),
    "heads": ("model",),
    "capacity": ("model", "data"),  # decode cache ring slots
    "media": (),
    # --- GBDT parameter-server engine ---
    "samples": ("data",),  # binned rows / labels / targets / weights
    "features": ("feature", "model"),  # feature columns of the binned matrix
}


class PartitionSpec(tuple):
    """A tuple of per-dim entries: a mesh-axis name, a tuple of names, or
    None (not sharded). Entries are normalised as the reference's are (an
    empty tuple is None, a tuple of one name is the name) and trailing
    Nones are stripped, so specs that shard alike compare equal."""

    def __new__(cls, *parts):
        norm = [None if p == () else p[0] if isinstance(p, tuple) and len(p) == 1 else p
                for p in parts]
        while norm and norm[-1] is None:
            norm.pop()
        return super().__new__(cls, norm)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


def serving_rules() -> dict[str, tuple[str, ...]]:
    """Serving-time placement: pure tensor parallelism, parameters
    replicated over 'data'/'pod' (decode amortizes no per-step parameter
    all-gather), and the FFN's contraction dim sharded over model x data so
    large parameters still fit without the FSDP axis."""
    rules = dict(DEFAULT_RULES)
    rules["embed"] = ()
    rules["ff"] = ("model", "data")
    return rules


def spec_for(
    shape: Sequence[int],
    axes: Sequence[str | None],
    mesh,
    rules: Mapping[str, tuple[str, ...]] | None = None,
    min_ndim: int = 2,
) -> PartitionSpec:
    """The spec of one tensor under the rule table (see the module's
    docstring); tensors of fewer than ``min_ndim`` dims are replicated."""
    rules = DEFAULT_RULES if rules is None else rules
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} vs axes {axes}")
    if len(shape) < min_ndim:
        return P()
    sizes = dict(mesh.shape)
    used: set[str] = set()
    parts: list = []
    for dim, name in zip(shape, axes):
        got: list[str] = []
        rem = int(dim)
        for cand in rules.get(name, ()) if name else ():
            size = sizes.get(cand, 0)
            if size <= 1 or cand in used or rem % size != 0:
                continue
            got.append(cand)
            used.add(cand)
            rem //= size
        parts.append(tuple(got))
    return P(*parts)


def entry_axes(spec: PartitionSpec, dim: int) -> tuple[str, ...]:
    """The mesh axes of ``spec``'s entry for ``dim``, major first (none past
    its end)."""
    e = spec[dim] if dim < len(spec) else None
    return () if e is None else (e,) if isinstance(e, str) else tuple(e)


def reshard(x: torch.Tensor, mesh, have: PartitionSpec, want: PartitionSpec,
            tag: str = "") -> torch.Tensor:
    """``x``, this rank's block under spec ``have``, as its block under
    ``want``: on each dim the axes both entries start with stay as they
    are; the rest of ``have``'s are gathered (minor first) and then
    ``want``'s cut (major first). No collective runs where ``want`` only
    adds axes."""
    for dim in range(x.dim()):
        h, w = entry_axes(have, dim), entry_axes(want, dim)
        keep = 0
        while keep < min(len(h), len(w)) and h[keep] == w[keep]:
            keep += 1
        for a in reversed(h[keep:]):
            x = collectives.gather(x, mesh.axis(a), dim, tag)
        for a in w[keep:]:
            x = block(x, dim, mesh.axis(a))
    return x


@dataclasses.dataclass(frozen=True, eq=False)
class Placement:
    """A tensor's placement on a mesh (the reference's ``NamedSharding``)."""

    mesh: Any
    spec: PartitionSpec

    def shard(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``full``, a tensor of its own."""
        return reshard(full, self.mesh, P(), self.spec).clone()

    def gather(self, local: torch.Tensor, tag: str = "") -> torch.Tensor:
        """The whole tensor of which ``local`` is this rank's block."""
        return reshard(local, self.mesh, self.spec, P(), tag)


def named(mesh, spec: PartitionSpec) -> Placement:
    return Placement(mesh, P(*spec))


def map_specs(fn: Callable, specs, *trees):
    """``fn(spec, *leaves)`` over the leaves of ``specs`` (``PartitionSpec``
    or ``Placement`` records) and the matching leaves of ``trees`` (nested
    dicts, named tuples and plain tuples or lists, as ``sharding.policy``
    builds them), rebuilding ``specs``'s structure. Any other node is a
    leaf: a ``PartitionSpec`` is told by not being a plain tuple, not by
    its class, which a reload of this module would replace."""
    if isinstance(specs, dict):
        return {k: map_specs(fn, v, *(t[k] for t in trees)) for k, v in specs.items()}
    if hasattr(specs, "_fields"):
        return type(specs)(*(map_specs(fn, v, *(t[i] for t in trees))
                             for i, v in enumerate(specs)))
    if type(specs) in (tuple, list):
        return type(specs)(map_specs(fn, v, *(t[i] for t in trees))
                           for i, v in enumerate(specs))
    return fn(specs, *trees)


def tree_shardings(mesh, specs):
    """``named`` over a tree of specs."""
    return map_specs(lambda s: named(mesh, s), specs)


def batch_axes(mesh) -> tuple[str, ...]:
    """The mesh axes that carry the global batch ('pod' first when present)."""
    names = dict(mesh.shape)
    return tuple(a for a in ("pod", "data") if names.get(a, 1) > 1)


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
