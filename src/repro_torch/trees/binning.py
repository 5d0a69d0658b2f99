"""Feature quantization into histogram bins, dense or sparse.

Twin of ``repro.trees.binning``: features are quantized once per dataset
into at most ``n_bins`` integer bins, and split search runs over bin
boundaries. The sparse layout (``SparseBins``) stores only the cells that
differ from their feature's majority bin.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device


class SparseBins(NamedTuple):
    """A sparse quantized feature matrix: the explicit-zero-bin layout.

    Two padded layouts of the same stored entries (the cells that differ
    from their feature's majority bin):

      * row-major ELL ``indices``/``codes`` (N, E): per-sample stored
        columns (pad -1) and their codes; drives per-sample lookups
        (partition, tree routing);
      * feature-major ELL ``feat_rows``/``feat_codes`` (F, C): per-feature
        stored sample ids (pad -1) and codes; drives the sparse histogram.

    ``zero_bin`` (F,) is the bin an absent entry decodes to. Stored codes
    never equal their feature's zero bin, so dense <-> sparse round trips
    are exact.
    """

    indices: torch.Tensor  # (N, E) int32, -1 = pad
    codes: torch.Tensor  # (N, E) int32
    feat_rows: torch.Tensor  # (F, C) int32, -1 = pad
    feat_codes: torch.Tensor  # (F, C) int32
    zero_bin: torch.Tensor  # (F,) int32

    @property
    def shape(self) -> tuple[int, int]:
        """(N, F) of the equivalent dense matrix."""
        return (self.indices.shape[0], self.zero_bin.shape[0])

    @property
    def n_samples(self) -> int:
        return self.indices.shape[0]

    @property
    def n_features(self) -> int:
        return self.zero_bin.shape[0]

    @property
    def device(self) -> torch.device:
        return self.indices.device


class BinnedData(NamedTuple):
    """A quantized dataset.

    Attributes:
      bins: (N, F) int32 bin ids in [0, n_bins), or a ``SparseBins``
        holding the same matrix (``bins.shape`` and ``bins.device`` work on
        either).
      bin_edges: (F, n_bins - 1) float32 upper bin edges (last bin open).
      labels: (N,) float32.
      multiplicity: (N,) float32 — the paper's m_i.
      n_bins: static int.
      qid: (N,) int32 query ids for ranking objectives, else None; a
        ``_replace(bins=to_sparse(...))`` keeps it.
    """

    bins: torch.Tensor | SparseBins
    bin_edges: torch.Tensor
    labels: torch.Tensor
    multiplicity: torch.Tensor
    n_bins: int
    qid: torch.Tensor | None = None

    @property
    def n_samples(self) -> int:
        return self.bins.shape[0]

    @property
    def n_features(self) -> int:
        return self.bins.shape[1]


def make_bins(x: np.ndarray, n_bins: int = 256) -> np.ndarray:
    """Per-feature quantile bin edges, (F, n_bins - 1) float32. Host-side,
    once per dataset; degenerate features get repeated edges."""
    qs = np.linspace(0.0, 1.0, n_bins + 1)[1:-1]
    edges = np.quantile(x, qs, axis=0).T.astype(np.float32)  # (F, n_bins-1)
    return np.ascontiguousarray(edges)


def apply_bins(x: torch.Tensor, bin_edges: torch.Tensor, nan_bin: int = 0) -> torch.Tensor:
    """Map raw features (N, F) onto bin ids (N, F) int32 by a left-side
    batched ``searchsorted``.

    ``-inf`` lands in bin 0 and ``+inf`` in the last bin (they are below or
    above every edge); ``NaN`` routes to ``nan_bin`` so a malformed row
    never reads as a very large feature.
    """
    ids = torch.searchsorted(
        bin_edges.contiguous(), x.t().contiguous(), right=False, out_int32=True
    ).t()
    return torch.where(torch.isnan(x), torch.full_like(ids, nan_bin), ids).contiguous()


# Densities below this make the sparse layout the win (``bin_dataset``'s
# ``sparse="auto"``).
SPARSE_DENSITY_THRESHOLD = 0.25


def _zero_bins(b: np.ndarray) -> np.ndarray:
    """Per-feature majority bin: the sparse layout's implicit bin."""
    return np.stack(
        [np.bincount(b[:, f]).argmax() for f in range(b.shape[1])]
    ).astype(np.int32)


def sparse_density(bins: np.ndarray | torch.Tensor) -> float:
    """nnz / (N * F) under the per-feature majority-bin complement."""
    b = np.asarray(bins.cpu() if isinstance(bins, torch.Tensor) else bins)
    return float((b != _zero_bins(b)[None, :]).mean())


def _ell_pack(mask: np.ndarray, vals: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Pack ``vals[mask]`` row-major into (rows, max_row_nnz) ELL arrays:
    (indices int32 pad -1, values int32 pad 0)."""
    rows, _ = mask.shape
    nnz = mask.sum(1)
    width = max(int(nnz.max(initial=0)), 1)
    idx = np.full((rows, width), -1, np.int32)
    out = np.zeros((rows, width), np.int32)
    r, c = np.nonzero(mask)
    pos = np.arange(len(r)) - np.repeat(np.cumsum(nnz) - nnz, nnz)
    idx[r, pos] = c
    out[r, pos] = vals[r, c]
    return idx, out


def to_sparse(
    bins: np.ndarray | torch.Tensor, device: str | torch.device | None = None
) -> SparseBins:
    """Dense (N, F) bin matrix -> the explicit-zero-bin sparse layout on
    ``device`` (that of ``bins`` if it is a tensor, else the card).

    Host-side numpy, once per dataset; ``to_dense`` inverts it exactly.
    """
    if device is None and isinstance(bins, torch.Tensor):
        device = bins.device
    dev = resolve_device(device)
    b = np.asarray(bins.cpu() if isinstance(bins, torch.Tensor) else bins).astype(np.int32)
    zero = _zero_bins(b)
    mask = b != zero[None, :]
    indices, codes = _ell_pack(mask, b)
    feat_rows, feat_codes = _ell_pack(mask.T, b.T)
    return SparseBins(*(torch.as_tensor(a, device=dev) for a in
                        (indices, codes, feat_rows, feat_codes, zero)))


def to_dense(sp: SparseBins) -> torch.Tensor:
    """SparseBins -> the exact dense (N, F) int32 matrix (one stored entry
    per cell: an integer write, no rounding)."""
    n, f = sp.shape
    out = sp.zero_bin[None, :].expand(n, f).clone()
    valid = sp.indices >= 0
    rows = torch.arange(n, device=sp.device)[:, None].expand_as(sp.indices)
    out[rows[valid], sp.indices[valid].long()] = sp.codes[valid]
    return out


def gather_feature_bins(bins: torch.Tensor | SparseBins, feat: torch.Tensor) -> torch.Tensor:
    """Per-sample bin of a chosen feature, (N,) int32 from ``feat`` (N,).

    The layout-blind ``bins[i, feat[i]]``: a dense gather, or on the sparse
    layout a scan of the sample's row-ELL entries (E compares) that falls
    back to the feature's zero bin. Training's partition and the tree walk
    share it, so both route alike on either layout.
    """
    if not isinstance(bins, SparseBins):
        return bins.gather(1, feat.long()[:, None])[:, 0]
    hit = bins.indices == feat[:, None]  # pads are -1: never match feat >= 0
    stored = torch.where(hit, bins.codes, -1).amax(dim=1)
    return torch.where(stored >= 0, stored, bins.zero_bin[feat.long()])


def bin_dataset(
    x: np.ndarray,
    y: np.ndarray,
    n_bins: int = 256,
    multiplicity: np.ndarray | None = None,
    device: str | torch.device | None = None,
    sparse: bool | str = False,
    qid: np.ndarray | None = None,
) -> BinnedData:
    """One-shot dataset quantization onto ``device`` (the card by default).

    ``sparse``: ``True`` gives the ``SparseBins`` layout, ``"auto"`` gives
    it when the majority-bin complement density is under
    ``SPARSE_DENSITY_THRESHOLD``; the default stays dense. ``qid``: the
    per-sample query ids of a ranking set, stored as int32.
    """
    dev = resolve_device(device)
    edges = make_bins(x, n_bins)
    edges_t = torch.as_tensor(edges, device=dev)
    bins = apply_bins(torch.as_tensor(np.asarray(x, np.float32), device=dev), edges_t)
    if sparse == "auto":
        sparse = sparse_density(bins) < SPARSE_DENSITY_THRESHOLD
    if sparse:
        bins = to_sparse(bins)
    if multiplicity is None:
        multiplicity = np.ones(x.shape[0], np.float32)
    return BinnedData(
        bins=bins,
        bin_edges=edges_t,
        labels=torch.as_tensor(np.asarray(y, np.float32), device=dev),
        multiplicity=torch.as_tensor(np.asarray(multiplicity, np.float32), device=dev),
        n_bins=n_bins,
        qid=None if qid is None else torch.as_tensor(np.asarray(qid, np.int32), device=dev),
    )
