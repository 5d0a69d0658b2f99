"""Synthetic datasets matched to the properties the paper's theory names.

Twin of ``repro.data.synthetic``: the same numpy generators, so the same
seed gives the same raw x and y as the reference. ``raw`` exposes the
unbinned floats (serving requests are raw rows); ``load`` bins them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.trees.binning import BinnedData, bin_dataset


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    kind: str  # 'sparse-cls' | 'dense-lowdiv' | 'sparse-reg'
    n: int  # number of distinct samples
    dim: int
    nnz: int  # nonzeros per sample (sparse kinds)
    n_distinct: int = 0  # dense-lowdiv: pool of distinct samples
    loss: str = "logistic"
    seed: int = 0


def sparse_classification_xy(
    n: int, dim: int, nnz: int, seed: int = 0, label_noise: float = 0.05
) -> tuple[np.ndarray, np.ndarray]:
    """High-dim sparse binary classification; all samples distinct."""
    rng = np.random.default_rng(seed)
    x = np.zeros((n, dim), np.float32)
    rows = np.repeat(np.arange(n), nnz)
    cols = rng.integers(0, dim, size=n * nnz)
    vals = rng.lognormal(0.0, 1.0, size=n * nnz).astype(np.float32)
    x[rows, cols] = vals
    w = (rng.standard_normal(dim) * (rng.random(dim) < 0.2)).astype(np.float32)
    logits = x @ w + 0.1 * rng.standard_normal(n).astype(np.float32)
    y = (logits > np.median(logits)).astype(np.float32)
    flip = rng.random(n) < label_noise
    y = np.where(flip, 1.0 - y, y)
    return x, y


def dense_low_diversity_xym(
    n_distinct: int, dim: int, total_mass: int, seed: int = 0
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Low-dim dense rows with a Zipf-ish multiplicity profile summing to
    ``total_mass`` (low diversity, Fig. 4a)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n_distinct, dim)).astype(np.float32)
    w = rng.standard_normal(dim).astype(np.float32)
    y = (x @ w > 0).astype(np.float32)
    raw = 1.0 / np.arange(1, n_distinct + 1)
    m = np.maximum(1, np.round(raw / raw.sum() * total_mass)).astype(np.float32)
    return x, y, m


def sparse_regression_xy(
    n: int, dim: int, nnz: int, seed: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """Sparse high-dim regression (E2006-log1p-like)."""
    rng = np.random.default_rng(seed)
    x = np.zeros((n, dim), np.float32)
    rows = np.repeat(np.arange(n), nnz)
    cols = rng.integers(0, dim, size=n * nnz)
    x[rows, cols] = rng.lognormal(0.0, 1.0, size=n * nnz).astype(np.float32)
    w = (rng.standard_normal(dim) * (rng.random(dim) < 0.1)).astype(np.float32)
    y = (x @ w + 0.05 * rng.standard_normal(n)).astype(np.float32)
    y = (y - y.mean()) / (y.std() + 1e-8)
    return x, y


def make_sparse_classification(
    n: int, dim: int, nnz: int, seed: int = 0, label_noise: float = 0.05,
    device: str | torch.device | None = None, sparse: bool | str = False,
) -> BinnedData:
    """``sparse`` passes through to ``bin_dataset``: ``True``/``"auto"``
    give the ``SparseBins`` layout."""
    x, y = sparse_classification_xy(n, dim, nnz, seed, label_noise)
    return bin_dataset(x, y, n_bins=64, device=device, sparse=sparse)


def make_dense_low_diversity(
    n_distinct: int, dim: int, total_mass: int, seed: int = 0,
    device: str | torch.device | None = None,
) -> BinnedData:
    x, y, m = dense_low_diversity_xym(n_distinct, dim, total_mass, seed)
    return bin_dataset(x, y, n_bins=64, multiplicity=m, device=device)


def make_sparse_regression(
    n: int, dim: int, nnz: int, seed: int = 0,
    device: str | torch.device | None = None,
) -> BinnedData:
    x, y = sparse_regression_xy(n, dim, nnz, seed)
    return bin_dataset(x, y, n_bins=64, device=device)


# Scaled-down stand-ins for the paper's three datasets (same property axes).
PAPER_DATASETS: dict[str, DatasetSpec] = {
    "realsim-like": DatasetSpec(
        name="realsim-like", kind="sparse-cls", n=4000, dim=1500, nnz=25, seed=7
    ),
    "higgs-like": DatasetSpec(
        name="higgs-like", kind="dense-lowdiv", n=60000, dim=28, nnz=28,
        n_distinct=300, seed=11,
    ),
    "e2006-like": DatasetSpec(
        name="e2006-like", kind="sparse-reg", n=3000, dim=2000, nnz=40,
        loss="mse", seed=13,
    ),
}


def raw(spec: DatasetSpec) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The spec's unbinned (x, y, multiplicity) as numpy arrays."""
    if spec.kind == "sparse-cls":
        x, y = sparse_classification_xy(spec.n, spec.dim, spec.nnz, spec.seed)
        return x, y, np.ones(x.shape[0], np.float32)
    if spec.kind == "dense-lowdiv":
        return dense_low_diversity_xym(spec.n_distinct, spec.dim, spec.n, spec.seed)
    if spec.kind == "sparse-reg":
        x, y = sparse_regression_xy(spec.n, spec.dim, spec.nnz, spec.seed)
        return x, y, np.ones(x.shape[0], np.float32)
    raise ValueError(spec.kind)


def load(spec: DatasetSpec, device: str | torch.device | None = None) -> BinnedData:
    x, y, m = raw(spec)
    return bin_dataset(x, y, n_bins=64, multiplicity=m, device=device)
