"""Parity of the port's binning and synthetic data with the JAX package.

Bin ids, edges, labels and multiplicities are integers or copies of the
same numpy floats, so every comparison here is bitwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import synthetic as jsyn
from repro.trees import binning as jbin
from repro_torch.data import synthetic as tsyn
from repro_torch.trees import binning as tbin


def _raw(seed, n=257, f=9):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, f)).astype(np.float32)
    x[:, 0] = np.round(x[:, 0])  # repeated values -> repeated edges
    x[:, 1] = 0.0  # a constant feature
    return x


@pytest.mark.parametrize("n_bins", [16, 64])
def test_make_bins_bitwise(n_bins):
    x = _raw(1)
    np.testing.assert_array_equal(tbin.make_bins(x, n_bins), jbin.make_bins(x, n_bins))


@pytest.mark.parametrize("n_bins", [16, 64])
def test_apply_bins_bitwise_with_nan_and_inf(n_bins):
    x = _raw(2)
    edges = jbin.make_bins(x, n_bins)
    q = _raw(3, n=40)
    q[3, 2] = np.nan
    q[5, :] = np.inf
    q[7, :] = -np.inf
    q[9, 4] = np.nan
    q[9, 5] = np.inf
    q[11, :] = edges[:, 5]  # exactly on an edge: left side
    want = np.asarray(jbin.apply_bins(jnp.asarray(q), jnp.asarray(edges)))
    got = tbin.apply_bins(torch.from_numpy(q), torch.from_numpy(edges))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[5] == n_bins - 1).all() and (got[7] == 0).all() and got[3, 2] == 0


def test_apply_bins_nan_bin():
    edges = jbin.make_bins(_raw(4), 16)
    q = np.full((2, 9), np.nan, np.float32)
    want = np.asarray(jbin.apply_bins(jnp.asarray(q), jnp.asarray(edges), nan_bin=7))
    got = tbin.apply_bins(torch.from_numpy(q), torch.from_numpy(edges), nan_bin=7)
    np.testing.assert_array_equal(got.numpy(), want)


def _same_binned(t, j):
    np.testing.assert_array_equal(t.bins.numpy(), np.asarray(j.bins))
    np.testing.assert_array_equal(t.bin_edges.numpy(), np.asarray(j.bin_edges))
    np.testing.assert_array_equal(t.labels.numpy(), np.asarray(j.labels))
    np.testing.assert_array_equal(t.multiplicity.numpy(), np.asarray(j.multiplicity))
    assert t.n_bins == j.n_bins


def test_bin_dataset_bitwise():
    x = _raw(5)
    y = (x[:, 2] > 0).astype(np.float32)
    m = np.arange(1, x.shape[0] + 1, dtype=np.float32)
    _same_binned(
        tbin.bin_dataset(x, y, n_bins=32, multiplicity=m, device="cpu"),
        jbin.bin_dataset(x, y, n_bins=32, multiplicity=m),
    )


@pytest.mark.parametrize("kind", ["sparse-cls", "dense-lowdiv", "sparse-reg"])
def test_synthetic_generators_bitwise(kind):
    """Same seed, same dataset: the generators are numpy copies."""
    if kind == "sparse-cls":
        t = tsyn.make_sparse_classification(300, 40, 6, seed=3, device="cpu")
        j = jsyn.make_sparse_classification(300, 40, 6, seed=3)
    elif kind == "dense-lowdiv":
        t = tsyn.make_dense_low_diversity(50, 12, 2_000, seed=5, device="cpu")
        j = jsyn.make_dense_low_diversity(50, 12, 2_000, seed=5)
    else:
        t = tsyn.make_sparse_regression(200, 30, 5, seed=13, device="cpu")
        j = jsyn.make_sparse_regression(200, 30, 5, seed=13)
    _same_binned(t, j)


def test_paper_dataset_specs_match():
    assert set(tsyn.PAPER_DATASETS) == set(jsyn.PAPER_DATASETS)
    for name, spec in tsyn.PAPER_DATASETS.items():
        ref = jsyn.PAPER_DATASETS[name]
        for field in ("name", "kind", "n", "dim", "nnz", "n_distinct", "loss", "seed"):
            assert getattr(spec, field) == getattr(ref, field)


def test_load_matches_reference_at_small_scale():
    spec = tsyn.DatasetSpec(name="tiny", kind="sparse-cls", n=120, dim=30, nnz=4, seed=7)
    jspec = jsyn.DatasetSpec(name="tiny", kind="sparse-cls", n=120, dim=30, nnz=4, seed=7)
    _same_binned(tsyn.load(spec, device="cpu"), jsyn.load(jspec))
