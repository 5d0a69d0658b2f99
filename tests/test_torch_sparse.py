"""The port's sparse binned-data layer against the JAX package.

Contracts:
  * ``to_sparse`` gives the JAX package's five arrays exactly, and
    ``to_dense(to_sparse(b)) == b``; ``gather_feature_bins`` is exact on
    either layout; ``convert.sparse_from_numpy`` carries the JAX package's
    fields over unchanged;
  * ``ops.build_histogram_sparse`` (the stored-entry sum plus the zero-bin
    complement) meets the JAX oracles ``ref.histogram_sparse_ref`` /
    ``histogram_sparse_subset_ref`` within rtol 1e-5, atol 1e-4 x max|cell|
    (the complement subtracts in another order than the dense sum);
  * the stored-entry plain version (the CUDA kernel's, on the CPU) meets
    the JAX package's ``histogram_sparse_pallas`` in interpret mode on a
    full level (its subset form is held against the oracle only: the JAX
    package's own subset test is red, ROADMAP "Reference caveats");
  * a sparse tree build meets the port's dense build and the JAX
    package's sparse build under the cross-backend contract (bitwise heap
    prefix, >= 97% of nodes identical, <= 1% RMS prediction drift), and
    routes samples exactly as the dense layout does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import synthetic as jsyn
from repro.kernels import ref as jref
from repro.kernels.histogram_sparse import histogram_sparse_pallas
from repro.trees import binning as jbinning
from repro.trees.learner import LearnerConfig as JLearnerConfig
from repro.trees.learner import build_tree as jbuild_tree
from repro.trees.tree import apply_tree as japply_tree
from repro_torch.convert import sparse_from_numpy
from repro_torch.core.sgbdt import SGBDTConfig
from repro_torch.data import synthetic
from repro_torch.kernels import histogram_sparse, ops
from repro_torch.kernels import ref as oracle
from repro_torch.ps.engine import Trainer
from repro_torch.trees import binning
from repro_torch.trees.learner import LearnerConfig, build_tree
from repro_torch.trees.tree import apply_tree, leaf_indices

N, DIM, NNZ, SEED, B = 256, 24, 4, 11, 64


@pytest.fixture(scope="module")
def pair():
    """The port's sparse dataset and the JAX package's, from one seed."""
    port = synthetic.make_sparse_classification(N, DIM, NNZ, seed=SEED, device="cpu",
                                                sparse=True)
    ref = jsyn.make_sparse_classification(N, DIM, NNZ, seed=SEED, sparse=True)
    return port, ref


def _gh(n, seed):
    rng = np.random.default_rng(seed)
    h = (1.25 * rng.binomial(1, 0.8, n)).astype(np.float32)
    return (h * rng.standard_normal(n)).astype(np.float32), h


def _close(got, want, what):
    want = np.asarray(want)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4 * scale, err_msg=what)


FIELDS = ("indices", "codes", "feat_rows", "feat_codes", "zero_bin")


def test_to_sparse_matches_jax_in_all_five_arrays(pair):
    port, ref = pair
    assert isinstance(port.bins, binning.SparseBins)
    for name in FIELDS:
        got = getattr(port.bins, name)
        assert got.dtype == torch.int32, name
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(ref.bins, name)),
                                      err_msg=name)


def test_round_trip_and_properties(pair):
    port, ref = pair
    sp = port.bins
    dense = binning.to_dense(sp)
    np.testing.assert_array_equal(dense.numpy(), np.asarray(jbinning.to_dense(ref.bins)))
    again = binning.to_sparse(dense)
    for name in FIELDS:
        assert torch.equal(getattr(again, name), getattr(sp, name))
    assert sp.shape == tuple(dense.shape) == (N, DIM)
    assert (sp.n_samples, sp.n_features, sp.device) == (N, DIM, torch.device("cpu"))
    assert port.n_samples == N and port.n_features == DIM
    valid = sp.indices >= 0  # stored codes never equal their zero bin
    assert bool((sp.codes[valid] != sp.zero_bin[sp.indices[valid].long()]).all())


def test_sparse_from_numpy_round_trips(pair):
    _, ref = pair
    sp = sparse_from_numpy(*(np.asarray(getattr(ref.bins, k)) for k in FIELDS), device="cpu")
    np.testing.assert_array_equal(binning.to_dense(sp).numpy(),
                                  np.asarray(jbinning.to_dense(ref.bins)))


def test_gather_feature_bins_is_exact_on_both_layouts(pair):
    port, ref = pair
    feat = np.random.default_rng(4).integers(0, DIM, N).astype(np.int32)
    want = np.asarray(jbinning.gather_feature_bins(ref.bins, jnp.asarray(feat)))
    for bins in (port.bins, binning.to_dense(port.bins)):
        got = binning.gather_feature_bins(bins, torch.from_numpy(feat))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_bin_dataset_auto_picks_by_density():
    rng = np.random.default_rng(0)
    x_sparse = np.where(rng.random((128, 32)) < 0.05, 1.0, 0.0).astype(np.float32)
    y = np.zeros(128, np.float32)
    got = binning.bin_dataset(x_sparse, y, sparse="auto", device="cpu")
    assert isinstance(got.bins, binning.SparseBins)
    assert binning.sparse_density(binning.to_dense(got.bins)) < 0.25
    x_dense = rng.standard_normal((128, 8)).astype(np.float32)
    assert not isinstance(binning.bin_dataset(x_dense, y, sparse="auto", device="cpu").bins,
                          binning.SparseBins)
    assert not isinstance(binning.bin_dataset(x_sparse, y, device="cpu").bins,
                          binning.SparseBins)


@pytest.mark.parametrize("subset", [False, True])
def test_sparse_histogram_matches_jax_oracle(pair, subset):
    port, ref = pair
    g, h = _gh(N, 1 + subset)
    node = np.random.default_rng(8).integers(-1, 4, N).astype(np.int32)
    tn, tg, th = (torch.from_numpy(a) for a in (node, g, h))
    jn, jg, jh = (jnp.asarray(a) for a in (node, g, h))
    if subset:
        active = np.asarray([3, 1], np.int32)
        got = ops.build_histogram_subset(port.bins, tn, tg, th, torch.from_numpy(active),
                                         4, B)
        want = jref.histogram_sparse_subset_ref(ref.bins, jn, jg, jh, jnp.asarray(active),
                                                4, B)
    else:
        got = ops.build_histogram(port.bins, tn, tg, th, 4, B)
        want = jref.histogram_sparse_ref(ref.bins, jn, jg, jh, 4, B)
    assert got.shape == want.shape
    _close(got.numpy(), want, "sparse histogram")
    # The port's own oracle (densify, then the dense scatter) agrees too.
    if subset:
        mine = oracle.histogram_sparse_subset_ref(port.bins, tn, tg, th,
                                                  torch.from_numpy(active), 4, B)
    else:
        mine = oracle.histogram_sparse_ref(port.bins, tn, tg, th, 4, B)
    _close(got.numpy(), mine.numpy(), "port oracle")
    _close(mine.numpy(), want, "port oracle vs jax oracle")


def test_stored_entry_plain_matches_jax_pallas(pair):
    port, ref = pair
    g, h = _gh(N, 3)
    node = np.random.default_rng(9).integers(-1, 4, N).astype(np.int32)
    sp = port.bins
    got = histogram_sparse.histogram_sparse(
        sp.feat_rows, sp.feat_codes, *(torch.from_numpy(a) for a in (node, g, h)), 4, B)
    want = histogram_sparse_pallas(ref.bins.feat_rows, ref.bins.feat_codes,
                                   *(jnp.asarray(a) for a in (node, g, h)), 4, B,
                                   entry_block=128, interpret=True)
    _close(got.numpy(), want, "stored-entry histogram")
    # Stored entries never sit at their feature's zero bin.
    zb = sp.zero_bin.long()
    assert not got[:, :, torch.arange(DIM), zb].any()


def test_dispatch_is_by_device(pair):
    sp = pair[0].bins
    zeros = torch.zeros(N)
    before = histogram_sparse.launches
    histogram_sparse.histogram_sparse(sp.feat_rows, sp.feat_codes,
                                      torch.zeros(N, dtype=torch.int32), zeros, zeros, 1, B)
    assert histogram_sparse.launches == before
    with pytest.raises(ValueError, match="no kernel"):
        histogram_sparse.histogram_sparse(sp.feat_rows.to("meta"), sp.feat_codes, None, None,
                                          None, 1, B)


def _same_tree(a_feat, a_thr, a_pred, b_feat, b_thr, b_pred, depth, what):
    """The cross-backend contract: bitwise heap prefix (levels 0..3), >= 97%
    of nodes identical, <= 1% RMS prediction drift."""
    prefix = (1 << min(depth, 4)) - 1
    for a, b, name in ((a_feat, b_feat, "feature"), (a_thr, b_thr, "threshold")):
        np.testing.assert_array_equal(a[:prefix], b[:prefix], err_msg=f"{what}: {name}")
        assert np.mean(a == b) >= 0.97, f"{what}: {name}"
    scale = np.sqrt(np.mean(b_pred ** 2)) + 1e-12
    assert np.sqrt(np.mean((a_pred - b_pred) ** 2)) <= 0.01 * scale, what


@pytest.mark.parametrize("hist_mode", ["subtract", "rebuild"])
def test_sparse_build_tree_matches_dense_and_jax(pair, hist_mode):
    port, ref = pair
    depth = 4
    g, h = _gh(N, 5)
    key = jax.random.PRNGKey(5)
    mask = np.asarray(jax.random.uniform(key, (DIM,)) < 0.8).copy()
    cfg = LearnerConfig(depth=depth, n_bins=B, hist_mode=hist_mode)
    tg, th, tm = (torch.from_numpy(a) for a in (g, h, mask))
    dense = binning.to_dense(port.bins)
    ts = build_tree(cfg, port.bins, tg, th, tm)
    td = build_tree(cfg, dense, tg, th, tm)
    jt = jbuild_tree(JLearnerConfig(depth=depth, n_bins=B, hist_mode=hist_mode), ref.bins,
                     jnp.asarray(g), jnp.asarray(h), key)
    pred_s = apply_tree(ts, port.bins).numpy()
    _same_tree(ts.feature.numpy(), ts.threshold.numpy(), pred_s, td.feature.numpy(),
               td.threshold.numpy(), apply_tree(td, dense).numpy(), depth, "port dense")
    _same_tree(ts.feature.numpy(), ts.threshold.numpy(), pred_s, np.asarray(jt.feature),
               np.asarray(jt.threshold), np.asarray(japply_tree(jt, ref.bins)), depth,
               "jax sparse")
    # Routing reads the same bins on either layout.
    assert torch.equal(leaf_indices(ts, port.bins), leaf_indices(ts, dense))


def test_fused_backend_runs_staged_on_sparse_bins(pair, monkeypatch):
    port, _ = pair
    g, h = (torch.from_numpy(a) for a in _gh(N, 6))
    mask = torch.ones(DIM, dtype=torch.bool)
    monkeypatch.setattr(ops, "level_build", lambda *a, **k: pytest.fail("fused on sparse"))
    cfg = LearnerConfig(depth=3, n_bins=B)
    staged = build_tree(cfg, port.bins, g, h, mask)
    fused = build_tree(cfg._replace(backend="fused"), port.bins, g, h, mask)
    for a, b in zip(staged, fused):
        assert torch.equal(a, b)


def test_trainer_takes_sparse_bins(pair):
    """The PS trainer on the sparse layout: the loss falls to within 1% of
    the dense layout's drop on the same draws (a near-tied split may flip
    and move the later rounds), and the forest's predictions on the dense
    bins are the train-set f."""
    from repro_torch.trees.forest import forest_predict

    port, _ = pair
    cfg = SGBDTConfig(n_trees=6, step_length=0.3, learner=LearnerConfig(depth=3, n_bins=B))
    dense = port._replace(bins=binning.to_dense(port.bins))
    runs = [Trainer(cfg, device="cpu").train(d, ("round_robin", 2), seed=3)
            for d in (port, dense)]
    loss = [float(cfg.obj.loss(port.labels, r.f, port.multiplicity)) for r in runs]
    loss0 = float(cfg.obj.loss(port.labels, torch.full((N,), float(runs[0].forest.base_score)),
                               port.multiplicity))
    assert loss[0] < loss0 and abs(loss[0] - loss[1]) <= 0.01 * (loss0 - loss[1])
    torch.testing.assert_close(forest_predict(runs[0].forest, dense.bins), runs[0].f,
                               rtol=1e-5, atol=1e-6)
