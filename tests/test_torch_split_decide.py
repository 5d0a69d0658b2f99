"""The split gain's decision form against the JAX package, on the CPU.

``split_scan.split_gain_decide`` returns the gain surface and each node's
first maximum under the feature mask. On the CPU it runs its plain version;
here that is held against the reference's decision: the Pallas split-gain
kernel in interpret mode (``backend="pallas"``), then ``jnp.where`` on the
mask, ``jnp.argmax`` and ``take_along_axis``, as ``repro.trees.learner``
takes them. Tolerances: idx exact; best rtol 1e-5, atol 1e-5 x the largest
finite gain (the two scans add in other orders), -inf exact. The staged
learner's trees are held bitwise to the chain the decision form replaced.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops, split_scan
from repro_torch.trees import learner
from repro_torch.trees.binning import gather_feature_bins
from repro_torch.trees.learner import LearnerConfig, build_tree

LAM, MIN_H = 1.0, 1e-3


def _hist(seed, l, f, b, n=600):
    """Histograms of random samples: ragged N, some samples on node -1,
    hessians that are multiples of 1.25 (importance weights at R = 0.8)."""
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, b, (n, f)).astype(np.int32)
    node = rng.integers(-1, l, n).astype(np.int32)
    hess = (1.25 * rng.binomial(1, 0.8, n)).astype(np.float32)
    grad = (hess * rng.standard_normal(n)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (bins, node, grad, hess)]
    return ops.build_histogram(*t, l, b)


def _jax_decision(hist, mask):
    """The reference's decision on the Pallas kernel's surface."""
    gain = jops.split_gain(jnp.asarray(hist.numpy()), LAM, MIN_H, backend="pallas")
    gain = jnp.where(jnp.asarray(mask.numpy() != 0)[None, :, None], gain, -jnp.inf)
    flat = gain.reshape(gain.shape[0], -1)
    idx = jnp.argmax(flat, axis=-1)
    best = jnp.take_along_axis(flat, idx[:, None], axis=-1)[:, 0]
    return np.asarray(best), np.asarray(idx)


def _check(hist, mask):
    gain, best, idx = split_scan.split_gain_decide(hist, LAM, MIN_H, mask)
    assert gain.dtype == torch.float32 and gain.shape == hist.shape[1:]
    assert best.shape == idx.shape == (hist.shape[1],)
    assert best.dtype == torch.float32 and idx.dtype == torch.int64
    assert torch.equal(gain, split_scan.split_gain_plain(hist, LAM, MIN_H))
    want_best, want_idx = _jax_decision(hist, mask)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    got = best.numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want_best))
    fin = np.isfinite(want_best)
    assert np.isfinite(got[fin]).all()
    surface = gain.numpy()
    scale = float(np.abs(surface[np.isfinite(surface)]).max(initial=1.0))
    np.testing.assert_allclose(got[fin], want_best[fin], rtol=1e-5, atol=1e-5 * scale)
    return best, idx


@pytest.mark.parametrize("l,f,b", [(1, 5, 16), (8, 40, 64), (3, 7, 100), (2, 9, 256)])
def test_decision_matches_jax(l, f, b):
    hist = _hist(l * f + b, l, f, b)
    mask = torch.from_numpy((np.random.default_rng(f).random(f) < 0.7).astype(np.int32))
    mask[0] = 1
    _check(hist, mask)


@pytest.mark.parametrize("masked_first", [False, True])
def test_planted_ties_pick_the_first_cell(masked_first):
    """Equal maxima in features 2, 5 and 8 of node 0 and 1, 5 and 8 of node
    1 (identical rows, so bitwise-equal gains): the first unmasked one wins."""
    rng = np.random.default_rng(4)
    l, f, b = 2, 10, 16
    hist = torch.zeros((2, l, f, b))
    hist[1] = 0.0  # no hessian mass: every cell of an untouched row is -inf
    row_g = torch.from_numpy(rng.standard_normal(b).astype(np.float32))
    row_h = torch.full((b,), 1.25)
    for node, feats in ((0, (2, 5, 8)), (1, (1, 5, 8))):
        for feat in feats:
            hist[0, node, feat], hist[1, node, feat] = row_g, row_h
    mask = torch.ones(f, dtype=torch.int32)
    if masked_first:
        mask[2] = mask[1] = 0
    best, idx = _check(hist, mask)
    bin_ = int(split_scan.split_gain_plain(hist, LAM, MIN_H)[0, 2].argmax())
    first = (5, 5) if masked_first else (2, 1)
    assert idx.tolist() == [first[0] * b + bin_, first[1] * b + bin_]
    assert best[0] == best[1] and torch.isfinite(best).all()


def test_all_masked_and_no_valid_cell_give_index_0():
    """Every feature masked: each node idx 0 and -inf. A node with no
    hessian mass has no valid cell: idx 0 and -inf beside a node that
    splits."""
    hist = _hist(7, 3, 6, 16)
    _, best, idx = split_scan.split_gain_decide(hist, LAM, MIN_H,
                                                torch.zeros(6, dtype=torch.int32))
    assert idx.tolist() == [0, 0, 0] and torch.isneginf(best).all()
    _check(hist, torch.zeros(6, dtype=torch.int32))
    hist[:, 1] = 0.0
    best, idx = _check(hist, torch.ones(6, dtype=torch.int32))
    assert int(idx[1]) == 0 and torch.isneginf(best[1])
    assert torch.isfinite(best[0]) and torch.isfinite(best[2])


def _chain_staged_level(cfg, bins, node, g, h, feat_mask, level, parent_hist):
    """The staged level with the decision as the torch chain it was: the
    surface, ``masked_fill``, ``argmax`` and ``gather``."""
    n_nodes, n_bins = 1 << level, cfg.n_bins
    hist = learner._level_histogram(cfg, bins, node, g, h, level, parent_hist)
    gain = ops.split_gain(hist, cfg.lam, cfg.min_child_hess)
    gain = gain.masked_fill(~(feat_mask != 0)[None, :, None], float("-inf"))
    flat = gain.reshape(n_nodes, -1)
    idx = torch.argmax(flat, dim=-1)
    best = flat.gather(1, idx[:, None])[:, 0]
    ok = torch.isfinite(best) & (best > 0.0)
    feat = torch.where(ok, idx // n_bins, 0).to(torch.int32)
    thr = torch.where(ok, idx % n_bins, n_bins - 1).to(torch.int32)
    nodel = node.long()
    val = gather_feature_bins(bins, feat.long()[nodel])
    return hist, feat, thr, 2 * node + (val > thr[nodel]).to(torch.int32)


@pytest.mark.parametrize("hist_mode", ["subtract", "rebuild"])
def test_staged_trees_are_unchanged_by_the_decision_form(monkeypatch, hist_mode):
    rng = np.random.default_rng(11)
    n, f, b = 500, 12, 32
    bins = torch.from_numpy(rng.integers(0, b, (n, f)).astype(np.int32))
    h = torch.from_numpy((1.25 * rng.binomial(1, 0.8, n)).astype(np.float32))
    g = h * torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    mask = torch.from_numpy(rng.random(f) < 0.8)
    cfg = LearnerConfig(depth=4, n_bins=b, hist_mode=hist_mode)
    tree = build_tree(cfg, bins, g, h, mask)
    monkeypatch.setattr(learner, "_staged_level", _chain_staged_level)
    want = build_tree(cfg, bins, g, h, mask)
    for name in ("feature", "threshold", "leaf_value"):
        assert torch.equal(getattr(tree, name), getattr(want, name)), name
    assert (tree.threshold < b - 1).any()
