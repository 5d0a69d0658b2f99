"""Parity of the port's staged tree learner with the JAX package.

Both packages get the same bins, gradients, hessians and feature mask (the
mask is the reference's own draw, injected into the port). The contract:

  * structure is exact at every node whose ancestors agree and whose best
    gain beats the runner-up by more than 1e-4 (relative) — elsewhere f32
    rounding may flip a near-tie (at depth 7 on 600 samples a few nodes
    hold only a handful of samples, and near-ties are common);
  * every leaf whose whole path agrees matches to 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.trees.learner import LearnerConfig as JLearnerConfig
from repro.trees.learner import build_tree as jbuild_tree
from repro_torch.kernels import ref
from repro_torch.trees.learner import LearnerConfig, build_tree, segment_sum

N, F, B = 600, 20, 32
LAM, MIN_H, FF = 1.0, 1e-3, 0.8


def _case(seed=23):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B, (N, F)).astype(np.int32)
    h = (1.25 * rng.binomial(1, 0.8, N)).astype(np.float32)
    g = (h * (rng.standard_normal(N) + 0.8 * (bins[:, 3] > 20))).astype(np.float32)
    return bins, g, h


def _expected_split(bins, g, h, on_node, mask):
    """(decisive, feat, thr) of one node from its samples, by the plain
    gain surface: decisive when the best gain beats the runner-up by more
    than 1e-4 (relative) and is not within rounding of the pass-left rule."""
    node = torch.where(torch.from_numpy(on_node), 0, -1).to(torch.int32)
    hist = ref.histogram_ref(torch.from_numpy(bins), node, torch.from_numpy(g),
                             torch.from_numpy(h), 1, B)
    gain = ref.split_gain_surface_ref(hist, LAM, MIN_H)[0].numpy()
    flat = np.where(mask[:, None], gain, -np.inf).reshape(-1)
    if not np.isfinite(flat).any():
        return True, 0, B - 1
    idx = int(np.argmax(flat))
    best, second = flat[idx], np.max(np.delete(flat, idx))
    if best <= 0:
        return best < -1e-6, 0, B - 1
    return best - second > 1e-4 * abs(best) and best > 1e-6, idx // B, idx % B


@pytest.mark.parametrize("hist_mode", ["subtract", "rebuild"])
@pytest.mark.parametrize("depth", [1, 3, 7])
def test_build_tree_matches_jax(depth, hist_mode):
    bins, g, h = _case()
    key = jax.random.PRNGKey(depth)
    mask = np.asarray(jax.random.uniform(key, (F,)) < FF)
    jt = jbuild_tree(
        JLearnerConfig(depth=depth, n_bins=B, lam=LAM, min_child_hess=MIN_H,
                       feature_fraction=FF, backend="ref", hist_mode=hist_mode),
        jnp.asarray(bins), jnp.asarray(g), jnp.asarray(h), key,
    )
    tt = build_tree(
        LearnerConfig(depth=depth, n_bins=B, lam=LAM, min_child_hess=MIN_H,
                      feature_fraction=FF, hist_mode=hist_mode),
        *(torch.from_numpy(a) for a in (bins, g, h)), torch.from_numpy(mask.copy()),
    )
    jfeat, jthr = np.asarray(jt.feature), np.asarray(jt.threshold)
    tfeat, tthr = tt.feature.numpy(), tt.threshold.numpy()
    assert tt.feature.dtype == torch.int32 and tt.leaf_value.dtype == torch.float32

    # Walk the heap; a node's sample set is fixed once its ancestors agree.
    reach = {0: np.ones(N, bool)}
    checked = 0
    for i in range((1 << depth) - 1):
        if i not in reach:
            continue  # an ancestor differs: this subtree may differ freely
        decisive, ef, et = _expected_split(bins, g, h, reach[i], mask)
        same = (tfeat[i], tthr[i]) == (jfeat[i], jthr[i])
        if decisive:
            checked += 1
            assert same, f"node {i}: port {(tfeat[i], tthr[i])} vs jax {(jfeat[i], jthr[i])}"
            assert (jfeat[i], jthr[i]) == (ef, et)
        if same:
            right = bins[:, jfeat[i]] > jthr[i]
            reach[2 * i + 1] = reach[i] & ~right
            reach[2 * i + 2] = reach[i] & right
    assert checked >= min(depth, 5)  # the check is not vacuous

    # A leaf whose whole path agrees holds the same samples in both builds.
    n_int = (1 << depth) - 1
    same_path = [i - n_int for i in range(n_int, 2 * n_int + 1) if i in reach]
    assert same_path
    np.testing.assert_allclose(tt.leaf_value.numpy()[same_path],
                               np.asarray(jt.leaf_value)[same_path], rtol=1e-5, atol=1e-5)


def test_unsplittable_nodes_pass_left():
    """Zero gradients give no positive gain: every node is the pass-through
    split (feature 0, threshold B - 1) and every leaf value is 0."""
    bins, _, h = _case(1)
    tt = build_tree(LearnerConfig(depth=3, n_bins=B), torch.from_numpy(bins),
                    torch.zeros(N), torch.from_numpy(h), torch.ones(F, dtype=torch.bool))
    assert (tt.feature == 0).all() and (tt.threshold == B - 1).all()
    assert not tt.leaf_value.any()


def test_masked_features_are_never_split_on():
    bins, g, h = _case(2)
    mask = torch.zeros(F, dtype=torch.bool)
    mask[[3, 7]] = True
    tt = build_tree(LearnerConfig(depth=4, n_bins=B), *(torch.from_numpy(a) for a in
                                                       (bins, g, h)), mask)
    split = tt.threshold < B - 1
    assert split.any() and set(tt.feature[split].tolist()) <= {3, 7}


def test_segment_sum_matches_index_add():
    rng = np.random.default_rng(4)
    seg = torch.from_numpy(rng.integers(0, 16, 300).astype(np.int32))
    vals = torch.from_numpy(rng.standard_normal(300).astype(np.float32))
    want = torch.zeros(16).index_add_(0, seg.long(), vals)
    torch.testing.assert_close(segment_sum(vals, seg, 16), want, rtol=1e-5, atol=1e-5)
