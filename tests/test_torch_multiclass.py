"""The port's K-output (multiclass) training path against the JAX package.

Same seeded numpy inputs through both packages, K = 3, N = 600, depth 4.
The reference draws its randomness with ``jax.random``; the tests
recompute its draws from its keys (engine.py:83-84, learner.py:324-328:
one (m', feature mask) pair a round, the mask shared by the round's K
trees) and inject them into the port. Tolerances:

  * objective: rtol 1e-6 (softmax and log-softmax round differently in
    the two frameworks); the gradient and the hessian's diagonal against
    ``torch.autograd`` of ``loss_sum`` in float64, to 1e-12;
  * data: identical (the same numpy draws, the same binning);
  * trees and training: the repo's cross-backend forest contract —
    a bitwise heap prefix (levels 0..2: the whole tree in the training
    run), at least 97% of nodes identical,
    at most 1% RMS prediction drift — and F within rtol 1e-5 (leaves are
    sums taken in another order);
  * on Gaussian blobs (``make_multiclass_classification``), where splits
    tie: the first round's K trees split alike at every node whose
    ancestors agree, or the two splits' gains under that node's histogram
    agree within 1e-6 of the sum of the gain's three terms' magnitudes
    (f32 sums taken in other orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sgbdt import SGBDTConfig as JSGBDTConfig
from repro.core.sgbdt import init_state as jinit_state
from repro.core.sgbdt import train_loss as jtrain_loss
from repro.core.sgbdt import train_metrics as jtrain_metrics
from repro.data import synthetic as jsyn
from repro.data.sampling import bernoulli_weights as jbernoulli_weights
from repro.objectives import get_objective as jget_objective
from repro.ps.engine import Trainer as JTrainer
from repro.trees.binning import BinnedData as JBinnedData
from repro.trees.forest import empty_forest as jempty_forest
from repro.trees.forest import forest_predict as jforest_predict
from repro.trees.forest import forest_push as jforest_push
from repro.trees.learner import LearnerConfig as JLearnerConfig
from repro.trees.learner import build_tree_multi as jbuild_tree_multi
from repro.trees.tree import Tree as JTree
from repro.trees.tree import apply_tree_stack as japply_tree_stack
from repro_torch.convert import binned_from_numpy, forest_from_numpy
from repro_torch.core.sgbdt import SGBDTConfig, init_state, train_loss, train_metrics
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels import histogram, split_scan
from repro_torch.objectives import (
    BinaryLogistic,
    MulticlassSoftmax,
    get_objective,
    registered_objectives,
)
from repro_torch.ps.engine import Trainer
from repro_torch.trees.forest import empty_forest, forest_predict, forest_push
from repro_torch.trees.learner import LearnerConfig, build_tree, build_tree_multi
from repro_torch.trees.tree import Tree, apply_tree_stack, empty_tree

K, N, DIM, DEPTH, ROUNDS, STEP, NB = 3, 600, 8, 4, 6, 0.3, 16
# The training run's depth: at depth 4, a level-3 node of about 60 samples
# ties exactly between a signal and a noise split in the first round (its
# gradients take two values a column, its weights are multiples of 1.25),
# and the packages' sums, taken in other orders, break the tie apart; one
# flipped split then moves every later round's gradients.
TRAIN_DEPTH = 3


def _yfw(seed=0, n=400):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, K, n).astype(np.float32)
    f = (2.0 * rng.standard_normal((n, K))).astype(np.float32)
    w = rng.integers(1, 4, n).astype(np.float32)
    return y, f, w


def test_multiclass_softmax_matches_jax():
    y, f, w = _yfw()
    t, j = get_objective(f"multiclass:{K}"), jget_objective(f"multiclass:{K}")
    assert t.n_outputs == j.n_outputs == K
    ty, tf, tw = (torch.from_numpy(a) for a in (y, f, w))
    jy, jf, jw = (jnp.asarray(a) for a in (y, f, w))
    np.testing.assert_allclose(t.init_score(ty, tw).numpy(), np.asarray(j.init_score(jy, jw)),
                               rtol=1e-6)
    for got, want in zip(t.grad_hess(ty, tf), j.grad_hess(jy, jf)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(t.link(tf).numpy(), np.asarray(j.link(jf)), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(t.per_example(ty, tf).numpy(),
                               np.asarray(j.per_example(jy, jf)), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(t.loss(ty, tf, tw)), float(j.loss(jy, jf, jw)),
                               rtol=1e-6)
    np.testing.assert_allclose(float(t.loss(ty, tf)), float(j.loss(jy, jf)), rtol=1e-6)
    tm, jm = t.metrics(ty, tf, tw), j.metrics(jy, jf, jw)
    assert set(tm) == set(jm) == {"loss", "accuracy"}
    np.testing.assert_allclose(float(tm["accuracy"]), float(jm["accuracy"]), rtol=1e-6)


def test_multiclass_gradient_and_hessian_are_autograd_s():
    y, f, _ = _yfw(1, 12)
    obj = MulticlassSoftmax(K)
    ty = torch.from_numpy(y).double()
    ft = torch.from_numpy(f).double().requires_grad_()
    (grad,) = torch.autograd.grad(obj.loss_sum(ty, ft), ft, create_graph=True)
    g, h = obj.grad_hess(ty, ft.detach())
    torch.testing.assert_close(g, grad.detach(), rtol=0, atol=1e-12)
    # The hessian's diagonal: d(grad[i, k]) / d f[i, k].
    diag = torch.stack([torch.autograd.grad(grad[:, k].sum(), ft, retain_graph=True)[0][:, k]
                        for k in range(K)], dim=1)
    torch.testing.assert_close(h, diag, rtol=0, atol=1e-12)


def test_get_objective_parses_name_and_argument():
    obj = get_objective("multiclass:3")
    assert isinstance(obj, MulticlassSoftmax) and obj.n_classes == 3 and obj.n_outputs == 3
    assert get_objective("softmax:5") == MulticlassSoftmax(5)
    assert isinstance(get_objective("binary_logistic"), BinaryLogistic)
    assert get_objective(obj) is obj
    assert set(registered_objectives()) == {"logistic", "multiclass", "lambdarank", "mse",
                                            "quantile", "huber"}
    with pytest.raises(ValueError, match="unknown objective 'nope'"):
        get_objective("nope:2")
    with pytest.raises(TypeError):
        get_objective(3)
    cfg = SGBDTConfig(objective="multiclass:4")
    assert cfg.n_outputs == 4 and SGBDTConfig().n_outputs == 1


def test_make_multiclass_classification_matches_reference():
    j = jsyn.make_multiclass_classification(N, DIM, K, seed=2)
    t = tsyn.make_multiclass_classification(N, DIM, K, seed=2, device="cpu")
    for name in ("bins", "bin_edges", "labels", "multiplicity"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                      err_msg=name)
    assert t.n_bins == j.n_bins == 64


def _decisive_data(seed=0, n_bins=16):
    """Labels drawn from a softmax over scores of four thresholded features
    of falling weight, four noise features: the splits are decisive. (On
    Gaussian blobs the first round's gradients take two values a column,
    so distinct splits that move the same label counts tie exactly, and
    the two packages' sums, taken in other orders, break the tie apart.)"""
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, n_bins, (N, DIM)).astype(np.int32)
    side = lambda c, t: 2.0 * (bins[:, c] > t) - 1.0  # noqa: E731
    z = np.stack([3.0 * side(0, 8) + 1.5 * side(1, 4),
                  3.0 * side(2, 10) + 0.75 * side(3, 6),
                  np.zeros(N)], axis=1)
    p = np.exp(z) / np.exp(z).sum(1, keepdims=True)
    y = (rng.random(N)[:, None] > np.cumsum(p, 1)).sum(1).astype(np.float32)
    return JBinnedData(
        bins=jnp.asarray(bins), bin_edges=jnp.zeros((DIM, n_bins - 1), jnp.float32),
        labels=jnp.asarray(y), multiplicity=jnp.ones(N, jnp.float32), n_bins=n_bins,
    )


@pytest.fixture(scope="module")
def data_pair():
    j = _decisive_data()
    t = binned_from_numpy(j.bins, j.bin_edges, j.labels, j.multiplicity, j.n_bins,
                          device="cpu")
    return j, t


def _contract(tf, jf, prefix):
    """The cross-backend forest contract's structure checks."""
    for name in ("feature", "threshold"):
        a, b = getattr(tf, name).numpy(), np.asarray(getattr(jf, name))
        np.testing.assert_array_equal(a[..., :prefix], b[..., :prefix], err_msg=name)
        assert np.mean(a == b) >= 0.97, f"{name}: too many node flips"


def _rms_close(got, want):
    scale = np.sqrt(np.mean(want ** 2)) + 1e-12
    assert np.sqrt(np.mean((got - want) ** 2)) <= 0.01 * scale


@pytest.mark.parametrize("backend", ["staged", "fused"])
def test_build_tree_multi_lanes(data_pair, backend):
    """Each lane equals a standalone ``build_tree`` on its column (bitwise)
    and the reference's lane under the cross-backend contract, on one
    shared mask."""
    jdata, tdata = data_pair
    jobj = jget_objective(f"multiclass:{K}")
    f0 = jinit_state(JSGBDTConfig(objective=f"multiclass:{K}"), jdata).f
    g, _ = jobj.grad_hess(jdata.labels, f0)
    m = np.random.default_rng(1).binomial(1, 0.8, N).astype(np.float32) * 1.25
    gw = np.asarray(g) * m[:, None]
    hw = np.broadcast_to(m[:, None], gw.shape).copy()
    key = jax.random.PRNGKey(3)
    jcfg = JLearnerConfig(depth=DEPTH, n_bins=NB, feature_fraction=0.8, backend="ref")
    jt = jbuild_tree_multi(jcfg, jdata.bins, jnp.asarray(gw), jnp.asarray(hw), key)
    mask = torch.from_numpy(np.array(jax.random.uniform(key, (DIM,)) < 0.8))
    tcfg = LearnerConfig(depth=DEPTH, n_bins=NB, feature_fraction=0.8, backend=backend)
    gt, ht = torch.from_numpy(gw), torch.from_numpy(hw)
    tt = build_tree_multi(tcfg, tdata.bins, gt, ht, mask)
    assert tt.leaf_value.shape == (K, 1 << DEPTH) and tt.feature.shape == (K, (1 << DEPTH) - 1)
    for k in range(K):
        lane = build_tree(tcfg, tdata.bins, gt[:, k].contiguous(), ht[:, k].contiguous(), mask)
        for name in Tree._fields:
            assert torch.equal(getattr(tt, name)[k], getattr(lane, name)), (k, name)
    _contract(tt, jt, (1 << 3) - 1)
    np.testing.assert_allclose(tt.leaf_value.numpy(), np.asarray(jt.leaf_value), rtol=1e-5,
                               atol=1e-6)
    got = apply_tree_stack(tt, tdata.bins).numpy()
    want = np.asarray(japply_tree_stack(jt, jdata.bins))
    assert got.shape == (N, K)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_apply_tree_stack_and_group_push_match_reference(data_pair):
    """A stacked group through ``apply_tree_stack`` and into K consecutive
    slots with ``forest_push`` (in place), as the reference lays it out."""
    jdata, tdata = data_pair
    rng = np.random.default_rng(4)
    n_int = (1 << DEPTH) - 1
    arrays = (rng.integers(0, DIM, (K, n_int)).astype(np.int32),
              rng.integers(0, NB, (K, n_int)).astype(np.int32),
              (0.1 * rng.standard_normal((K, 1 << DEPTH))).astype(np.float32))
    tt, jt = Tree(*map(torch.from_numpy, arrays)), JTree(*map(jnp.asarray, arrays))
    np.testing.assert_array_equal(apply_tree_stack(tt, tdata.bins).numpy(),
                                  np.asarray(japply_tree_stack(jt, jdata.bins)))
    tf = empty_forest(4, DEPTH, base_score=0.5, n_outputs=K, device="cpu")
    jf = jempty_forest(4, DEPTH, base_score=0.5, n_outputs=K)
    assert tf.n_outputs == jf.n_outputs == K and tf.feature.shape == (4 * K, n_int)
    for _ in range(2):
        tf = forest_push(tf, tt, 0.5)
        jf = jforest_push(jf, jt, jnp.float32(0.5))
    for name in tf._fields:
        np.testing.assert_array_equal(getattr(tf, name).numpy(), np.asarray(getattr(jf, name)),
                                      err_msg=name)
    np.testing.assert_allclose(forest_predict(tf, tdata.bins).numpy(),
                               np.asarray(jforest_predict(jf, jdata.bins, backend="ref")),
                               rtol=1e-6, atol=1e-6)
    e = empty_tree(DEPTH, device="cpu")
    assert (e.threshold == 2**30).all() and not e.leaf_value.any()


def _split_ties(bins, g, h, mask, tree, jtree, lc):
    """Walk one lane's heap where the port's and the reference's ancestors
    agree; where the two split one node differently, require a tie: the
    gains of both splits under the node's histogram (the port's plain
    version) within 1e-6 of the sum of the gain's three terms' magnitudes.
    Returns the number of such nodes."""
    nb, n = lc.n_bins, bins.shape[0]
    feat, thr = tree.feature.long(), tree.threshold
    jfeat, jthr = np.asarray(jtree.feature), np.asarray(jtree.threshold)
    heap = torch.zeros(n, dtype=torch.long)
    agree, ties = {0}, 0
    for level in range(lc.depth):
        for i in range((1 << level) - 1, (1 << (level + 1)) - 1):
            if i not in agree:
                continue
            if (int(feat[i]), int(thr[i])) == (int(jfeat[i]), int(jthr[i])):
                agree |= {2 * i + 1, 2 * i + 2}
                continue
            hist = histogram.histogram_plain(bins, torch.where(heap == i, 0, -1).to(torch.int32),
                                             g, h, 1, nb)
            gain = split_scan.split_gain_plain(hist, lc.lam, lc.min_child_hess)
            gain = gain.masked_fill(~mask[None, :, None], float("-inf")).reshape(-1)
            gl, hl = torch.cumsum(hist[0, 0].double(), -1), torch.cumsum(hist[1, 0].double(), -1)
            gt, ht = gl[:, -1:], hl[:, -1:]
            terms = (gl ** 2 / (hl + lc.lam) + (gt - gl) ** 2 / (ht - hl + lc.lam)
                     + gt ** 2 / (ht + lc.lam)).reshape(-1)
            a, b = int(feat[i]) * nb + int(thr[i]), int(jfeat[i]) * nb + int(jthr[i])
            assert abs(float(gain[a] - gain[b])) <= 1e-6 * float(max(terms[a], terms[b])), (
                f"node {i}: splits {a} and {b} differ without a tie "
                f"(gains {float(gain[a])} vs {float(gain[b])})")
            ties += 1
        right = bins.gather(1, feat[heap][:, None])[:, 0] > thr[heap]
        heap = 2 * heap + 1 + right.long()
    return ties


@pytest.mark.parametrize("seed", range(6))
def test_multiclass_blob_lanes_differ_only_at_ties(seed):
    """The data the multiclass configuration trains on: Gaussian blobs,
    64 bins, K = 3, depth 4. Round 0's K trees from the same draws in both
    packages split alike below agreeing ancestors, up to exact ties."""
    spec = f"multiclass:{K}"
    jdata = jsyn.make_multiclass_classification(N, DIM, K, seed=seed)
    tdata = binned_from_numpy(jdata.bins, jdata.bin_edges, jdata.labels, jdata.multiplicity,
                              jdata.n_bins, device="cpu")
    g, _ = jget_objective(spec).grad_hess(jdata.labels,
                                          jinit_state(JSGBDTConfig(objective=spec), jdata).f)
    m, _ = _reference_draws(jdata, 1)[0]
    gw = np.asarray(g) * m.numpy()[:, None]
    hw = np.broadcast_to(m.numpy()[:, None], gw.shape).copy()
    key = jax.random.PRNGKey(seed)
    jt = jbuild_tree_multi(JLearnerConfig(depth=DEPTH, n_bins=jdata.n_bins, feature_fraction=0.8,
                                          backend="ref"),
                           jdata.bins, jnp.asarray(gw), jnp.asarray(hw), key)
    mask = torch.from_numpy(np.array(jax.random.uniform(key, (DIM,)) < 0.8))
    lc = LearnerConfig(depth=DEPTH, n_bins=jdata.n_bins, feature_fraction=0.8)
    tt = build_tree_multi(lc, tdata.bins, torch.from_numpy(gw), torch.from_numpy(hw), mask)
    for k in range(K):
        _split_ties(tdata.bins, torch.from_numpy(gw[:, k].copy()),
                    torch.from_numpy(hw[:, k].copy()), mask,
                    Tree(*(a[k] for a in tt)), JTree(*(a[k] for a in jt)), lc)


def _reference_draws(jdata, rounds, seed=0):
    """The reference's per-round (m', feature mask), as torch tensors."""
    keys = jax.random.split(jax.random.PRNGKey(seed), rounds)
    out = []
    for j in range(rounds):
        r_sample, r_feat = jax.random.split(keys[j])
        m, _ = jbernoulli_weights(r_sample, 0.8, jdata.multiplicity)
        mask = jax.random.uniform(r_feat, (jdata.n_features,)) < 0.8
        out.append((torch.from_numpy(np.array(m)), torch.from_numpy(np.array(mask))))
    return out


def test_multiclass_training_matches_jax(data_pair):
    """6 rounds under round-robin W = 4 (stale targets from a ring of (N, K)
    versions of F), the reference's draws injected, at ``TRAIN_DEPTH``."""
    jdata, tdata = data_pair
    spec = f"multiclass:{K}"
    jcfg = JSGBDTConfig(n_trees=ROUNDS, step_length=STEP, sampling_rate=0.8, objective=spec,
                        learner=JLearnerConfig(depth=TRAIN_DEPTH, n_bins=NB, feature_fraction=0.8,
                                               backend="ref"))
    tcfg = SGBDTConfig(n_trees=ROUNDS, step_length=STEP, sampling_rate=0.8, objective=spec,
                       learner=LearnerConfig(depth=TRAIN_DEPTH, n_bins=NB, feature_fraction=0.8))
    t0, j0 = init_state(tcfg, tdata), jinit_state(jcfg, jdata)
    assert t0.f.shape == (N, K) and t0.forest.base_score.shape == (K,)
    np.testing.assert_allclose(t0.f.numpy(), np.asarray(j0.f), rtol=1e-6)
    js = JTrainer(jcfg).train(jdata, ("round_robin", 4), seed=0)
    ts = Trainer(tcfg, device="cpu").train(tdata, ("round_robin", 4), seed=0,
                                           draws=_reference_draws(jdata, ROUNDS))
    jf, tf = js.forest, ts.forest
    assert int(tf.n_trees) == int(jf.n_trees) == ROUNDS * K and ts.step == ROUNDS
    _contract(tf, jf, (1 << TRAIN_DEPTH) - 1)
    np.testing.assert_allclose(ts.f.numpy(), np.asarray(js.f), rtol=1e-5, atol=1e-6)
    _rms_close(forest_predict(tf, tdata.bins).numpy(),
               np.asarray(jforest_predict(jf, jdata.bins, backend="ref")))
    # The forest predicts the trained F; the loss fell; metrics agree.
    torch.testing.assert_close(forest_predict(tf, tdata.bins), ts.f, rtol=1e-5, atol=1e-6)
    l0, l1 = float(train_loss(tcfg, tdata, t0)), float(train_loss(tcfg, tdata, ts))
    assert l1 < l0
    np.testing.assert_allclose(l1, float(jtrain_loss(jcfg, jdata, js)), rtol=1e-5)
    tm, jm = train_metrics(tcfg, tdata, ts), jtrain_metrics(jcfg, jdata, js)
    np.testing.assert_allclose(float(tm["accuracy"]), float(jm["accuracy"]), atol=1 / N)
    # The converted reference forest predicts what the reference does.
    cf = forest_from_numpy(*(np.asarray(a) for a in jf), device="cpu")
    assert cf.base_score.shape == (K,)
    np.testing.assert_allclose(forest_predict(cf, tdata.bins).numpy(),
                               np.asarray(jforest_predict(jf, jdata.bins, backend="ref")),
                               rtol=1e-5, atol=1e-6)


def test_multiclass_training_is_deterministic_in_the_port(data_pair):
    """Two seeded runs give the same bits, staged and fused alike."""
    _, tdata = data_pair
    cfg = SGBDTConfig(n_trees=3, step_length=STEP, objective=f"multiclass:{K}",
                      learner=LearnerConfig(depth=DEPTH, n_bins=NB))
    runs = [Trainer(c, device="cpu").train(tdata, ("round_robin", 2), seed=5)
            for c in (cfg, cfg, cfg._replace(learner=cfg.learner._replace(backend="fused")))]
    for other in runs[1:]:
        for name in ("feature", "threshold", "leaf_value", "n_trees"):
            assert torch.equal(getattr(runs[0].forest, name), getattr(other.forest, name))
        assert torch.equal(runs[0].f, other.f)
