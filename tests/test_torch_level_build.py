"""The port's fused tree level against the JAX package.

On the CPU ``kernels.level_build`` runs its plain version
(``ref.level_build_ref``); the CUDA kernel is held against that version,
and bitwise against the staged chain of kernels, on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``). Here the plain version
meets the JAX package's jnp oracle ``ref.level_build_ref`` and its fused
Pallas program in interpret mode (``ops.level_build(backend="fused")``),
as tests/test_level_build.py runs them. Contract (the tolerance of
tests/test_level_build.py:88): feature, threshold and new node ids exact;
histograms and best gains within rtol 1e-5, atol 1e-4. The fused Pallas
program routes a sample on node -1 by node 0's split, where both oracles
send it to -2, so its row map is compared on nodes >= 0 only.

The learner's fused backend builds the staged backend's tree bit for bit on
the CPU, with the budget patched so that the switch to staged levels falls
mid-tree, and meets the JAX package's fused learner under the repo's
cross-backend contract (bitwise heap prefix, >= 97% of nodes identical,
<= 1% RMS prediction drift).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.trees.learner import LearnerConfig as JLearnerConfig
from repro.trees.learner import build_tree as jbuild_tree
from repro.trees.tree import apply_tree as japply_tree
from repro_torch.kernels import hist_plan, level_build, ops, ref
from repro_torch.trees.learner import LearnerConfig, build_tree
from repro_torch.trees.tree import apply_tree

LAM, MIN_H = 1.0, 1e-3


def _inputs(seed, n, f, n_bins, n_nodes, lo=0):
    """Bins, node ids in [lo, n_nodes), a Gaussian gradient on the ~80% of
    samples drawn (hessian 1) and 0 elsewhere."""
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, n_bins, (n, f)).astype(np.int32)
    node = rng.integers(lo, n_nodes, n).astype(np.int32)
    h = (rng.random(n) < 0.8).astype(np.float32)
    g = (h * rng.standard_normal(n)).astype(np.float32)
    return bins, node, g, h


def _run_all(bins, node, g, h, active, parent, mask, n_nodes, n_bins, derive):
    """(port plain, JAX oracle, JAX fused Pallas), each as five numpy arrays."""
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (bins, node, g, h, active)]
    tp = None if parent is None else torch.from_numpy(parent)
    port = ops.level_build(*t, tp, torch.from_numpy(mask), LAM, MIN_H, n_nodes, n_bins,
                           derive_sibling=derive)
    j = [jnp.asarray(a) for a in (bins, node, g, h, active)]
    jp = None if parent is None else jnp.asarray(parent)
    jargs = (*j, jp, jnp.asarray(mask, jnp.float32), LAM, MIN_H, n_nodes, n_bins)
    oracle = jref.level_build_ref(*jargs, derive_sibling=derive)
    fused = jops.level_build(*jargs, backend="fused", derive_sibling=derive)
    return ([x.numpy() for x in port], [np.asarray(x) for x in oracle],
            [np.asarray(x) for x in fused])


def _check(port, want, what, node=None):
    hist, feat, thr, best, new = port
    np.testing.assert_array_equal(feat, want[1], err_msg=f"{what}: feat")
    np.testing.assert_array_equal(thr, want[2], err_msg=f"{what}: thr")
    keep = slice(None) if node is None else node >= 0
    np.testing.assert_array_equal(new[keep], want[4][keep], err_msg=f"{what}: new_node")
    np.testing.assert_allclose(hist, want[0], rtol=1e-5, atol=1e-4, err_msg=f"{what}: hist")
    np.testing.assert_allclose(best, want[3], rtol=1e-5, atol=1e-4, err_msg=f"{what}: best")


@pytest.mark.parametrize("n_nodes", [1, 2, 4, 8])
@pytest.mark.parametrize("n,f", [(640, 8), (700, 9), (515, 3)])
def test_full_level_matches_jax(n, f, n_nodes):
    n_bins = 16
    bins, node, g, h = _inputs(5, n, f, n_bins, n_nodes)
    active = np.arange(n_nodes, dtype=np.int32)
    mask = np.ones(f, np.float32)
    port, oracle, fused = _run_all(bins, node, g, h, active, None, mask, n_nodes, n_bins,
                                   False)
    _check(port, oracle, "jnp oracle")
    _check(port, fused, "fused pallas")


@pytest.mark.parametrize("level", [1, 2, 3])
def test_subtract_level_matches_jax(level):
    n, f, n_bins = 640, 8, 16
    n_nodes = 1 << level
    bins, node, g, h = _inputs(7, n, f, n_bins, n_nodes)
    parent = ref.histogram_ref(*(torch.from_numpy(a) for a in (bins, node >> 1, g, h)),
                               n_nodes // 2, n_bins).numpy()
    # Alternate which child is built, so both sibling positions derive.
    active = (2 * np.arange(n_nodes // 2) + np.arange(n_nodes // 2) % 2).astype(np.int32)
    mask = np.ones(f, np.float32)
    port, oracle, fused = _run_all(bins, node, g, h, active, parent, mask, n_nodes, n_bins,
                                   True)
    _check(port, oracle, "jnp oracle")
    _check(port, fused, "fused pallas")
    # The built rows are the subset histogram; each sibling is parent - built.
    built = ref.histogram_subset_ref(
        *(torch.from_numpy(a) for a in (bins, node, g, h, active)), n_nodes, n_bins).numpy()
    np.testing.assert_array_equal(port[0][:, active], built)


def test_mask_empty_node_and_inactive_samples():
    """Every other feature masked, node 3 empty (pass-left: feature 0,
    threshold B - 1, gain -inf), about a fifth of the samples on node -1
    (they add nothing and map to -2)."""
    n, f, n_bins, n_nodes = 512, 8, 16, 4
    bins, node, g, h = _inputs(13, n, f, n_bins, n_nodes - 1, lo=-1)
    active = np.arange(n_nodes, dtype=np.int32)
    mask = (np.arange(f) % 2 == 0).astype(np.float32)
    port, oracle, fused = _run_all(bins, node, g, h, active, None, mask, n_nodes, n_bins,
                                   False)
    _check(port, oracle, "jnp oracle")
    _check(port, fused, "fused pallas", node=node)
    hist, feat, thr, best, new = port
    assert (feat % 2 == 0).all(), "a masked feature won a split"
    assert (feat[3], thr[3]) == (0, n_bins - 1) and np.isneginf(best[3])
    assert not hist[:, 3].any()
    np.testing.assert_array_equal(new[node < 0], -2)
    kept = node >= 0
    np.testing.assert_array_equal(new[kept] >> 1, node[kept])


def test_the_mask_accepts_bool_int_and_float():
    bins, node, g, h = (torch.from_numpy(a) for a in _inputs(3, 300, 6, 16, 2))
    active = torch.arange(2, dtype=torch.int32)
    mask = torch.tensor([True, False] * 3)
    outs = [level_build.level_build(bins, node, g, h, active, None, m, LAM, MIN_H, 2, 16)
            for m in (mask, mask.to(torch.int32), mask.float())]
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            assert torch.equal(a, b)


# ------------------------------------------------------------ budget model
REALSIM = dict(n=4000, n_feat=1500, n_bins=64)


def test_budget_model_fuses_realsim_levels_0_to_4():
    fits = [level_build.fused_level_fits(n_nodes=1 << lv, n_sub=max(1, (1 << lv) // 2),
                                         **REALSIM) for lv in range(9)]
    assert fits == [True] * 5 + [False] * 4
    # 24 MB of bins + 3 * 2^l rows of 384 000 B at a subtract level l >= 1,
    # and the launch's scratch (the row list, the (node, tile) partials).
    scratch = hist_plan.work_ints(hist_plan.plan(REALSIM["n"], 1500, 64, 8), REALSIM["n"], 64,
                                  16, fused=True)
    assert level_build.fused_level_bytes(REALSIM["n"], 16, 8, 1500, 64) == \
        24_000_000 + 3 * 16 * 384_000 + 4 * scratch


@pytest.mark.parametrize("axis", ["n", "n_nodes", "n_sub", "n_feat", "n_bins"])
def test_budget_model_is_monotone(axis):
    base = dict(n=1000, n_nodes=8, n_sub=4, n_feat=100, n_bins=32)
    sizes = [level_build.fused_level_bytes(**{**base, axis: base[axis] * k})
             for k in (1, 2, 3, 5)]
    assert sizes == sorted(sizes) and sizes[0] < sizes[-1]
    budget = sizes[1]
    fits = [level_build.fused_level_fits(**{**base, axis: base[axis] * k}, budget=budget)
            for k in (1, 2, 3, 5)]
    assert fits == [True, True, False, False]


# ---------------------------------------------------------------- learner
def _tree_case(seed=23, n=700, f=9, n_bins=32):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, n_bins, (n, f)).astype(np.int32)
    h = (1.25 * rng.binomial(1, 0.8, n)).astype(np.float32)
    g = (h * (rng.standard_normal(n) + 0.8 * (bins[:, 3] > 20))).astype(np.float32)
    return bins, g, h


@pytest.mark.parametrize("hist_mode", ["subtract", "rebuild"])
@pytest.mark.parametrize("depth", [1, 3, 5])
def test_fused_learner_is_bitwise_staged(depth, hist_mode, monkeypatch):
    """Levels 0 .. depth // 2 fuse and the rest run staged: the same tree."""
    bins, g, h = (torch.from_numpy(a) for a in _tree_case())
    mask = torch.from_numpy(np.random.default_rng(depth).random(9) < 0.8)
    fused_calls = []
    monkeypatch.setattr(level_build, "fused_level_fits",
                        lambda n, n_nodes, *a: n_nodes <= 1 << (depth // 2))
    real = ops.level_build
    monkeypatch.setattr(ops, "level_build",
                        lambda *a, **k: fused_calls.append(a[9]) or real(*a, **k))
    cfg = LearnerConfig(depth=depth, n_bins=32, hist_mode=hist_mode)
    staged = build_tree(cfg, bins, g, h, mask)
    fused = build_tree(cfg._replace(backend="fused"), bins, g, h, mask)
    assert fused_calls == [1 << lv for lv in range(depth // 2 + 1)]
    for a, b in zip(staged, fused):
        assert torch.equal(a, b)


@pytest.mark.parametrize("hist_mode", ["subtract", "rebuild"])
def test_fused_learner_matches_jax_fused(hist_mode):
    depth, n_bins, f = 3, 32, 9
    bins, g, h = _tree_case()
    key = jax.random.PRNGKey(1)
    mask = np.asarray(jax.random.uniform(key, (f,)) < 0.8)
    jt = jbuild_tree(JLearnerConfig(depth=depth, n_bins=n_bins, backend="fused",
                                    hist_mode=hist_mode),
                     jnp.asarray(bins), jnp.asarray(g), jnp.asarray(h), key)
    tt = build_tree(LearnerConfig(depth=depth, n_bins=n_bins, hist_mode=hist_mode,
                                  backend="fused"),
                    *(torch.from_numpy(a) for a in (bins, g, h, mask.copy())))
    for name in ("feature", "threshold"):
        a, b = getattr(tt, name).numpy(), np.asarray(getattr(jt, name))
        np.testing.assert_array_equal(a, b)  # depth 3: the whole heap is the prefix
        assert np.mean(a == b) >= 0.97
    pred_t = apply_tree(tt, torch.from_numpy(bins)).numpy()
    pred_j = np.asarray(japply_tree(jt, jnp.asarray(bins)))
    scale = np.sqrt(np.mean(pred_j ** 2)) + 1e-12
    assert np.sqrt(np.mean((pred_t - pred_j) ** 2)) <= 0.01 * scale


def test_unknown_backend_is_refused():
    bins, g, h = (torch.from_numpy(a) for a in _tree_case())
    with pytest.raises(ValueError, match="backend"):
        build_tree(LearnerConfig(depth=2, n_bins=32, backend="pallas"), bins, g, h,
                   torch.ones(9, dtype=torch.bool))


def test_dispatch_is_by_device():
    """A CPU tensor runs the plain version (no launch counted); any other
    non-CUDA device raises instead of falling back."""
    bins, node, g, h = (torch.from_numpy(a) for a in _inputs(2, 64, 3, 8, 2))
    args = (torch.arange(2, dtype=torch.int32), None, torch.ones(3, dtype=torch.int32),
            LAM, MIN_H, 2, 8)
    before = level_build.launches
    level_build.level_build(bins, node, g, h, *args)
    assert level_build.launches == before
    with pytest.raises(ValueError, match="no kernel"):
        level_build.level_build(bins.to("meta"), node, g, h, *args)
