"""Parity of the port's kernel modules with the JAX package.

On the CPU every kernel module runs its plain PyTorch version (the CUDA
kernels are held against those versions on the card, by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``). Here the plain
versions meet the JAX package: its Pallas kernels in interpret mode
(``backend="pallas"``, as tests/test_kernels.py runs them) and its jnp
oracles. Tolerances:

  * histograms and gains: rtol 1e-5, atol 1e-5 * max|cell| (sums taken in
    another order);
  * -inf masks of the gain surface: exact (hessians are multiples of 1.25,
    so every prefix sum is exact in any order);
  * traversal: leaf routing exact, sums to 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.trees.tree import Tree as JTree
from repro.trees.tree import leaf_indices as jleaf_indices
from repro_torch.kernels import forest_traversal, histogram, ops, ref, split_scan
from repro_torch.trees.tree import Tree, leaf_indices


def _case(seed, n, f, n_bins, n_nodes):
    """Ragged N, some samples on node -1, hessians that are multiples of
    1.25 (importance weights at R = 0.8)."""
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, n_bins, (n, f)).astype(np.int32)
    node = rng.integers(-1, n_nodes, n).astype(np.int32)
    hess = (1.25 * rng.binomial(1, 0.8, n)).astype(np.float32)
    grad = (hess * rng.standard_normal(n)).astype(np.float32)
    return bins, node, grad, hess


def _close(got, want, what):
    want = np.asarray(want)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale, err_msg=what)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("n,f,n_bins,n_nodes", [(333, 11, 16, 4), (517, 9, 64, 8)])
def test_histogram_full_matches_jax(n, f, n_bins, n_nodes):
    bins, node, grad, hess = _case(n + f, n, f, n_bins, n_nodes)
    got = ops.build_histogram(*_t(bins, node, grad, hess), n_nodes, n_bins).numpy()
    j_args = [jnp.asarray(a) for a in (bins, node, grad, hess)]
    _close(got, jops.build_histogram(*j_args, n_nodes, n_bins, backend="pallas"), "pallas")
    _close(got, jref.histogram_ref(*j_args, n_nodes, n_bins), "jnp oracle")


@pytest.mark.parametrize("n,f,n_bins,n_nodes", [(333, 11, 16, 8), (517, 9, 64, 16)])
def test_histogram_subset_matches_jax(n, f, n_bins, n_nodes):
    bins, node, grad, hess = _case(n * f, n, f, n_bins, n_nodes)
    active = (2 * np.arange(n_nodes // 2) + (np.arange(n_nodes // 2) % 2)).astype(np.int32)
    got = ops.build_histogram_subset(
        *_t(bins, node, grad, hess, active), n_nodes, n_bins
    ).numpy()
    j_args = [jnp.asarray(a) for a in (bins, node, grad, hess, active)]
    _close(got, jops.build_histogram_subset(*j_args, n_nodes, n_bins, backend="pallas"),
           "pallas")
    _close(got, jref.histogram_subset_ref(*j_args, n_nodes, n_bins), "jnp oracle")
    # Samples on nodes outside the subset add nothing: row r is the full
    # level's row active[r].
    full = ops.build_histogram(*_t(bins, node, grad, hess), n_nodes, n_bins).numpy()
    np.testing.assert_array_equal(got, full[:, active])


def test_histogram_inactive_samples_add_nothing():
    bins, node, grad, hess = _case(5, 200, 6, 16, 2)
    node[:] = -1
    out = histogram.histogram(*_t(bins, node, grad, hess), 2, 16)
    assert not out.any()


@pytest.mark.parametrize("l,f,b", [(1, 5, 16), (8, 7, 64)])
def test_gain_surface_matches_jax(l, f, b):
    bins, node, grad, hess = _case(l * f * b, 400, f, b, l)
    hist = ops.build_histogram(*_t(bins, node, grad, hess), l, b)
    got = ops.split_gain(hist, 1.0, 1e-3).numpy()
    jh = jnp.asarray(hist.numpy())
    for what, want in (
        ("pallas", jops.split_gain(jh, 1.0, 1e-3, backend="pallas")),
        ("jnp oracle", jops._split_gain_surface_ref(jh, jnp.float32(1.0), jnp.float32(1e-3))),
    ):
        want = np.asarray(want)
        np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want), err_msg=what)
        fin = np.isfinite(want)
        assert np.isfinite(got[fin]).all()
        _close(got[fin], want[fin], what)
    assert np.isneginf(got[..., -1]).all()


def test_gain_surface_min_child_hess_mask():
    """A row whose hessian mass sits in one bin has no valid split."""
    hist = torch.zeros((2, 1, 2, 8))
    hist[0, 0, 0, 3] = 2.0
    hist[1, 0, 0, 3] = 5.0
    hist[0, 0, 1] = torch.arange(8.0)
    hist[1, 0, 1] = 1.0
    gain = split_scan.split_gain(hist, 1.0, 1e-3)
    assert np.isneginf(gain[0, 0].numpy()).all()
    assert np.isfinite(gain[0, 1, :-1].numpy()).all()


def _forest(seed, t, f, n_bins, depth):
    rng = np.random.default_rng(seed)
    n_int = (1 << depth) - 1
    feat = rng.integers(0, f, (t, n_int)).astype(np.int32)
    thr = rng.integers(0, n_bins, (t, n_int)).astype(np.int32)
    # Leaves at the scale the trainer writes them (v = 0.01 times a mean
    # gradient), so 1e-6 is an absolute bound on the sums.
    leaf = (0.01 * rng.standard_normal((t, 1 << depth))).astype(np.float32)
    return feat, thr, leaf


@pytest.mark.parametrize("t,live,depth", [(24, 24, 4), (24, 13, 5)])
def test_traversal_matches_jax(t, live, depth):
    """Several Pallas tree blocks (tree_block=8), slots past ``live`` masked."""
    n, f, n_bins = 150, 10, 32
    bins = np.random.default_rng(t + live).integers(0, n_bins, (n, f)).astype(np.int32)
    feat, thr, leaf = _forest(depth, t, f, n_bins, depth)
    got = ops.forest_traverse(*_t(bins, feat, thr, leaf), live, depth).numpy()
    j_args = [jnp.asarray(a) for a in (bins, feat, thr, leaf)]
    pallas = jops.forest_traverse(*j_args, jnp.int32(live), depth, backend="pallas",
                                  sample_block=64, tree_block=8)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        got, np.asarray(jref.forest_traverse_ref(*j_args, jnp.int32(live), depth)),
        rtol=1e-6, atol=1e-6,
    )
    # Leaf routing, tree by tree, is exact.
    for k in range(t):
        tt = Tree(*_t(feat[k], thr[k], leaf[k]))
        jt = JTree(*(jnp.asarray(a) for a in (feat[k], thr[k], leaf[k])))
        np.testing.assert_array_equal(
            leaf_indices(tt, torch.from_numpy(bins)).numpy(),
            np.asarray(jleaf_indices(jt, jnp.asarray(bins))),
        )


def test_traversal_masks_stale_slots():
    """Dead slots contribute exactly 0 whatever they hold."""
    n, f, n_bins, depth = 64, 6, 16, 3
    bins = np.random.default_rng(0).integers(0, n_bins, (n, f)).astype(np.int32)
    feat, thr, leaf = _forest(1, 12, f, n_bins, depth)
    stale = leaf.copy()
    stale[5:] = 1e6
    a = ops.forest_traverse(*_t(bins, feat, thr, leaf), 5, depth)
    b = ops.forest_traverse(*_t(bins, feat, thr, stale), 5, depth)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_traversal_plain_is_sequential_sum_of_oracle():
    """The plain version (tree-by-tree sum, the kernel's order) agrees with
    the all-trees-then-reduce oracle."""
    n, f, n_bins, depth = 80, 7, 16, 4
    bins = np.random.default_rng(2).integers(0, n_bins, (n, f)).astype(np.int32)
    args = _t(bins, *_forest(3, 20, f, n_bins, depth))
    np.testing.assert_allclose(
        forest_traversal.forest_traverse_plain(*args, 17, depth).numpy(),
        ref.forest_traverse_ref(*args, 17, depth).numpy(), rtol=1e-6, atol=1e-6,
    )


def _launches(module) -> int:
    """A kernel module's launch count; the traversal counts by form."""
    if module is forest_traversal:
        return sum(forest_traversal.form_launches.values())
    return module.launches


@pytest.mark.parametrize("module,call", [
    (histogram, lambda t: histogram.histogram(
        t((4, 3), torch.int32), t((4,), torch.int32), t((4,)), t((4,)), 2, 8)),
    (split_scan, lambda t: split_scan.split_gain(t((2, 1, 3, 8)), 1.0, 1e-3)),
    (forest_traversal, lambda t: forest_traversal.forest_traverse(
        t((4, 3), torch.int32), t((2, 3), torch.int32), t((2, 3), torch.int32),
        t((2, 4)), 2, 2)),
])
def test_dispatch_is_by_device(module, call):
    """A CPU tensor runs the plain version (no launch counted); any other
    non-CUDA device raises instead of falling back."""
    before = _launches(module)
    call(lambda shape, dtype=torch.float32: torch.zeros(shape, dtype=dtype))
    assert _launches(module) == before
    with pytest.raises(ValueError, match="no kernel"):
        call(lambda shape, dtype=torch.float32: torch.zeros(shape, dtype=dtype,
                                                            device="meta"))
