"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a GPU and skips without one. On a machine with a
card (no JAX needed, hence ``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: histograms and gains rtol 1e-5, atol 1e-5 * max|cell| (the
plain histogram adds with atomics in another order); -inf masks exact;
traversal bitwise (kernel and plain version both sum tree by tree).
"""
import numpy as np
import pytest
import torch

from repro_torch.convert import binned_from_numpy
from repro_torch.core.sgbdt import SGBDTConfig
from repro_torch.kernels import forest_traversal, histogram, split_scan
from repro_torch.ps.engine import Trainer
from repro_torch.trees.binning import bin_dataset
from repro_torch.trees.learner import LearnerConfig

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _close(got, want):
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    fin = torch.isfinite(want)
    scale = float(want[fin].abs().max()) if fin.any() else 1.0
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=1e-5 * scale)


def _case(dev, seed, n, f, n_bins, n_nodes):
    g = torch.Generator(device="cpu").manual_seed(seed)
    bins = torch.randint(0, n_bins, (n, f), generator=g, dtype=torch.int32)
    node = torch.randint(-1, n_nodes, (n,), generator=g, dtype=torch.int32)
    hess = 1.25 * (torch.rand(n, generator=g) < 0.8).float()
    grad = hess * torch.randn(n, generator=g)
    return [t.to(dev) for t in (bins, node, grad, hess)]


@pytest.mark.parametrize("n,f,n_bins,n_nodes", [
    (333, 11, 16, 1), (517, 40, 64, 8), (1000, 33, 256, 4), (64, 3, 64, 256),
])
@pytest.mark.parametrize("subset", [False, True])
def test_histogram_kernel_matches_plain(dev, n, f, n_bins, n_nodes, subset):
    bins, node, grad, hess = _case(dev, n + f, n, f, n_bins, n_nodes)
    active = None
    if subset and n_nodes > 1:
        active = torch.arange(0, n_nodes, 2, dtype=torch.int32, device=dev).flip(0)
    before = histogram.launches
    a = histogram.histogram(bins, node, grad, hess, n_nodes, n_bins, active)
    b = histogram.histogram(bins, node, grad, hess, n_nodes, n_bins, active)
    torch.cuda.synchronize()
    assert histogram.launches == before + 2
    assert torch.equal(a, b), "two launches differ"
    _close(a, histogram.histogram_plain(bins, node, grad, hess, n_nodes, n_bins, active))


@pytest.mark.parametrize("l,f,b", [(1, 5, 16), (8, 40, 64), (3, 7, 100), (2, 9, 256)])
def test_split_gain_kernel_matches_plain(dev, l, f, b):
    bins, node, grad, hess = _case(dev, l * f, 600, f, b, l)
    hist = histogram.histogram(bins, node, grad, hess, l, b)
    got = split_scan.split_gain(hist, 1.0, 1e-3)
    torch.cuda.synchronize()
    _close(got, split_scan.split_gain_plain(hist, 1.0, 1e-3))
    assert torch.isneginf(got[..., -1]).all()


@pytest.mark.parametrize("t,live,depth", [
    (24, 24, 1), (37, 20, 4), (40, 40, 9), (5, 0, 3), (18, 17, 10),
])
def test_forest_traverse_kernel_is_bitwise_plain(dev, t, live, depth):
    g = torch.Generator(device="cpu").manual_seed(t + depth)
    n, f, n_bins = 301, 30, 64
    bins = torch.randint(0, n_bins, (n, f), generator=g, dtype=torch.int32)
    feat = torch.randint(0, f, (t, (1 << depth) - 1), generator=g, dtype=torch.int32)
    thr = torch.randint(0, n_bins, (t, (1 << depth) - 1), generator=g, dtype=torch.int32)
    leaf = 0.01 * torch.randn((t, 1 << depth), generator=g)
    args = [x.to(dev) for x in (bins, feat, thr, leaf)]
    got = forest_traversal.forest_traverse(*args, live, depth)
    torch.cuda.synchronize()
    assert torch.equal(got, forest_traversal.forest_traverse_plain(*args, live, depth))


def test_forest_traverse_kernel_rejects_depth_past_its_limit(dev):
    depth = forest_traversal.MAX_DEPTH + 1
    args = [torch.zeros(s, dtype=dt, device=dev) for s, dt in (
        ((4, 3), torch.int32), ((2, (1 << depth) - 1), torch.int32),
        ((2, (1 << depth) - 1), torch.int32), ((2, 1 << depth), torch.float32))]
    before = forest_traversal.launches
    with pytest.raises(ValueError, match="depth"):
        forest_traversal.forest_traverse(*args, 2, depth)
    assert forest_traversal.launches == before


def test_training_on_the_card_matches_the_cpu(dev):
    """The kernel path and the plain path train the same forest when every
    split is decisive (three thresholded label features, three noise
    features, depth 3), on the same injected draws."""
    rng = np.random.default_rng(0)
    bins = rng.integers(0, 16, (600, 6)).astype(np.int32)
    z = (3.0 * (2 * (bins[:, 0] > 8) - 1) + 1.5 * (2 * (bins[:, 1] > 4) - 1)
         + 0.75 * (2 * (bins[:, 2] > 10) - 1))
    y = (rng.random(600) < 1 / (1 + np.exp(-z))).astype(np.float32)
    cfg = SGBDTConfig(n_trees=8, step_length=0.3,
                      learner=LearnerConfig(depth=3, n_bins=16))
    draws = [(torch.from_numpy((1.25 * rng.binomial(1, 0.8, 600)).astype(np.float32)),
              torch.from_numpy(rng.random(6) < 0.8)) for _ in range(cfg.n_trees)]
    states = {}
    for d in ("cpu", dev):
        data = binned_from_numpy(bins, np.zeros((6, 15)), y, np.ones(600), 16, device=d)
        states[str(d)] = Trainer(cfg, device=d).train(
            data, ("round_robin", 4), seed=0,
            draws=[(m.to(d), k.to(d)) for m, k in draws])
    cpu, card = states["cpu"], states[str(dev)]
    for name in ("feature", "threshold"):
        assert torch.equal(getattr(cpu.forest, name), getattr(card.forest, name).cpu())
    torch.testing.assert_close(card.f.cpu(), cpu.f, rtol=1e-5, atol=1e-5)


def test_training_on_the_card_is_deterministic(dev):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((700, 30)).astype(np.float32)
    y = (x[:, 0] + 0.5 * rng.standard_normal(700) > 0).astype(np.float32)
    data = bin_dataset(x, y, n_bins=64, device=dev)
    cfg = SGBDTConfig(n_trees=6, step_length=0.3,
                      learner=LearnerConfig(depth=6, n_bins=64))
    runs = [Trainer(cfg).train(data, ("round_robin", 3), seed=1) for _ in range(2)]
    for name in ("feature", "threshold", "leaf_value"):
        assert torch.equal(getattr(runs[0].forest, name), getattr(runs[1].forest, name))
    assert torch.equal(runs[0].f, runs[1].f)
