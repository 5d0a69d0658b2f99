"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a GPU and skips without one. On a machine with a
card (no JAX needed, hence ``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: histograms and gains rtol 1e-5, atol 1e-5 * max|cell| (the
plain histogram adds with atomics in another order); -inf masks exact;
traversal bitwise (kernel and plain version both sum tree by tree); the
fused level bitwise against the staged chain of kernels (they share the
device code that fixes every sum's order), and its integer outputs exact
against its plain version. Flash attention against its f32-softmax plain
version: bf16 out atol/rtol 2e-2 (the kernel rounds p to bf16 before
p . v, as the reference kernel does; the plain version does not) and lse
1e-3; f32 out and lse 1e-4; two launches bitwise.
"""
import numpy as np
import pytest
import torch

from repro_torch.convert import binned_from_numpy
from repro_torch.core.sgbdt import SGBDTConfig
from repro_torch.kernels import (
    flash_attention,
    forest_traversal,
    histogram,
    histogram_sparse,
    level_build,
    ops,
    split_scan,
)
from repro_torch.ps.engine import Trainer
from repro_torch.trees.binning import bin_dataset, to_dense
from repro_torch.trees.learner import LearnerConfig, build_tree

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


def _level_case(dev, seed, n, f, n_bins, n_nodes):
    """Samples on every node but the last (which stays empty: the pass-left
    fix), a few on node -1, every other feature masked out."""
    bins, node, grad, hess = _case(dev, seed, n, f, n_bins, n_nodes - 1)
    mask = (torch.arange(f, device=dev) % 2 == 0).to(torch.int32)
    return bins, node, grad, hess, mask


def _staged_chain(bins, node, grad, hess, active, parent, mask, n_nodes, n_bins, derive):
    """The staged level on the card: histogram kernel, parent - built,
    split-gain kernel, masked first-max argmax, partition."""
    if derive:
        built = histogram.histogram(bins, node, grad, hess, n_nodes, n_bins, active)
        ids = torch.arange(n_nodes, device=bins.device)
        par = ids >> 1
        rows = built[:, par]
        hist = torch.where((ids == active[par].long())[None, :, None, None], rows,
                           parent[:, par] - rows)
    else:
        hist = histogram.histogram(bins, node, grad, hess, n_nodes, n_bins)
    gain = split_scan.split_gain(hist, 1.0, 1e-3).masked_fill(
        ~(mask > 0)[None, :, None], float("-inf"))
    flat = gain.reshape(n_nodes, -1)
    idx = torch.argmax(flat, dim=-1)
    best = flat.gather(1, idx[:, None])[:, 0]
    ok = torch.isfinite(best) & (best > 0)
    feat = torch.where(ok, idx // n_bins, 0).to(torch.int32)
    thr = torch.where(ok, idx % n_bins, n_bins - 1).to(torch.int32)
    nc = node.long().clamp(0, n_nodes - 1)
    right = (bins.gather(1, feat.long()[nc][:, None])[:, 0] > thr[nc]).to(torch.int32)
    return hist, feat, thr, best, torch.where(node >= 0, 2 * node + right, 2 * node)


@pytest.mark.parametrize("f", [3, 9, 40])
@pytest.mark.parametrize("n_bins", [16, 64, 256])
@pytest.mark.parametrize("derive", [False, True])
def test_level_build_kernel_matches_plain_and_staged(dev, f, n_bins, derive):
    # About 24 samples a (node, bin): with empty bins two thresholds split
    # alike and tie in exact arithmetic, and the plain version's cumsum
    # (another association on the card) may then pick the other one.
    n_nodes = 8 if derive else 4
    n = 24 * n_bins * n_nodes + 13
    bins, node, grad, hess, mask = _level_case(dev, f * n_bins, n, f, n_bins, n_nodes)
    parent = None
    active = torch.arange(n_nodes, dtype=torch.int32, device=dev)
    if derive:
        active = (2 * torch.arange(n_nodes // 2, device=dev)
                  + torch.arange(n_nodes // 2, device=dev) % 2).to(torch.int32)
        parent = histogram.histogram(bins, node >> 1, grad, hess, n_nodes // 2, n_bins)
    args = (bins, node, grad, hess, active, parent, mask, 1.0, 1e-3, n_nodes, n_bins, derive)
    before = level_build.launches
    got = level_build.level_build(*args)
    again = level_build.level_build(*args)
    torch.cuda.synchronize()
    assert level_build.launches == before + 2
    for a, b in zip(got, again):
        assert torch.equal(a, b), "two launches differ"
    staged = _staged_chain(bins, node, grad, hess, active, parent, mask, n_nodes, n_bins,
                           derive)
    for name, a, b in zip(("hist", "feat", "thr", "best", "new_node"), got, staged):
        assert torch.equal(a, b), f"fused {name} differs from the staged chain"
    plain = level_build.level_build_plain(*args)
    for a, b in zip(got[1:3] + got[4:], plain[1:3] + plain[4:]):
        assert torch.equal(a, b)
    _close(got[0], plain[0])
    _close(got[3], plain[3])
    assert got[1][-1] == 0 and got[2][-1] == n_bins - 1, "empty node must pass left"
    assert bool((got[1] % 2 == 0).all()), "a masked feature won a split"
    assert bool((got[4][node < 0] == -2).all())


def test_fused_learner_is_bitwise_staged_across_a_budget_switch(dev, monkeypatch):
    rng = np.random.default_rng(3)
    n, f, n_bins = 900, 24, 64
    bins = torch.from_numpy(rng.integers(0, n_bins, (n, f)).astype(np.int32)).to(dev)
    h = torch.from_numpy((1.25 * rng.binomial(1, 0.8, n)).astype(np.float32)).to(dev)
    g = h * torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
    mask = torch.from_numpy(rng.random(f) < 0.8).to(dev)
    fused_levels = []
    monkeypatch.setattr(level_build, "fused_level_fits",
                        lambda n, n_nodes, *a: fused_levels.append(n_nodes) or n_nodes <= 4)
    for mode in ("subtract", "rebuild"):
        staged = build_tree(LearnerConfig(depth=5, n_bins=n_bins, hist_mode=mode),
                            bins, g, h, mask)
        before = level_build.launches
        fused = build_tree(LearnerConfig(depth=5, n_bins=n_bins, hist_mode=mode,
                                         backend="fused"), bins, g, h, mask)
        torch.cuda.synchronize()
        assert level_build.launches == before + 3  # levels 0-2 fuse, 3-4 stage
        for a, b in zip(staged, fused):
            assert torch.equal(a, b)


def _sparse_case(dev, seed, n=600, f=50, n_bins=64, n_nodes=8):
    rng = np.random.default_rng(seed)
    x = np.where(rng.random((n, f)) < 0.06, rng.lognormal(size=(n, f)), 0.0)
    data = bin_dataset(x.astype(np.float32), np.zeros(n, np.float32), n_bins=n_bins,
                       device=dev, sparse=True)
    node = torch.from_numpy(rng.integers(-1, n_nodes, n).astype(np.int32)).to(dev)
    hess = torch.from_numpy((1.25 * rng.binomial(1, 0.8, n)).astype(np.float32)).to(dev)
    grad = hess * torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
    return data.bins, node, grad, hess


@pytest.mark.parametrize("subset", [False, True])
def test_histogram_sparse_kernel_matches_plain(dev, subset):
    sp, node, grad, hess = _sparse_case(dev, 5 + subset)
    active = torch.tensor([6, 1, 2, 5], dtype=torch.int32, device=dev) if subset else None
    args = (sp.feat_rows, sp.feat_codes, node, grad, hess, 8, 64, active)
    before = histogram_sparse.launches
    a = histogram_sparse.histogram_sparse(*args)
    b = histogram_sparse.histogram_sparse(*args)
    torch.cuda.synchronize()
    assert histogram_sparse.launches == before + 2
    assert torch.equal(a, b), "two launches differ"
    _close(a, histogram_sparse.histogram_sparse_plain(*args))
    # With the zero-bin complement it is the dense histogram of the same bins.
    dense = to_dense(sp)
    if subset:
        got = ops.build_histogram_subset(sp, node, grad, hess, active, 8, 64)
        want = histogram.histogram(dense, node, grad, hess, 8, 64, active)
    else:
        got = ops.build_histogram(sp, node, grad, hess, 8, 64)
        want = histogram.histogram(dense, node, grad, hess, 8, 64)
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale)


def test_sparse_training_on_the_card_is_deterministic(dev):
    rng = np.random.default_rng(1)
    x = np.where(rng.random((800, 120)) < 0.05, rng.lognormal(size=(800, 120)), 0.0)
    y = (x[:, :10].sum(1) > np.median(x[:, :10].sum(1))).astype(np.float32)
    data = bin_dataset(x.astype(np.float32), y, n_bins=64, device=dev, sparse=True)
    cfg = SGBDTConfig(n_trees=6, step_length=0.3,
                      learner=LearnerConfig(depth=6, n_bins=64))
    before = histogram_sparse.launches
    runs = [Trainer(cfg).train(data, ("round_robin", 3), seed=1) for _ in range(2)]
    assert histogram_sparse.launches > before
    for name in ("feature", "threshold", "leaf_value"):
        assert torch.equal(getattr(runs[0].forest, name), getattr(runs[1].forest, name))
    assert torch.equal(runs[0].f, runs[1].f)


# (b, sq, sk, h, kv, d, causal): the smoke's ragged cases, then more
# ragged edges (Sq != Sk both ways under causal, one query row).
FLASH_CASES = [
    (1, 100, 100, 4, 2, 32, True),
    (1, 100, 100, 4, 2, 80, True),
    (1, 96, 96, 2, 2, 128, False),
    (2, 64, 192, 4, 4, 64, False),
    (2, 64, 192, 4, 4, 64, True),
    (1, 130, 70, 8, 2, 80, True),
    (2, 1, 129, 4, 1, 64, True),
]


def _flash_inputs(dev, b, sq, sk, h, kv, d, dtype, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return [torch.randn(shape, generator=g).to(dev, dtype).transpose(1, 2)
            for shape in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d))]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal", FLASH_CASES)
def test_flash_attention_kernel_matches_plain(dev, b, sq, sk, h, kv, d, causal, dtype):
    q, k, v = _flash_inputs(dev, b, sq, sk, h, kv, d, dtype, sq + sk + d)
    before = flash_attention.launches
    out, lse = flash_attention.flash_attention(q, k, v, causal)
    out2, lse2 = flash_attention.flash_attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 2
    assert torch.equal(out, out2) and torch.equal(lse, lse2), "two launches differ"
    want, want_lse = flash_attention.flash_attention_plain(q, k, v, causal)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    tol = 1e-3 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(lse, want_lse, rtol=tol, atol=tol)


def test_flash_attention_kernel_masks_keys_past_seq_k(dev):
    q, k, v = _flash_inputs(dev, 1, 80, 128, 4, 2, 64, torch.bfloat16, 9)
    out, lse = flash_attention.flash_attention(q, k, v, False, seq_k=77)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 77:], v2[:, :, 77:] = float("nan"), float("nan")
    out2, lse2 = flash_attention.flash_attention(q, k2, v2, False, seq_k=77)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    want, want_lse = flash_attention.flash_attention_plain(q, k, v, False, seq_k=77)
    torch.testing.assert_close(out.float(), want.float(), rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(lse, want_lse, rtol=1e-3, atol=1e-3)


def test_flash_attention_model_layout_entry_point(dev):
    """``ops.flash_attention`` reads (B, S, H, d) in place and returns the
    same layout, contiguous."""
    g = torch.Generator(device="cpu").manual_seed(4)
    q, k, v = (torch.randn(s, generator=g).to(dev, torch.bfloat16)
               for s in ((2, 200, 8, 64), (2, 200, 2, 64), (2, 200, 2, 64)))
    out = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert out.shape == q.shape and out.is_contiguous()
    want = ops.flash_attention(q.cpu(), k.cpu(), v.cpu(), causal=True)
    torch.testing.assert_close(out.cpu().float(), want.float(), rtol=2e-2, atol=2e-2)


def test_flash_attention_kernel_rejects_other_head_dims(dev):
    q, k, v = _flash_inputs(dev, 1, 16, 16, 2, 2, 48, torch.bfloat16, 1)
    before = flash_attention.launches
    with pytest.raises(ValueError, match="head dim"):
        flash_attention.flash_attention(q, k, v)
    assert flash_attention.launches == before
