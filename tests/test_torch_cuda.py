"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a GPU and skips without one. On a machine with a
card (no JAX needed, hence ``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: histograms and gains rtol 1e-5, atol 1e-5 * max|cell| (the
plain histogram adds with atomics in another order); -inf masks exact;
the split gain's decision (best, idx) bitwise the plain chain's
(masked_fill, argmax, gather) on the kernel's own surface;
traversal bitwise in every form, f32 or quantized, one output or K, under
every launch plan (kernel and plain version both dequantize, then sum
tree by tree in slot order); the
fused level bitwise against the staged chain of kernels (they share the
device code that fixes every sum's order), and its integer outputs exact
against its plain version. Flash attention against its f32-softmax plain
version: bf16 out atol/rtol 2e-2 (the kernel rounds p to bf16 before
p . v, as the reference kernel does; the plain version does not) and lse
1e-3; f32 out and lse 1e-4; two launches bitwise. The flash backward
(dq, dk/dv) against its f32 plain version, each tensor on its own:
relative L2 error 1e-2 (bf16) or 1e-4 (f32), and every element within
e (mag + |want|) + 1e-4 x the largest rms of dq, dk and dv, mag the sum
of |term| behind the element: the kernels round p and ds to bf16 before
their products (at most 2^-8 mag) and both versions round the result
(2^-8 |want| each), so bf16 takes e = 2^-7; f32 sums in another order,
e = 3e-5; the floor covers gradients that are zero in exact arithmetic
(one query, one key); two launches bitwise. Model gradients
on the card against the CPU route: f32 rtol 1e-4, atol 1e-5 x the leaf's
largest gradient; bf16 relative L2 error 5e-2 a leaf (bf16 roundings in
other places: cuBLAS against the CPU's GEMMs, kernels against plain
versions).
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.configs as lm_configs
import repro_torch.optim as O
from repro_torch.checkpoint import CheckpointManager
from repro_torch.convert import binned_from_numpy
from repro_torch.core.sgbdt import SGBDTConfig
from repro_torch.kernels import (
    flash_attention,
    flash_plan,
    forest_traversal,
    hist_plan,
    histogram,
    histogram_sparse,
    level_build,
    ops,
    split_scan,
)
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import synthetic_batches
from repro_torch.models import layers as LM
from repro_torch.models import transformer as TT
from repro_torch.optim.optimizers import tree_leaves, tree_map
from repro_torch.ps.engine import Trainer
from repro_torch.serving import ForestEngine, route_hash
from repro_torch.serving.forest_server import (
    ForestServer,
    PredictRequest,
    load_forest_checkpoint,
)
from repro_torch.trees.binning import bin_dataset, to_dense
from repro_torch.trees.forest import Forest, forest_predict, quantization_atol
from repro_torch.trees.learner import (
    LearnerConfig,
    _smaller_children,
    _staged_level,
    build_tree,
)

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


# The launch plan's edges (kernels/hist_plan.py): N not a multiple of any
# chunk size (4001), F not a multiple of the feature tile (70 over tiles of
# 8; 1500 over 8 at realsim's level 0), R = 256 at the full level with most
# rows empty, B = 256 (one 64 KB warp tile a block), realsim width.
@pytest.mark.parametrize("n,f,n_bins,n_nodes", [
    (333, 11, 16, 1), (517, 40, 64, 8), (1000, 33, 256, 4), (64, 3, 64, 256),
    (4001, 70, 64, 1), (2000, 45, 64, 256), (700, 20, 256, 2), (4000, 1500, 64, 1),
])
@pytest.mark.parametrize("subset", [False, True, "every"])
def test_histogram_kernel_matches_plain(dev, n, f, n_bins, n_nodes, subset):
    """subset True: every other node, in reverse, so some samples fall on no
    row; "every": all nodes in reverse, so the rows hold every routed
    sample."""
    bins, node, grad, hess = _case(dev, n + f, n, f, n_bins, n_nodes)
    active = None
    if subset == "every":
        active = torch.arange(n_nodes, dtype=torch.int32, device=dev).flip(0)
    elif subset and n_nodes > 1:
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


def _decide_ok(hist, mask):
    """The decision form twice: two launches bitwise equal, the surface
    within ``_close`` of the plain version and bitwise ``split_gain``'s,
    (best, idx) bitwise the plain chain's on the kernel's own surface.
    Returns (gain, best, idx)."""
    before = split_scan.launches
    a = split_scan.split_gain_decide(hist, 1.0, 1e-3, mask)
    b = split_scan.split_gain_decide(hist, 1.0, 1e-3, mask)
    torch.cuda.synchronize()
    assert split_scan.launches == before + 2
    for x, y in zip(a, b):
        assert torch.equal(x, y), "two launches differ"
    gain, best, idx = a
    assert best.dtype == torch.float32 and idx.dtype == torch.int64
    assert torch.equal(gain, split_scan.split_gain(hist, 1.0, 1e-3))
    _close(gain, split_scan.split_gain_plain(hist, 1.0, 1e-3))
    flat = gain.masked_fill((mask == 0)[None, :, None], float("-inf")).reshape(gain.shape[0], -1)
    want = torch.argmax(flat, dim=-1)
    assert torch.equal(idx, want)
    assert torch.equal(best, flat.gather(1, want[:, None])[:, 0])
    return a


# The surface test's shapes; F not a multiple of a block's 16 rows (a
# node's rows straddle blocks); realsim's level 8; one feature a node, so a
# block's rows span more nodes than its shared table holds.
@pytest.mark.parametrize("l,f,b", [
    (1, 5, 16), (8, 40, 64), (3, 7, 100), (2, 9, 256), (1, 1500, 64), (37, 301, 64),
    (256, 1500, 64), (65536, 1, 16), (5, 33, 33),
])
def test_split_gain_decide_kernel_matches_plain(dev, l, f, b):
    bins, node, grad, hess = _case(dev, l + f + b, 4000, f, b, l)
    hist = histogram.histogram_plain(bins, node, grad, hess, l, b)
    mask = (torch.arange(f, device=dev) % 3 != 1).to(torch.int32)
    _, best, _ = _decide_ok(hist, mask)
    assert torch.isfinite(best).any()


@pytest.mark.parametrize("l,f,feats", [
    (4, 700, (3, 350, 699)),  # in different blocks of each node
    (6, 5, (1, 4)),           # in different nodes of one block
])
def test_split_gain_decide_ties_pick_the_first_cell(dev, l, f, feats):
    """Bitwise-equal maxima (identical rows) at the features ``feats`` of
    every node, every other row without hessian mass (all -inf): the first
    planted feature wins, and the second once the first is masked."""
    b = 64
    gen = torch.Generator(device="cpu").manual_seed(f)
    hist = torch.zeros((2, l, f, b))
    row = torch.randn(b, generator=gen)
    for feat in feats:
        hist[0, :, feat], hist[1, :, feat] = row, 1.25
    hist = hist.to(dev)
    bin_ = int(split_scan.split_gain_plain(hist, 1.0, 1e-3)[0, feats[0]].argmax())
    mask = torch.ones(f, dtype=torch.int32, device=dev)
    _, best, idx = _decide_ok(hist, mask)
    assert idx.tolist() == [feats[0] * b + bin_] * l and torch.isfinite(best).all()
    mask[feats[0]] = 0
    _, _, idx = _decide_ok(hist, mask)
    assert idx.tolist() == [feats[1] * b + bin_] * l


def test_split_gain_decide_on_four_streams_is_the_single_stream_result(dev):
    """4 threads, each on a stream of its own and its own level histogram,
    launch ``split_gain_decide`` 200 times at L = 256 (realsim's level 8):
    every (gain, best, idx) bitwise the single-stream launch's, and the
    launch count exact (each stream keeps its own decision workspace)."""
    import threading

    inputs = []
    for s in range(4):
        bins, node, grad, hess = _case(dev, 90 + s, 4000, 1500, 64, 256)
        hist = histogram.histogram(bins, node, grad, hess, 256, 64)
        mask = (torch.arange(1500, device=dev) % (3 + s) != 1).to(torch.int32)
        inputs.append((hist, mask))
    want = [split_scan.split_gain_decide(h, 1.0, 1e-3, m) for h, m in inputs]
    torch.cuda.synchronize()
    before, bad = split_scan.launches, []

    def body(s):
        with torch.cuda.stream(torch.cuda.Stream()):
            for _ in range(200):
                got = split_scan.split_gain_decide(inputs[s][0], 1.0, 1e-3, inputs[s][1])
                if not all(torch.equal(a, b) for a, b in zip(got, want[s])):
                    bad.append(s)

    threads = [threading.Thread(target=body, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not bad
    assert split_scan.launches - before == 800
    _decide_ok(*inputs[0])


def test_threaded_runtime_replays_bitwise_on_the_card(dev):
    """W = 4 worker threads, a stream each, on realsim-like data at a small
    size: the trace replays to the same forest and F bit for bit, staged and
    fused (the fused level's cooperative launches from four streams)."""
    from repro_torch.ps import AsyncRuntime

    from repro_torch.data import synthetic

    x, y = synthetic.sparse_classification_xy(2000, 300, 12, seed=4)
    data = bin_dataset(x, y, n_bins=64, device=dev)
    for backend in ("staged", "fused"):
        cfg = SGBDTConfig(n_trees=12, step_length=0.3, sampling_rate=0.8,
                          learner=LearnerConfig(depth=5, n_bins=64, backend=backend))
        rt = AsyncRuntime(cfg, data, n_workers=4)
        state, trace = rt.run(seed=0)
        replayed, _ = rt.replay(trace)
        for name in ("feature", "threshold", "leaf_value", "n_trees"):
            assert torch.equal(getattr(state.forest, name), getattr(replayed.forest, name))
        assert torch.equal(state.f, replayed.f)
        assert sorted(trace.key_index.tolist()) == list(range(12))


def test_split_gain_decide_masked_and_empty_nodes(dev):
    """Every feature masked: each node idx 0 and -inf. A node without
    hessian mass (no valid cell) beside nodes that split: idx 0 and -inf."""
    bins, node, grad, hess = _case(dev, 5, 800, 40, 64, 6)
    hist = histogram.histogram(bins, node, grad, hess, 6, 64)
    _, best, idx = _decide_ok(hist, torch.zeros(40, dtype=torch.int32, device=dev))
    assert (idx == 0).all() and torch.isneginf(best).all()
    hist[:, 2] = 0.0
    _, best, idx = _decide_ok(hist, torch.ones(40, dtype=torch.int32, device=dev))
    assert int(idx[2]) == 0 and torch.isneginf(best[2])
    assert torch.isfinite(best[[0, 1, 3, 4, 5]]).all()


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


def _traversal_launches() -> int:
    """The traversal kernel's launches of every form."""
    return sum(forest_traversal.form_launches.values())


def test_forest_traverse_kernel_rejects_depth_past_its_limit(dev):
    depth = forest_traversal.MAX_DEPTH + 1
    args = [torch.zeros(s, dtype=dt, device=dev) for s, dt in (
        ((4, 3), torch.int32), ((2, (1 << depth) - 1), torch.int32),
        ((2, (1 << depth) - 1), torch.int32), ((2, 1 << depth), torch.float32))]
    before = _traversal_launches()
    with pytest.raises(ValueError, match="depth"):
        forest_traversal.forest_traverse(*args, 2, depth)
    assert _traversal_launches() == before


def _stale_forest(dev, seed, n, t, live, depth, k):
    """Bins (N, 30) and a ``Forest`` of ``t`` slots, ``live`` of them live;
    the dead slots hold stale trees (valid feature ids, huge leaves) that
    the mask must hide."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    f, n_bins, n_int = 30, 64, (1 << depth) - 1
    bins = torch.randint(0, n_bins, (n, f), generator=g, dtype=torch.int32)
    feat = torch.randint(0, f, (t, n_int), generator=g, dtype=torch.int32)
    thr = torch.randint(0, n_bins, (t, n_int), generator=g, dtype=torch.int32)
    leaf = 0.01 * torch.randn((t, 1 << depth), generator=g)
    leaf[live:] = 1e6
    base = torch.zeros(()) if k == 1 else torch.zeros(k)
    forest = Forest(feat, thr, leaf, torch.tensor(live, dtype=torch.int32), base)
    return bins.to(dev), Forest(*(x.to(dev) for x in forest))


def _traverse_both(bins, fo):
    """The kernel and the plain version on one forest (f32 or quantized)."""
    args = (bins, fo.feature, fo.threshold, fo.leaf_value, fo.n_trees, fo.depth,
            fo.n_outputs, getattr(fo, "leaf_scale", None))
    got = forest_traversal.forest_traverse(*args)
    torch.cuda.synchronize()
    return got, forest_traversal.forest_traverse_plain(*args)


# Ragged N (not a multiple of any sample tile of kernels/traversal_plan.py),
# live slots not a multiple of K or of a group, stale trees in the dead
# slots, the depth limit; one row; the serving wave's 256 rows at depths 6
# and 9; depth 0 (every tree a single leaf).
@pytest.mark.parametrize("n,t,live,depth", [(301, 37, 20, 4), (17, 45, 44, 9),
                                            (100, 18, 17, 10), (1, 9, 9, 6),
                                            (256, 400, 400, 9), (256, 130, 128, 6),
                                            (1001, 40, 37, 0), (300, 33, 30, 10)])
@pytest.mark.parametrize("k", [1, 2, 3, 5])
@pytest.mark.parametrize("mode", ["f32", "int8", "fp16"])
def test_forest_traverse_forms_are_bitwise_plain(dev, mode, k, n, t, live, depth):
    bins, fo = _stale_forest(dev, n + t + depth, n, t, live, depth, k)
    if mode != "f32":
        fo = fo.quantize(mode)
    key = ("k_" if k > 1 else "") + mode
    before = forest_traversal.form_launches[key]
    got, want = _traverse_both(bins, fo)
    assert forest_traversal.form_launches[key] == before + 1
    assert got.shape == ((n,) if k == 1 else (n, k))
    assert torch.equal(got, want)


def _plans(bins, fo, variant):
    """The plan the wrapper picks, or one variant of it: the tree split off
    (one group), slabs of 64 rows, unstaged rows read from device memory,
    or two chunks' loads in flight. A variant's scratch is at least what it
    needs."""
    from repro_torch.kernels import traversal_plan as tp

    n, f = bins.shape
    slots, lb = fo.feature.shape[0], fo.leaf_value.element_size()
    p = tp.plan(n, f, slots, fo.depth, lb,
                forest_traversal._sms(bins.device))
    if variant == "one_group":
        return tp.shaped(n, f, slots, fo.depth, lb, p.samples, p.threads, 1)
    if variant == "slabs":  # 32-row tiles, two a slab
        return tp.shaped(n, f, slots, fo.depth, lb, 32, 256, 3)._replace(slab=64)
    if variant == "unstaged":
        return p._replace(row_bytes=0)
    if variant == "ahead2":  # two chunks' loads in flight
        return p._replace(ahead=2)
    return p


@pytest.mark.parametrize("variant", ["picked", "one_group", "slabs", "unstaged", "ahead2"])
@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("mode", ["f32", "int8", "fp16"])
def test_forest_traverse_plans_are_bitwise_plain(dev, mode, k, variant):
    """The tree split on and off, rows in several slabs, rows unstaged, one
    or two chunks in flight: each plan's sums equal the plain version's bit
    for bit, two launches alike."""
    bins, fo = _stale_forest(dev, 7 + k, 300, 90, 83, 6, k)
    if mode != "f32":
        fo = fo.quantize(mode)
    p = _plans(bins, fo, variant)
    shape = (300,) if k == 1 else (300, k)
    outs = []
    for _ in range(2):
        out = torch.empty(shape, dtype=torch.float32, device=dev)
        forest_traversal.launch(p, bins, fo.feature, fo.threshold, fo.leaf_value, fo.n_trees,
                                fo.depth, k, getattr(fo, "leaf_scale", None), out)
        outs.append(out)
    torch.cuda.synchronize()
    want = _traverse_both(bins, fo)[1]
    assert torch.equal(outs[0], outs[1]), "two launches differ"
    assert torch.equal(outs[0], want)


@pytest.mark.parametrize("mode", ["f32", "int8", "fp16"])
def test_forest_traverse_bins_past_the_narrow_type(dev, mode):
    """Bins at u8's largest staged value (254), at the sentinel (255), just
    past it (256), negative and huge: each compares as its int32 value."""
    bins, fo = _stale_forest(dev, 11, 257, 50, 50, 6, 1)
    g = torch.Generator(device="cpu").manual_seed(3)
    edge = torch.tensor([0, 1, 126, 127, 128, 253, 254, 255, 256, 300, -1, -300, 2**30],
                        dtype=torch.int32)
    bins = edge[torch.randint(0, len(edge), bins.shape, generator=g)].to(dev)
    top = 127 if mode == "int8" else 300
    thr = torch.randint(-2 if mode == "int8" else 250, top + 1, fo.threshold.shape, generator=g)
    fo = fo._replace(threshold=thr.to(torch.int32).to(dev))
    if mode != "f32":
        fo = fo.quantize(mode)
    got, want = _traverse_both(bins, fo)
    assert torch.equal(got, want)
    assert torch.equal(got, forest_traversal.forest_traverse(bins.clone(), *(
        fo.feature, fo.threshold, fo.leaf_value, fo.n_trees, fo.depth, 1,
        getattr(fo, "leaf_scale", None))))


@pytest.mark.parametrize("mode", ["f32", "int8", "fp16"])
@pytest.mark.parametrize("live", [0, 150])
def test_forest_traverse_k64_and_no_live_tree(dev, mode, live):
    """K = 64 (the limit) over 150 slots, and n_trees 0: every output the
    plain version's, zeros when no slot is live."""
    bins, fo = _stale_forest(dev, 5, 333, 150, 150, 5, 64)
    fo = fo._replace(n_trees=torch.tensor(live, dtype=torch.int32, device=dev))
    if mode != "f32":
        fo = fo.quantize(mode)
    got, want = _traverse_both(bins, fo)
    assert got.shape == (333, 64) and torch.equal(got, want)
    if live == 0:
        assert not got.any()


def test_forest_traverse_kernel_rejects_a_broken_plan(dev):
    """The C entry point checks the plan again: a sample tile that is not a
    multiple of 32, or a scratch too small, launches nothing."""
    bins, fo = _stale_forest(dev, 2, 100, 20, 20, 4, 1)
    p = _plans(bins, fo, "picked")
    out = torch.empty(100, dtype=torch.float32, device=dev)
    before = _traversal_launches()
    for bad in (p._replace(samples=48, threads=96), p._replace(scratch_bytes=16)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            forest_traversal.launch(bad, bins, fo.feature, fo.threshold, fo.leaf_value,
                                    fo.n_trees, fo.depth, 1, None, out)
    assert _traversal_launches() == before


def test_forest_traverse_kernel_rejects_outputs_past_its_limit(dev):
    bins, fo = _stale_forest(dev, 3, 40, 8, 8, 3, 1)
    before = _traversal_launches()
    k = forest_traversal.MAX_OUTPUTS
    ok = forest_traversal.forest_traverse(bins, fo.feature, fo.threshold, fo.leaf_value,
                                          fo.n_trees, 3, k)
    torch.cuda.synchronize()
    assert ok.shape == (40, k) and _traversal_launches() == before + 1
    with pytest.raises(ValueError, match="outputs"):
        forest_traversal.forest_traverse(bins, fo.feature, fo.threshold, fo.leaf_value,
                                         fo.n_trees, 3, k + 1)
    q = fo.quantize("int8")
    with pytest.raises(ValueError, match="leaf_scale"):
        forest_traversal.forest_traverse(bins, q.feature, q.threshold, q.leaf_value,
                                         q.n_trees, 3)
    assert _traversal_launches() == before + 1


def test_quantized_multiclass_serving_on_the_card(dev):
    """``ForestServer(..., objective="multiclass:5", quantize="int8")``
    serves (rows, 5) softmax rows through the kernel, equal to the plain
    version's answer, and the CPU server's."""
    rng = np.random.default_rng(0)
    edges = np.sort(rng.standard_normal((30, 63)).astype(np.float32), axis=1)
    x = rng.standard_normal((300, 30)).astype(np.float32)
    _, fo = _stale_forest("cpu", 9, 1, 50, 45, 6, 5)
    answers = {}
    for d in ("cpu", dev):
        server = ForestServer(fo, torch.from_numpy(edges), max_rows=128,
                              objective="multiclass:5", quantize="int8", device=d)
        before = forest_traversal.form_launches["k_int8"]
        res = server.run([PredictRequest(0, x[:200]), PredictRequest(1, x[200:])])
        answers[str(d)] = np.concatenate([r.scores for r in res])
    assert forest_traversal.form_launches["k_int8"] == before + 3
    assert answers[str(dev)].shape == (300, 5)
    np.testing.assert_allclose(answers[str(dev)], answers["cpu"], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(answers[str(dev)].sum(1), 1.0, atol=1e-5)


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


@pytest.mark.parametrize("level", range(5))
def test_fused_level_is_bitwise_staged_at_realsim_width(dev, level):
    """The fused level at efficiency-realsim width (N 4000, F 1500, B 64) at
    every level that fuses: level 0 and 1 (one row: cut over two blocks) to
    level 4 (eight built rows): every output bitwise the staged level's,
    two launches bitwise."""
    _fused_level_is_staged(dev, level, 4000, 1500)


@pytest.mark.parametrize("level", range(6))
def test_fused_level_is_bitwise_staged_at_multiclass_width(dev, level):
    """The same at the multiclass width (N 4000, F 60, B 64, depth 6): every
    level fuses, and the rows of levels 0-3 are cut over blocks."""
    assert level_build.fused_level_fits(4000, 1 << level, max(1, (1 << level) // 2), 60, 64)
    _fused_level_is_staged(dev, level, 4000, 60)


def _fused_level_is_staged(dev, level, n, f):
    rng = np.random.default_rng(level)
    n_bins = 64
    bins = torch.from_numpy(rng.integers(0, n_bins, (n, f)).astype(np.int32)).to(dev)
    h = torch.from_numpy((1.25 * rng.binomial(1, 0.8, n)).astype(np.float32)).to(dev)
    g = h * torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
    mask = torch.from_numpy(rng.random(f) < 0.8).to(dev)
    n_nodes = 1 << level
    # Every sample on a node, as the learner routes them (samples with h = 0
    # too); the staged level has no rule for node -1.
    node = torch.from_numpy(rng.integers(0, n_nodes, n).astype(np.int32)).to(dev)
    lc = LearnerConfig(depth=9, n_bins=n_bins)
    parent, active = None, torch.zeros(1, dtype=torch.int32, device=dev)
    if level:
        parent = histogram.histogram(bins, node >> 1, g, h, n_nodes // 2, n_bins)
        active = _smaller_children(node, h, n_nodes)
    args = (bins, node, g, h, active, parent, mask.to(torch.int32), lc.lam,
            lc.min_child_hess, n_nodes, n_bins, level > 0)
    fused = level_build.level_build(*args)
    again = level_build.level_build(*args)
    staged = _staged_level(lc, bins, node, g, h, mask, level, parent)
    torch.cuda.synchronize()
    for a, b in zip(fused, again):
        assert torch.equal(a, b), "two launches differ"
    for name, a, b in zip(("hist", "feat", "thr", "new_node"),
                          (fused[0], fused[1], fused[2], fused[4]), staged):
        assert torch.equal(a, b), f"fused {name} differs from the staged level"


def _level_args(dev, seed, n, f, n_bins, level, empty=(), single=()):
    """A subtract level (level 0: the full level) of a seeded case as the
    learner hands it to the fused level; nodes in ``empty`` hold no sample,
    nodes in ``single`` one."""
    n_nodes = 1 << level
    bins, node, grad, hess, mask = _level_case(dev, seed, n, f, n_bins, n_nodes + 1)
    for i, nd in enumerate(single):
        node[node == nd] = (nd + 1) % n_nodes
        node[i] = nd
    for nd in empty:
        node[node == nd] = -1
    parent, active = None, torch.arange(n_nodes, dtype=torch.int32, device=dev)
    if level:
        parent = histogram.histogram(bins, torch.where(node >= 0, node >> 1, -1), grad, hess,
                                     n_nodes // 2, n_bins)
        active = _smaller_children(node, hess, n_nodes)
    return (bins, node, grad, hess, active, parent, mask, 1.0, 1e-3, n_nodes, n_bins,
            level > 0)


@pytest.mark.parametrize("case", ["f61", "f1", "b63", "b256", "empty_and_single"])
@pytest.mark.parametrize("level", [0, 1, 3])
def test_level_build_ragged_shapes(dev, case, level):
    """F 61 (a ragged last feature tile), F 1, B 63 (no 16-byte stores) and
    B 256 (one warp's tile is 64 KB), and nodes with no sample and with one:
    the fused level bitwise the staged chain, two launches bitwise, its
    integer outputs the plain version's."""
    n, f, n_bins = 1500, 20, 64
    empty, single = (), ()
    if case == "f61":
        f = 61
    elif case == "f1":
        f = 1
    elif case == "b63":
        n_bins = 63
    elif case == "b256":
        n_bins = 256
    else:
        empty, single = (0,), ((1 << level) - 1,)
    args = _level_args(dev, level + f + n_bins, n, f, n_bins, level, empty, single)
    got = level_build.level_build(*args)
    again = level_build.level_build(*args)
    bins, node, grad, hess, active, parent, mask, _, _, n_nodes, _, derive = args
    staged = _staged_chain(bins, node, grad, hess, active, parent, mask, n_nodes, n_bins,
                           derive)
    torch.cuda.synchronize()
    for name, a, b, c in zip(("hist", "feat", "thr", "best", "new_node"), got, again, staged):
        assert torch.equal(a, b), f"two launches differ in {name}"
        assert torch.equal(a, c), f"fused {name} differs from the staged chain"
    plain = level_build.level_build_plain(*args)
    _close(got[0], plain[0])
    assert torch.equal(got[4][node < 0], plain[4][node < 0])


@pytest.mark.parametrize("cap", [1, 3, 37])
@pytest.mark.parametrize("shape", ["realsim0", "multiclass0", "multiclass3"])
def test_fused_level_is_bitwise_on_a_capped_grid(dev, monkeypatch, cap, shape):
    """The fused level's persistent grid capped at 1, 3 and 37 blocks (every
    block then takes many items of every phase) gives the bits of the grid
    the card holds at once, and of the staged histogram's chain."""
    f, level = (1500, 0) if shape == "realsim0" else (60, int(shape[-1]))
    args = _level_args(dev, 7, 4000, f, 64, level)
    bins, node, grad, hess, active, _, _, _, _, n_nodes, n_bins, derive = args
    want = level_build.level_build(*args)
    monkeypatch.setattr(level_build, "max_grid", cap)
    got = level_build.level_build(*args)
    staged = histogram.histogram(bins, node, grad, hess, n_nodes, n_bins,
                                 active if derive else None)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    built = active.long() if derive else torch.arange(n_nodes, device=dev)
    assert torch.equal(got[0][:, built], staged)


@pytest.mark.parametrize("n,f,n_bins,n_nodes,subset", [
    (4000, 60, 64, 1, False), (4000, 1500, 64, 1, False), (4000, 60, 64, 8, True),
    (1001, 61, 63, 4, True), (700, 1, 256, 2, False), (4001, 70, 64, 1, False)])
def test_histogram_kernel_sums_in_plan_order(dev, n, f, n_bins, n_nodes, subset):
    """The histogram kernel's bits are the plan's order of adds
    (``hist_plan.plan_order_histogram``): each chunk in ascending sample
    order, the chunks merged in column order, a split row's blocks in
    block order."""
    bins, node, grad, hess = _case(dev, n * f, n, f, n_bins, n_nodes)
    active = (torch.arange(n_nodes - 1, -1, -2, dtype=torch.int32, device=dev)
              if subset else None)
    got = histogram.histogram(bins, node, grad, hess, n_nodes, n_bins, active)
    plan = histogram.launch_plan(bins, n_nodes, n_bins, active)
    want = hist_plan.plan_order_histogram(bins, node, grad, hess, active, n_nodes, n_bins, plan)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _sparse_case(dev, seed, n=600, f=50, n_bins=64, n_nodes=8):
    rng = np.random.default_rng(seed)
    x = np.where(rng.random((n, f)) < 0.06, rng.lognormal(size=(n, f)), 0.0)
    data = bin_dataset(x.astype(np.float32), np.zeros(n, np.float32), n_bins=n_bins,
                       device=dev, sparse=True)
    node = torch.from_numpy(rng.integers(-1, n_nodes, n).astype(np.int32)).to(dev)
    hess = torch.from_numpy((1.25 * rng.binomial(1, 0.8, n)).astype(np.float32)).to(dev)
    grad = hess * torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
    return data.bins, node, grad, hess


def _sparse_edge_case(dev, case, subset):
    """The sparse kernel's edges: many entries of one 32-entry group on the
    same cell (two distinct values, two nodes), a feature with no stored
    entry, codes outside [0, B), B = 256, R = 256."""
    n_bins, n_nodes = 64, 8
    if case == "repeats":
        rng = np.random.default_rng(11)
        x = np.where(rng.random((900, 30)) < 0.5, rng.integers(1, 3, (900, 30)), 0)
        data = bin_dataset(x.astype(np.float32), np.zeros(900, np.float32), n_bins=n_bins,
                           device=dev, sparse=True)
        sp = data.bins
        _, node, grad, hess = _sparse_case(dev, 11, n=900, f=30, n_nodes=2)
        n_nodes = 2
    elif case == "b256":
        n_bins = 256
        sp, node, grad, hess = _sparse_case(dev, 12, n=1500, f=40, n_bins=n_bins)
    elif case == "r256":
        n_nodes = 256
        sp, node, grad, hess = _sparse_case(dev, 13, n=3000, n_nodes=n_nodes)
    else:
        sp, node, grad, hess = _sparse_case(dev, 5 + bool(subset))
    rows, codes = sp.feat_rows, sp.feat_codes
    if case == "all_pad_feature":
        rows = rows.clone()
        rows[7] = -1
    if case == "codes_out_of_range":
        codes = codes.clone()
        codes[::3, ::2] = -3
        codes[1::3, ::2] = n_bins + 5
    active = None
    if subset:
        active = torch.arange(n_nodes - 2, -1, -3, dtype=torch.int32, device=dev)
    return sp, rows, codes, node, grad, hess, n_nodes, n_bins, active


@pytest.mark.parametrize("case", ["random", "repeats", "all_pad_feature",
                                  "codes_out_of_range", "b256", "r256"])
@pytest.mark.parametrize("subset", [False, True])
def test_histogram_sparse_kernel_matches_plain(dev, subset, case):
    sp, rows, codes, node, grad, hess, n_nodes, n_bins, active = _sparse_edge_case(
        dev, case, subset)
    if case == "random" and subset:
        active = torch.tensor([6, 1, 2, 5], dtype=torch.int32, device=dev)
    args = (rows, codes, node, grad, hess, n_nodes, n_bins, active)
    before = histogram_sparse.launches
    a = histogram_sparse.histogram_sparse(*args)
    b = histogram_sparse.histogram_sparse(*args)
    torch.cuda.synchronize()
    assert histogram_sparse.launches == before + 2
    assert torch.equal(a, b), "two launches differ"
    if case == "codes_out_of_range":
        # The plain version takes codes in [0, B) only; an entry whose code
        # is outside adds nothing, as a pad.
        bad = (codes < 0) | (codes >= n_bins)
        plain_args = (torch.where(bad, -1, rows), torch.where(bad, 0, codes)) + args[2:]
    else:
        plain_args = args
    _close(a, histogram_sparse.histogram_sparse_plain(*plain_args))
    if case == "all_pad_feature":
        assert not a[:, :, 7].any()
    if case in ("all_pad_feature", "codes_out_of_range"):
        return
    # With the zero-bin complement it is the dense histogram of the same bins.
    dense = to_dense(sp)
    if subset:
        got = ops.build_histogram_subset(sp, node, grad, hess, active, n_nodes, n_bins)
        want = histogram.histogram(dense, node, grad, hess, n_nodes, n_bins, active)
    else:
        got = ops.build_histogram(sp, node, grad, hess, n_nodes, n_bins)
        want = histogram.histogram(dense, node, grad, hess, n_nodes, n_bins)
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


# (b, sq, sk, h, kv, d, causal, seq_k): the smoke's ragged cases, then more
# ragged edges (Sq != Sk both ways under causal, one query row), then the
# wgmma kernel's (bf16 at d 64 and 128): Sq of 1, 100, 128 and 200 against
# its 128-row q tiles and 128-key tiles, Sq != Sk both ways, causal and
# full, groups of 1 and 4; last, 256 work tiles for its persistent grid of
# 132 blocks (blocks run a second tile), Sq off the tile grid and keys
# past seq_k masked, at d 128 causal and full and d 64 full.
FLASH_CASES = [
    (1, 100, 100, 4, 2, 32, True, None),
    (1, 100, 100, 4, 2, 80, True, None),
    (1, 96, 96, 2, 2, 128, False, None),
    (2, 64, 192, 4, 4, 64, False, None),
    (2, 64, 192, 4, 4, 64, True, None),
    (1, 130, 70, 8, 2, 80, True, None),
    (2, 1, 129, 4, 1, 64, True, None),
    (1, 1, 1, 4, 1, 128, True, None),
    (2, 100, 100, 4, 4, 64, False, None),
    (1, 128, 128, 8, 2, 64, True, None),
    (1, 200, 200, 8, 2, 128, True, None),
    (1, 200, 77, 4, 1, 64, True, None),
    (1, 100, 300, 4, 4, 128, True, None),
    (1, 128, 260, 8, 2, 64, False, None),
    (2, 200, 130, 4, 1, 128, False, None),
    (2, 1000, 1100, 16, 4, 128, True, 950),
    (2, 1000, 1100, 16, 4, 128, False, 1050),
    (2, 1000, 1100, 16, 4, 64, False, 1050),
]
# A bf16 out's relative L2 error limit, whole and over its later half of
# rows (chip_smoke.FLASH_OUT_REL_L2).
FLASH_OUT_REL_L2 = 1e-2


def _flash_inputs(dev, b, sq, sk, h, kv, d, dtype, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return [torch.randn(shape, generator=g).to(dev, dtype).transpose(1, 2)
            for shape in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d))]


def _flash_rel_l2(got, want):
    """The relative L2 errors of an out, whole and on its later half of rows."""
    half = got.shape[2] // 2
    return [float((g.float() - w.float()).norm() / w.float().norm())
            for g, w in ((got, want), (got[:, :, half:], want[:, :, half:]))]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,seq_k", FLASH_CASES)
def test_flash_attention_kernel_matches_plain(dev, b, sq, sk, h, kv, d, causal, seq_k, dtype):
    q, k, v = _flash_inputs(dev, b, sq, sk, h, kv, d, dtype, sq + sk + d)
    before = flash_attention.launches
    route = flash_plan.route(dtype, d)
    before_route = flash_attention.route_launches[route]
    out, lse = flash_attention.flash_attention(q, k, v, causal, seq_k)
    out2, lse2 = flash_attention.flash_attention(q, k, v, causal, seq_k)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 2
    assert flash_attention.route_launches[route] == before_route + 2
    assert torch.equal(out, out2) and torch.equal(lse, lse2), "two launches differ"
    want, want_lse = flash_attention.flash_attention_plain(q, k, v, causal, seq_k)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    if dtype == torch.bfloat16:
        assert max(_flash_rel_l2(out, want)) <= FLASH_OUT_REL_L2
    tol = 1e-3 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(lse, want_lse, rtol=tol, atol=tol)


def test_flash_forward_tolerance_rejects_wrong_outputs(dev):
    """At the prefill shape (B 4, S 2048, H 32/8, d 64, causal) the kernel's
    out passes the element-wise and relative L2 limits, and each of
    ``chip_smoke.flash_planted_faults``' wrong outs (a late key tile's
    p . v with the tile before's V, or dropped; the later rows 3% off)
    fails the relative L2 limit."""
    import chip_smoke

    q, k, v = _flash_inputs(dev, 4, 2048, 2048, 32, 8, 64, torch.bfloat16, 0)
    out, lse = flash_attention.flash_attention(q, k, v, True)
    want = flash_attention.flash_attention_plain(q, k, v, True)[0]
    torch.testing.assert_close(out.float(), want.float(), rtol=2e-2, atol=2e-2)
    assert max(_flash_rel_l2(out, want)) <= FLASH_OUT_REL_L2
    for name, bad in chip_smoke.flash_planted_faults(q, k, v, lse, out).items():
        assert max(_flash_rel_l2(bad, want)) > FLASH_OUT_REL_L2, name


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


@pytest.mark.parametrize("sq,sk,seq_k,d,causal", [
    (80, 128, 77, 128, False), (200, 300, 129, 64, True), (100, 300, 250, 128, True),
    (1, 260, 200, 64, False),
])
def test_flash_attention_wgmma_kernel_masks_keys_past_seq_k(dev, sq, sk, seq_k, d, causal):
    """The wgmma kernel's k and v maps end at seq_k: keys past it load as
    zeros, so NaN there changes no bit."""
    q, k, v = _flash_inputs(dev, 1, sq, sk, 8, 2, d, torch.bfloat16, seq_k)
    before = flash_attention.route_launches["wgmma"]
    out, lse = flash_attention.flash_attention(q, k, v, causal, seq_k=seq_k)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, seq_k:], v2[:, :, seq_k:] = float("nan"), float("nan")
    out2, lse2 = flash_attention.flash_attention(q, k2, v2, causal, seq_k=seq_k)
    torch.cuda.synchronize()
    assert flash_attention.route_launches["wgmma"] == before + 2
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    want, want_lse = flash_attention.flash_attention_plain(q, k, v, causal, seq_k=seq_k)
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


# (b, sq, sk, h, kv, d, causal): tests/test_kernels.py's FLASH_SWEEP, then
# the ragged cases above, then more edges of the backward's wgmma kernels
# (bf16 at d 64 and 128): Sq 130 (lse rows not 16-byte aligned) with
# groups of 4 and keys past seq_k under causal; 256 dq work tiles at d 64
# causal with seq_k < Sk; dk/dv grids of 576 and 288 work tiles on 132
# blocks, the first with key tiles past Sq that have no q tile (zero
# gradients), the second at d 128 with groups of 2.
FLASH_BWD_CASES = [
    (2, 128, 128, 4, 4, 64, True, None),
    (2, 128, 128, 4, 4, 64, False, None),
    (1, 256, 256, 8, 2, 64, True, None),
    (2, 100, 100, 4, 2, 32, True, None),
    (1, 96, 96, 2, 2, 128, False, None),
    (2, 64, 192, 4, 4, 64, False, None),
] + FLASH_CASES + [
    (1, 160, 160, 4, 1, 80, False, None),
    (1, 130, 130, 4, 1, 64, True, None),
    (1, 130, 250, 8, 2, 128, True, 200),
    (2, 1000, 1100, 16, 4, 64, True, 950),
    (4, 600, 1100, 16, 16, 64, True, 1000),
    (2, 1000, 2200, 16, 8, 128, False, 2100),
]


def _bwd_close(got, args, causal, dtype, seq_k=None, one_key=False):
    """dq, dk and dv against the plain version's on ``args`` (q, k, v, out,
    lse, do), each held on its own: a relative L2 error of at most 1e-2
    (bf16) or 1e-4 (f32), and every element within e (mag + |want|) +
    1e-4 x the largest rms of the three, mag the sum of |term| behind the
    element; e = 2^-7 (bf16) or 3e-5 (f32). Where every query sees one key
    (``one_key``), dq and dk are zero in exact arithmetic (ds = p (dp -
    delta) = 0), both versions return f32 noise under the floor, and they
    are held by no relative error."""
    want = flash_attention.flash_attention_bwd_plain(*args, causal, seq_k)
    mag = flash_attention.flash_attention_bwd_magnitudes(*args, causal, seq_k)
    e, rel_tol = (2.0 ** -7, 1e-2) if dtype == torch.bfloat16 else (3e-5, 1e-4)
    floor = 1e-4 * max(float(w.float().square().mean().sqrt()) for w in want)
    for name, g, w, m in zip(("dq", "dk", "dv"), got, want, mag):
        g, w = g.float(), w.float()
        err, limit = (g - w).abs(), e * (m + w.abs()) + floor
        assert torch.isfinite(g).all() and bool((err <= limit).all()), \
            f"{name}: |error| up to {float((err / limit).max())} x its limit"
        if not (one_key and name != "dv"):
            rel = float((g - w).norm() / w.norm())
            assert rel <= rel_tol, f"{name}: relative L2 error {rel}"


def _bwd_case(dev, b, sq, sk, h, kv, d, causal, dtype, seed, seq_k=None):
    q, k, v = _flash_inputs(dev, b, sq, sk, h, kv, d, dtype, seed)
    out, lse = flash_attention.flash_attention(q, k, v, causal, seq_k)
    g = torch.Generator(device="cpu").manual_seed(seed + 1)
    do = torch.randn((b, sq, h, d), generator=g).to(dev, dtype).transpose(1, 2)
    return q, k, v, out, lse, do


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,seq_k", FLASH_BWD_CASES)
def test_flash_bwd_kernels_match_plain(dev, b, sq, sk, h, kv, d, causal, seq_k, dtype):
    args = _bwd_case(dev, b, sq, sk, h, kv, d, causal, dtype, sq + sk + d, seq_k)
    before = flash_attention.bwd_launches
    route = flash_plan.route(dtype, d)
    before_route = flash_attention.bwd_route_launches[route]
    got = flash_attention.flash_attention_bwd(*args, causal, seq_k)
    again = flash_attention.flash_attention_bwd(*args, causal, seq_k)
    torch.cuda.synchronize()
    assert flash_attention.bwd_launches == before + 2
    assert flash_attention.bwd_route_launches[route] == before_route + 2
    for name, g1, g2, t in zip(("dq", "dk", "dv"), got, again, args[:3]):
        assert g1.shape == t.shape and g1.dtype == dtype, name
        assert torch.equal(g1, g2), f"{name}: two launches differ"
    _bwd_close(got, args, causal, dtype, seq_k, one_key=causal and sq == 1)


def test_flash_bwd_tolerance_rejects_wrong_gradients(dev):
    """``_bwd_close`` at the training shape (B 4, S 2048, H 32/8, d 64,
    causal): the kernels pass, and each of these wrong results fails: dq
    zeroed past query 300, dq scaled by 0.97, dk zeroed past key 1024, and
    dq without the keys more than 1024 behind each query. The gradients
    come from the wgmma kernels, the route of bf16 at d 64."""
    args = _bwd_case(dev, 4, 2048, 2048, 32, 8, 64, True, torch.bfloat16, 0)
    before = flash_attention.bwd_route_launches["wgmma"]
    dq, dk, dv = flash_attention.flash_attention_bwd(*args, True)
    assert flash_attention.bwd_route_launches["wgmma"] == before + 1
    _bwd_close((dq, dk, dv), args, True, torch.bfloat16)
    q, k, v, out, lse, do = args
    scale = 64 ** -0.5
    kf, vf = (t.float().repeat_interleave(4, dim=1) for t in (k, v))
    far = torch.ones((2048, 2048), dtype=torch.bool, device=dev).tril(-1024)
    p = torch.where(far, torch.exp(q.float() @ kf.transpose(-1, -2) * scale - lse[..., None]),
                    0.0)
    delta = (do.float() * out.float()).sum(-1, keepdim=True)
    p *= do.float() @ vf.transpose(-1, -2) - delta  # ds of the far keys
    dq_near = (dq.float() - scale * p @ kf).to(dq.dtype)
    del p
    zeroed_dq, zeroed_dk = dq.clone(), dk.clone()
    zeroed_dq[:, :, 300:], zeroed_dk[:, :, 1024:] = 0, 0
    for bad in ((zeroed_dq, dk, dv), ((dq.float() * 0.97).to(dq.dtype), dk, dv),
                (dq, zeroed_dk, dv), (dq_near, dk, dv)):
        with pytest.raises(AssertionError):
            _bwd_close(bad, args, True, torch.bfloat16)


def test_flash_bwd_kernels_mask_keys_past_seq_k(dev):
    q, k, v, out, lse, do = _bwd_case(dev, 1, 80, 128, 4, 2, 64, False, torch.bfloat16, 9,
                                      seq_k=77)
    dq, dk, dv = flash_attention.flash_attention_bwd(q, k, v, out, lse, do, False, 77)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 77:], v2[:, :, 77:] = float("nan"), float("nan")
    dq2, dk2, dv2 = flash_attention.flash_attention_bwd(q, k2, v2, out, lse, do, False, 77)
    torch.cuda.synchronize()
    assert torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2)
    assert not dk[:, :, 77:].any() and not dv[:, :, 77:].any()
    _bwd_close((dq, dk, dv), (q, k, v, out, lse, do), False, torch.bfloat16, seq_k=77)


def test_flash_bwd_rejects_what_no_kernel_takes(dev):
    """A CUDA tensor of a head dim or dtype that no backward kernel takes
    raises; nothing is launched or counted."""
    before = flash_attention.bwd_launches
    for d, dtype, err in ((48, torch.bfloat16, ValueError), (64, torch.float16, TypeError)):
        q, k, v = _flash_inputs(dev, 1, 16, 16, 2, 2, d, dtype, 1)
        out, do = torch.zeros_like(q), torch.zeros_like(q)
        lse = torch.zeros((1, 2, 16), device=dev)
        with pytest.raises(err):
            flash_attention.flash_attention_bwd(q, k, v, out, lse, do)
    assert flash_attention.bwd_launches == before


def test_flash_bwd_takes_a_strided_do(dev):
    """A do whose last dimension is strided is made contiguous; the result
    is the same."""
    args = list(_bwd_case(dev, 1, 64, 64, 2, 2, 64, True, torch.bfloat16, 5))
    want = flash_attention.flash_attention_bwd(*args)
    do = args[5]
    args[5] = torch.empty((*do.shape, 2), dtype=do.dtype, device=dev)[..., 0].copy_(do)
    assert args[5].stride(-1) != 1
    got = flash_attention.flash_attention_bwd(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_flash_at_zamba2s_group_1(dev):
    """zamba2's shared block (B 4, S 2048, 32 q heads on 32 kv heads, d 64,
    bf16, causal): the forward and the backward on the wgmma routes, each
    against its plain version with the tolerances above."""
    args = _bwd_case(dev, 4, 2048, 2048, 32, 32, 64, True, torch.bfloat16, 27)
    q, k, v, out, lse, do = args
    want, want_lse = flash_attention.flash_attention_plain(q, k, v, True)
    torch.testing.assert_close(out.float(), want.float(), rtol=2e-2, atol=2e-2)
    assert max(_flash_rel_l2(out, want)) <= FLASH_OUT_REL_L2
    torch.testing.assert_close(lse, want_lse, rtol=1e-3, atol=1e-3)
    before = dict(flash_attention.bwd_route_launches)
    got = flash_attention.flash_attention_bwd(*args, True)
    torch.cuda.synchronize()
    assert flash_attention.bwd_route_launches["wgmma"] == before["wgmma"] + 1
    _bwd_close(got, args, True, torch.bfloat16)


def _zamba2(dtype: str, **changes):
    return dataclasses.replace(lm_configs.get("zamba2-1.2b").reduced(), attn_impl="flash",
                               dtype=dtype, **changes)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_forward_train_gradients_on_the_card(dev, dtype):
    """Reduced zamba2 with a tail layer (2 groups of 2, tail 1): the loss
    and every gradient on the card against the CPU route; one flash
    backward a group; a_log and dt_bias gradients f32."""
    cfg = _zamba2(dtype, n_layers=5)
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = next(synthetic_batches(cfg, 2, 64, 1, seed=3, device="cpu"))
    results = []
    for device in ("cpu", dev):
        p = tree_map(lambda t: t.detach().to(device).requires_grad_(), params)
        before = flash_attention.bwd_launches
        loss, _ = TT.forward_train(p, cfg, {k: v.to(device) for k, v in batch.items()})
        grads = torch.autograd.grad(loss, tree_leaves(p))
        results.append((loss, grads))
        if device != "cpu":
            assert flash_attention.bwd_launches == before + 2
    (l_cpu, g_cpu), (l_dev, g_dev) = results
    torch.testing.assert_close(l_dev.detach().float().cpu(), l_cpu.detach().float(),
                               rtol=1e-4 if dtype == "float32" else 2e-2, atol=0)
    names = []
    TT.map_schema(lambda path, _: names.append(".".join(path)), TT.param_schema(cfg))
    for name, a, b in zip(names, g_dev, g_cpu):
        if name.endswith(("a_log", "dt_bias")):
            assert a.dtype == torch.float32, name
        _grad_close(a, b, dtype, name)


def test_hybrid_prefill_and_decode_on_the_card(dev):
    """Reduced zamba2 in f32: prefill and 4 decode steps on the card against
    the CPU route, the caches written in place on the card."""
    cfg = _zamba2("float32", n_layers=5)
    params = TT.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 36), generator=torch.Generator().manual_seed(2),
                         dtype=torch.int32)
    out = []
    for device in ("cpu", dev):
        p = tree_map(lambda t: t.to(device), params)
        logits, cache = TT.prefill(p, cfg, {"tokens": toks[:, :32].to(device)}, max_len=40)
        steps = [logits]
        for i in range(32, 36):
            logits, cache = TT.decode_step(p, cfg, toks[:, i:i + 1].to(device), cache)
            steps.append(logits)
        out.append(([x.cpu() for x in steps], {n: cache[n].cpu() for n in ("ssm", "conv")}))
    (l_cpu, c_cpu), (l_dev, c_dev) = out
    for a, b in zip(l_dev, l_cpu):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    for n in c_cpu:
        torch.testing.assert_close(c_dev[n], c_cpu[n], rtol=1e-4, atol=1e-4)


def test_xlstm_bf16_prefill_and_decode_on_the_card(dev):
    """Reduced xlstm-1.3b in bf16 (2 groups of one mLSTM and one sLSTM
    layer): a 32-token prefill (two chunks) and 4 decode steps on the card
    against the CPU route, by relative L2 a tensor (5e-2, as the bf16
    gradients above: bf16 roundings in other places), the carries written
    in place on the card, C and n bf16, m f32."""
    cfg = dataclasses.replace(lm_configs.get("xlstm-1.3b").reduced(), dtype="bfloat16")
    params = TT.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 36), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(2))
    out = []
    for device in ("cpu", dev):
        p = tree_map(lambda t: t.to(device), params)
        logits, cache = TT.prefill(p, cfg, {"tokens": toks[:, :32].to(device)})
        steps = [logits]
        for i in range(32, 36):
            logits, cache = TT.decode_step(p, cfg, toks[:, i:i + 1].to(device), cache)
            steps.append(logits)
        out.append(([x.float().cpu() for x in steps],
                    {f"{k}.{n}": t.cpu() for k in ("mlstm", "slstm")
                     for n, t in cache[k].items()}))
    (l_cpu, c_cpu), (l_dev, c_dev) = out
    for i, (a, b) in enumerate(zip(l_dev, l_cpu)):
        assert float((a - b).norm() / b.norm()) <= 5e-2, f"logits {i}"
    for n in c_cpu:
        assert c_dev[n].dtype == (torch.float32 if n.endswith(".m") else torch.bfloat16), n
        a, b = c_dev[n].float(), c_cpu[n].float()
        assert float((a - b).norm() / b.norm()) <= 5e-2, n


def _granite(dtype: str, **changes):
    return dataclasses.replace(lm_configs.get("granite-3-2b").reduced(), attn_impl="flash",
                               dtype=dtype, **changes)


def _grad_close(got, want, dtype: str, name: str):
    got, want = got.float().cpu(), want.float()
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * float(want.abs().max()),
                                   msg=name)
    else:
        rel = float((got - want).norm() / want.norm())
        assert rel <= 5e-2, f"{name}: relative L2 error {rel}"


@pytest.mark.parametrize("kv", [4, 2])
def test_flash_layer_gradient_reaches_wq_on_the_card(dev, kv):
    """The detached-gradient fault: on the card ``ops.flash_attention``
    returned no grad_fn, so wq, wk and wv got no gradient through attention.
    Their gradients through a flash layer now equal the CPU route's."""
    cfg = _granite("float32", n_kv_heads=kv)
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    p_cpu = TT.layer(params["layers"], 0)["attn"]
    x = torch.randn((2, 96, cfg.d_model), generator=torch.Generator().manual_seed(1))
    grads = []
    for device in ("cpu", dev):
        p = {k: v.detach().to(device).requires_grad_() for k, v in p_cpu.items()}
        out = LM.self_attention_train(p, x.to(device), cfg, 96)
        assert out.grad_fn is not None
        grads.append(torch.autograd.grad(out.square().sum(), [p[k] for k in sorted(p)]))
    for name, g_cpu, g_dev in zip(sorted(p_cpu), *grads):
        assert g_dev.abs().max() > 0, name
        _grad_close(g_dev, g_cpu, "float32", name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_train_gradients_on_the_card(dev, dtype):
    cfg = _granite(dtype, n_kv_heads=2)
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = next(synthetic_batches(cfg, 2, 128, 1, seed=3, device="cpu"))
    results = []
    for device in ("cpu", dev):
        p = tree_map(lambda t: t.detach().to(device).requires_grad_(), params)
        before = flash_attention.bwd_launches
        loss, _ = TT.forward_train(p, cfg, {k: v.to(device) for k, v in batch.items()})
        grads = torch.autograd.grad(loss, tree_leaves(p))
        results.append((loss, grads))
        if device != "cpu":
            assert flash_attention.bwd_launches == before + cfg.n_layers
    (l_cpu, g_cpu), (l_dev, g_dev) = results
    torch.testing.assert_close(l_dev.detach().float().cpu(), l_cpu.detach().float(),
                               rtol=1e-4 if dtype == "float32" else 2e-2, atol=0)
    names = []
    TT.map_schema(lambda path, _: names.append(".".join(path)), TT.param_schema(cfg))
    for name, a, b in zip(names, g_dev, g_cpu):
        _grad_close(a, b, dtype, name)


def test_train_step_accum_2_on_the_card(dev):
    """One AdamW-recipe step at accum 2: parameters against the CPU route
    (within 5e-5 for 99.9% of each leaf and 2 x lr for all: Adam's first
    step is lr x sign(g), see tests/test_torch_lm_train.py)."""
    cfg = _granite("float32")
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = next(synthetic_batches(cfg, 4, 64, 1, seed=1, device="cpu"))
    out = []
    for device in ("cpu", dev):
        p = tree_map(lambda t: t.detach().clone().to(device), params)
        opt = O.adamw(O.cosine_schedule(5e-3, 1, 3), weight_decay=0.01, max_grad_norm=1.0)
        step = make_train_step(cfg, opt, accum=2)
        p, _, m = step(p, opt.init(p), {k: v.to(device) for k, v in batch.items()})
        out.append((float(m["loss"]), [t.detach().cpu() for t in tree_leaves(p)]))
    (l_cpu, p_cpu), (l_dev, p_dev) = out
    assert abs(l_dev - l_cpu) <= 1e-5 * abs(l_cpu)
    for a, b in zip(p_dev, p_cpu):
        diff = (a - b).abs()
        assert float((diff > 5e-5).float().mean()) <= 1e-3
        assert float(diff.max()) <= 2 * 5e-3


def test_dots_remat_gradients_are_bitwise_full_on_the_card(dev):
    """remat_policy="dots" recomputes with the same kernels in the same
    order as "full" (the flash forward too: 2 x L forward and L backward
    launches either way), so loss and gradients are bitwise equal."""
    cfg = _granite("bfloat16", n_kv_heads=2)
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = next(synthetic_batches(cfg, 2, 128, 1, seed=3, device=dev))
    p = tree_map(lambda t: t.detach().to(dev).requires_grad_(), params)
    out = []
    for policy in ("full", "dots"):
        fwd, bwd = flash_attention.launches, flash_attention.bwd_launches
        loss, _ = TT.forward_train(p, dataclasses.replace(cfg, remat_policy=policy), batch)
        grads = torch.autograd.grad(loss, tree_leaves(p))
        assert flash_attention.launches - fwd == 2 * cfg.n_layers
        assert flash_attention.bwd_launches - bwd == cfg.n_layers
        out.append((loss.detach(), grads))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_packed_forward_train_gradients_on_the_card(dev):
    """Packed rows with pad tails under attn_impl="flash" on the card take
    the chunked attention (no flash launch); loss and gradients are finite
    and within bf16 tolerance of the f32 CPU route on the same weights."""
    cfg = _granite("bfloat16", n_kv_heads=2, attn_chunk=48)
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = next(synthetic_batches(cfg, 2, 128, 1, seed=3, device="cpu"))
    batch["segments"] = torch.tensor([[1] * 50 + [2] * 60 + [0] * 18,
                                      [1] * 90 + [2] * 30 + [0] * 8], dtype=torch.int32)
    results = []
    for device, c in (("cpu", dataclasses.replace(cfg, dtype="float32")), (dev, cfg)):
        p = tree_map(lambda t: t.detach().to(device, getattr(torch, c.dtype)).requires_grad_(),
                     params)
        before = flash_attention.launches, flash_attention.bwd_launches
        loss, _ = TT.forward_train(p, c, {k: v.to(device) for k, v in batch.items()})
        grads = torch.autograd.grad(loss, tree_leaves(p))
        assert (flash_attention.launches, flash_attention.bwd_launches) == before
        results.append((loss.detach(), grads))
    (l_cpu, g_cpu), (l_dev, g_dev) = results
    assert torch.isfinite(l_dev) and all(torch.isfinite(g).all() for g in g_dev)
    torch.testing.assert_close(l_dev.float().cpu(), l_cpu, rtol=2e-2, atol=0)
    names = []
    TT.map_schema(lambda path, _: names.append(".".join(path)), TT.param_schema(cfg))
    for name, a, b in zip(names, g_dev, g_cpu):
        _grad_close(a, b, "bfloat16", name)


def _moe(dtype: str, **changes):
    return dataclasses.replace(lm_configs.get("phi3.5-moe-42b").reduced(), attn_impl="flash",
                               dtype=dtype, **changes)


def test_moe_router_breaks_a_planted_tie_on_the_card(dev):
    """Logits exact in f32 (small integers over 64) with experts 1 and 3
    tied for every token: the card's ids are the CPU's (the lower expert
    first), the weights and aux within 1e-6."""
    cfg = _moe("float32")
    g = torch.Generator().manual_seed(5)
    x = torch.randint(-2, 3, (256, cfg.d_model), generator=g).float()
    wr = torch.randint(-4, 5, (cfg.d_model, cfg.n_experts), generator=g).float() / 64
    wr[:, 3] = wr[:, 1]
    want = LM._router({"wr": wr}, x, cfg)
    got = LM._router({"wr": wr.to(dev)}, x.to(dev), cfg)
    assert torch.equal(got[1].cpu(), want[1])
    assert ((want[1][:, 0] == 1) & (want[1][:, 1] == 3)).any()
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=0, atol=1e-6)
    assert abs(float(got[2]) - float(want[2])) <= 1e-6


@pytest.mark.parametrize("top_k", [2, 4])
def test_moe_dispatch_and_combine_on_the_card(dev, top_k):
    """With the CPU's ids and weights, every expert's dispatch on the card
    is the CPU's bit for bit; the expert block agrees with the CPU's in f32
    and repeats bitwise (at top-4 too: a row takes one add an expert)."""
    cfg = _moe("float32", n_experts=8, top_k=top_k)
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    p = TT.layer(params["layers"], 0)["moe"]
    x = torch.randn((300, cfg.d_model), generator=torch.Generator().manual_seed(1))
    weights, ids, _ = LM._router(p, x, cfg)
    cap = LM.moe_capacity(cfg, 300)
    got = LM.expert_dispatch(ids.to(dev), weights.to(dev), cfg.n_experts, cap)
    want = LM.expert_dispatch(ids, weights, cfg.n_experts, cap)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    pd = {k: v.to(dev) for k, v in p.items()}
    args = (x.to(dev), ids.to(dev), weights.to(dev), pd["wg"], pd["wu"], pd["wd"], 0, cap)
    out = LM._expert_block(*args)
    assert torch.equal(out, LM._expert_block(*args))
    want = LM._expert_block(x, ids, weights, p["wg"], p["wu"], p["wd"], 0, cap)
    torch.testing.assert_close(out.cpu(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_forward_train_gradients_on_the_card(dev, dtype):
    """Reduced phi3.5-moe: loss, aux and every gradient on the card against
    the CPU route (routing compared: the same ids at f32); "dots" bitwise
    "full" on the card; 2 x L forward and L backward flash launches."""
    cfg = _moe(dtype)
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = next(synthetic_batches(cfg, 2, 64, 1, seed=3, device="cpu"))
    results = []
    for device, policy in (("cpu", "full"), (dev, "full"), (dev, "dots")):
        p = tree_map(lambda t: t.detach().to(device).requires_grad_(), params)
        c = dataclasses.replace(cfg, remat_policy=policy)
        fwd, bwd = flash_attention.launches, flash_attention.bwd_launches
        loss, m = TT.forward_train(p, c, {k: v.to(device) for k, v in batch.items()})
        grads = torch.autograd.grad(loss, tree_leaves(p))
        results.append((loss.detach(), m["aux"].detach(), grads))
        if device != "cpu":
            assert flash_attention.launches - fwd == 2 * cfg.n_layers
            assert flash_attention.bwd_launches - bwd == cfg.n_layers
    (l_cpu, a_cpu, g_cpu), (l_dev, a_dev, g_dev), (l_dots, _, g_dots) = results
    assert torch.equal(l_dots, l_dev) and all(torch.equal(a, b) for a, b in zip(g_dots, g_dev))
    torch.testing.assert_close(l_dev.float().cpu(), l_cpu.float(),
                               rtol=1e-4 if dtype == "float32" else 2e-2, atol=0)
    if dtype == "float32":
        assert abs(float(a_dev) - float(a_cpu)) <= 1e-5
    names = []
    TT.map_schema(lambda path, _: names.append(".".join(path)), TT.param_schema(cfg))
    for name, a, b in zip(names, g_dev, g_cpu):
        _grad_close(a, b, dtype, name)


def test_moe_prefill_and_decode_on_the_card(dev):
    """Reduced phi3.5-moe in f32: prefill (capacity rule) and 4 decode steps
    (every token kept) on the card against the CPU route, the ring written
    in place on the card."""
    cfg = _moe("float32")
    params = TT.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 36), generator=torch.Generator().manual_seed(2),
                         dtype=torch.int32)
    out = []
    for device in ("cpu", dev):
        p = tree_map(lambda t: t.to(device), params)
        logits, cache = TT.prefill(p, cfg, {"tokens": toks[:, :32].to(device)}, max_len=40)
        steps = [logits]
        for i in range(32, 36):
            logits, cache = TT.decode_step(p, cfg, toks[:, i:i + 1].to(device), cache)
            steps.append(logits)
        out.append(([x.cpu() for x in steps], {n: cache["self"][n].cpu() for n in ("k", "v")}))
    (l_cpu, c_cpu), (l_dev, c_dev) = out
    for a, b in zip(l_dev, l_cpu):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    for n in c_cpu:
        torch.testing.assert_close(c_dev[n], c_cpu[n], rtol=1e-4, atol=1e-4)


def _swap_setup(dev, root):
    """A depth-5 forest trained 8 rounds on the card, checkpointed (as a
    TrainState) at rounds 4 and 8, with its raw rows and edges."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1500, 30)).astype(np.float32)
    y = (x[:, :5].sum(1) > 0).astype(np.float32)
    data = bin_dataset(x, y, n_bins=64, device=dev)
    cfg = SGBDTConfig(n_trees=8, step_length=0.2, learner=LearnerConfig(depth=5, n_bins=64))
    mgr = CheckpointManager(root, save_every=4, keep=4)
    state = Trainer(cfg, device=dev).train(data, ("round_robin", 2), seed=0, eval_every=1,
                                           eval_fn=lambda st, j: mgr.maybe_save(j, st))
    return x, data, state


@pytest.mark.parametrize("quantize", [None, "int8", "fp16"])
def test_hot_swap_reload_on_the_card(dev, tmp_path, quantize):
    """A server on the round-4 checkpoint reloads round 8 onto the card:
    the installed forest is the trained one (packed when quantized), and
    its answers are bitwise a fresh server's on that forest."""
    x, data, state = _swap_setup(dev, tmp_path)
    half = load_forest_checkpoint(tmp_path, 4, like=state.forest, device=dev)
    assert half.feature.device.type == "cuda" and int(half.n_trees) == 4
    server = ForestServer(half, data.bin_edges, ckpt_root=tmp_path, max_rows=256,
                          model_step=4, quantize=quantize, device=dev)
    reqs = [PredictRequest(uid=i, x=x[100 * i: 100 * i + 37 * (i + 1)]) for i in range(6)]
    first = server.run(reqs[:3])  # run polls first: the swap lands before wave one
    assert {r.model_step for r in first} == {8}
    want = state.forest.quantize(quantize) if quantize else state.forest
    for name in want._fields:
        assert torch.equal(getattr(server.forest, name), getattr(want, name)), name
    fresh = ForestServer(state.forest, data.bin_edges, max_rows=256, model_step=8,
                         quantize=quantize, device=dev)
    for a, b in zip(server.run(reqs), fresh.run(reqs)):
        assert a.model_step == b.model_step == 8 and np.array_equal(a.scores, b.scores)


def test_engine_int8_version_on_the_card(dev, tmp_path):
    """ForestEngine with an f32 and an int8 version of the same forest:
    routed by route_hash, int8 scores within quantization_atol + 1e-6."""
    x, data, state = _swap_setup(dev, tmp_path)
    eng = ForestEngine(data.bin_edges, max_rows=256, slo_s=10.0, device=dev)
    eng.add_version("f32", state.forest, model_step=8)
    eng.add_version("q8", state.forest, model_step=8, quantize="int8", weight=3.0)
    reqs = [PredictRequest(uid=i, x=x[50 * i: 50 * i + 50]) for i in range(24)]
    routed = {r.uid: eng.submit(r) for r in reqs}
    outs = sorted(eng.flush(), key=lambda r: r.uid)
    assert [r.uid for r in outs] == list(range(24))
    atol = quantization_atol(state.forest, state.forest.quantize("int8"))
    for r in outs:
        assert r.version == routed[r.uid] == ("f32" if route_hash(r.uid) < 0.25 else "q8")
        want = forest_predict(state.forest, data.bins[50 * r.uid: 50 * r.uid + 50])
        np.testing.assert_allclose(r.scores, want.cpu().numpy(), rtol=0, atol=atol + 1e-6)


# ------------------------------------------------------- the media families
@pytest.mark.parametrize("b,s,h,kv,d", [(4, 2048, 64, 8, 128), (8, 64, 12, 12, 64),
                                        (8, 320, 12, 12, 64), (8, 448, 12, 12, 64)],
                         ids=["vlm", "whisper64", "whisper320", "whisper448"])
def test_flash_at_the_media_shapes(dev, b, s, h, kv, d):
    """The VLM's self layers (64 q heads on 8 kv heads, d 128: group 8) and
    whisper's decoder (12 on 12, d 64) at its serving prompts (one partial
    key tile; 2.5 tiles) and its training rows (3.5 tiles), bf16, causal:
    the forward and the backward on the wgmma routes, each against its
    plain version with the tolerances above."""
    args = _bwd_case(dev, b, s, s, h, kv, d, True, torch.bfloat16, s + h)
    q, k, v, out, lse, do = args
    want, want_lse = flash_attention.flash_attention_plain(q, k, v, True)
    torch.testing.assert_close(out.float(), want.float(), rtol=2e-2, atol=2e-2)
    assert max(_flash_rel_l2(out, want)) <= FLASH_OUT_REL_L2
    torch.testing.assert_close(lse, want_lse, rtol=1e-3, atol=1e-3)
    before = dict(flash_attention.bwd_route_launches)
    got = flash_attention.flash_attention_bwd(*args, True)
    torch.cuda.synchronize()
    assert flash_attention.bwd_route_launches["wgmma"] == before["wgmma"] + 1
    _bwd_close(got, args, True, torch.bfloat16)


def _media_cfg(arch: str, dtype: str):
    changes = {"n_layers": 6, "cross_attn_every": 3} if arch.startswith("llama") else {}
    return dataclasses.replace(lm_configs.get(arch).reduced(), attn_impl="flash", dtype=dtype,
                               **changes)


def _media_params(cfg):
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    if cfg.family == "vlm":
        params["groups"]["cross"]["gate_attn"].fill_(0.5)
        params["groups"]["cross"]["gate_mlp"].fill_(-0.3)
    return params


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b", "whisper-small"])
def test_media_forward_train_gradients_on_the_card(dev, arch, dtype):
    """Reduced VLM (2 groups of 2 self layers + 1 cross, gates non-zero) and
    whisper: the loss and every gradient on the card against the CPU route;
    2 x L forward and L backward flash launches (L the self-attention
    layers, under per-group or per-layer remat). A bf16 gate's gradient is
    one sum over every (row, token, channel) product of its layer's output,
    so its relative error is that of a sum with cancellation: the gates are
    held to twice the CPU route's own bf16 error against the same weights
    in f32, or the bf16 limit above, whichever is larger."""
    cfg = _media_cfg(arch, dtype)
    params = _media_params(cfg)
    batch = next(synthetic_batches(cfg, 2, 64, 1, seed=3, device="cpu"))
    n_attn = 4 if cfg.family == "vlm" else cfg.n_layers
    results = []
    runs = [("cpu", cfg), (dev, cfg)]
    if dtype == "bfloat16":
        runs.append(("cpu", dataclasses.replace(cfg, dtype="float32")))
    for device, c in runs:
        p = tree_map(lambda t: t.detach().to(device, getattr(torch, c.dtype)).requires_grad_(),
                     params)
        fwd, bwd = flash_attention.launches, flash_attention.bwd_launches
        b = {k: v.to(device, getattr(torch, c.dtype)) if v.is_floating_point() else v.to(device)
             for k, v in batch.items()}
        loss, _ = TT.forward_train(p, c, b)
        grads = torch.autograd.grad(loss, tree_leaves(p))
        results.append((loss.detach(), grads))
        if device != "cpu":
            assert flash_attention.launches - fwd == 2 * n_attn
            assert flash_attention.bwd_launches - bwd == n_attn
    (l_cpu, g_cpu), (l_dev, g_dev) = results[:2]
    torch.testing.assert_close(l_dev.float().cpu(), l_cpu.float(),
                               rtol=1e-4 if dtype == "float32" else 2e-2, atol=0)
    names = []
    TT.map_schema(lambda path, _: names.append(".".join(path)), TT.param_schema(cfg))
    for i, (name, a, b) in enumerate(zip(names, g_dev, g_cpu)):
        if dtype == "bfloat16" and name.endswith(("gate_attn", "gate_mlp")):
            f32 = results[2][1][i]
            own = float((b.float() - f32).norm() / f32.norm())
            rel = float((a.float().cpu() - b.float()).norm() / b.float().norm())
            assert rel <= max(5e-2, 2 * own), f"{name}: relative L2 error {rel} (own {own})"
        else:
            _grad_close(a, b, dtype, name)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b", "whisper-small"])
def test_media_prefill_and_decode_on_the_card(dev, arch):
    """Reduced VLM and whisper in f32: prefill with media and 4 decode steps
    on the card against the CPU route; the ring and the media K/V caches."""
    cfg = _media_cfg(arch, "float32")
    params = _media_params(cfg)
    g = torch.Generator().manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (2, 36), generator=g, dtype=torch.int32)
    media = torch.randn((2, cfg.n_media_tokens, cfg.d_model), generator=g)
    out = []
    for device in ("cpu", dev):
        p = tree_map(lambda t: t.to(device), params)
        logits, cache = TT.prefill(p, cfg, {"tokens": toks[:, :32].to(device),
                                            "media": media.to(device)}, max_len=40)
        steps = [logits]
        for i in range(32, 36):
            logits, cache = TT.decode_step(p, cfg, toks[:, i:i + 1].to(device), cache)
            steps.append(logits)
        out.append(([x.cpu() for x in steps],
                    {n: t.cpu() for n, t in (("k", cache["self"]["k"]),
                                             ("media_k", cache["media_k"]),
                                             ("media_v", cache["media_v"]))}))
    (l_cpu, c_cpu), (l_dev, c_dev) = out
    for a, b in zip(l_dev, l_cpu):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    for n in c_cpu:
        torch.testing.assert_close(c_dev[n], c_cpu[n], rtol=1e-4, atol=1e-4)
