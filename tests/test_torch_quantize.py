"""The port's quantized and K-output forests against the JAX package.

Same seeded numpy forests through both packages. Tolerances:

  * ``Forest.quantize``: bit for bit (int8 codes, int8/int16 thresholds,
    fp16 leaves, scales; ``jnp.round`` and ``torch.round`` both round half
    to even, and the scale is one f32 division in both);
  * traversal in every form (f32, int8, fp16; one output and K = 3)
    against the JAX package's Pallas kernel in interpret mode and its
    oracle ``ref.forest_traverse_ref``: rtol/atol 1e-5 (sums taken in
    another order); leaf routing is exact, so only the adds differ;
  * quantized scores against the f32 forest's: ``quantization_atol`` +
    1e-6 (the documented bound plus f32 summation noise);
  * served answers: equal to ``link(forest_predict)`` within rtol 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.trees.forest import Forest as JForest
from repro.trees.forest import quantization_atol as jquantization_atol
from repro_torch.convert import forest_from_numpy, quantized_forest_from_numpy
from repro_torch.kernels import forest_traversal, ops, ref
from repro_torch.objectives import get_objective
from repro_torch.serving.forest_server import ForestServer, PredictRequest
from repro_torch.trees.binning import apply_bins
from repro_torch.trees.forest import (
    QuantizedForest,
    forest_predict,
    quantization_atol,
)

N, F, N_BINS = 150, 10, 32


def _forest(seed, slots, live, depth, k, n_bins=N_BINS):
    """A forest of ``slots`` random trees, ``live`` of them live; the dead
    slots hold stale trees with out-of-range thresholds and huge leaves
    (the mask must hide them). Leaves at the trainer's scale."""
    rng = np.random.default_rng(seed)
    n_int = (1 << depth) - 1
    feat = rng.integers(0, F, (slots, n_int)).astype(np.int32)
    thr = rng.integers(0, n_bins, (slots, n_int)).astype(np.int32)
    leaf = (0.01 * rng.standard_normal((slots, 1 << depth))).astype(np.float32)
    leaf[1] = 0.0  # an all-zero tree: scale 1
    thr[live:] = 2**30
    leaf[live:] = 1e6
    base = (np.float32(0.1) if k == 1
            else (0.1 * rng.standard_normal(k)).astype(np.float32))
    return feat, thr, leaf, np.int32(live), base


def _pair(arrays):
    feat, thr, leaf, live, base = arrays
    jf = JForest(*(jnp.asarray(a) for a in arrays))
    return jf, forest_from_numpy(feat, thr, leaf, live, base, device="cpu")


def _bins(seed=0, n=N):
    return np.random.default_rng(seed).integers(0, N_BINS, (n, F)).astype(np.int32)


FORESTS = {"k1": (11, 40, 29, 4, 1), "k3": (12, 36, 26, 3, 3)}


@pytest.mark.parametrize("mode", ["int8", "fp16"])
@pytest.mark.parametrize("which", sorted(FORESTS))
def test_quantize_is_the_reference_bit_for_bit(mode, which):
    jf, tf = _pair(_forest(*FORESTS[which]))
    jq, tq = jf.quantize(mode), tf.quantize(mode)
    assert isinstance(tq, QuantizedForest) and tq.mode == mode == jq.mode
    assert tq.n_outputs == jq.n_outputs and tq.depth == jq.depth
    for name in QuantizedForest._fields:
        want = np.asarray(getattr(jq, name))
        got = getattr(tq, name).numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    deq, jdeq = tq.dequantize(), jq.dequantize()
    for name in ("threshold", "leaf_value"):
        np.testing.assert_array_equal(getattr(deq, name).numpy(),
                                      np.asarray(getattr(jdeq, name)), err_msg=name)
    np.testing.assert_allclose(quantization_atol(tf, tq), jquantization_atol(jf, jq),
                               rtol=1e-6)


@pytest.mark.parametrize("mode,top,msg", [
    ("int8", 128, "int8 mode stores thresholds"),
    ("fp16", 32768, "fp16 mode stores thresholds"),
    ("int4", 0, "quantize mode"),
])
def test_quantize_range_errors_match_the_reference(mode, top, msg):
    """A live threshold past the packed type's range raises in both
    packages; a dead slot's sentinel threshold (2**30) does not."""
    arrays = list(_forest(3, 8, 6, 3, 1))
    arrays[1][2, 0] = top
    jf, tf = _pair(arrays)
    for forest in (jf, tf):
        with pytest.raises(ValueError, match=msg):
            forest.quantize(mode)


@pytest.mark.parametrize("mode", ["int8", "fp16"])
def test_quantized_forest_converts_from_the_reference(mode):
    jq = _pair(_forest(*FORESTS["k3"]))[0].quantize(mode)
    tq = quantized_forest_from_numpy(*(np.asarray(a) for a in jq), device="cpu")
    for name in QuantizedForest._fields:
        np.testing.assert_array_equal(getattr(tq, name).numpy(), np.asarray(getattr(jq, name)))
    with pytest.raises(TypeError, match="expected int8/int8 or int16/float16"):
        quantized_forest_from_numpy(*(np.asarray(a) for a in jq[:1]),
                                    np.asarray(jq.threshold).astype(np.int32),
                                    *(np.asarray(a) for a in jq[2:]), device="cpu")


@pytest.mark.parametrize("mode", ["f32", "int8", "fp16"])
@pytest.mark.parametrize("which", sorted(FORESTS))
def test_traversal_plain_matches_pallas_in_every_form(mode, which):
    """The plain version (the kernel's sum: dequantize, then tree by tree
    in slot order into column t % K) against the Pallas kernel in interpret
    mode (several tree blocks of 8) and against both packages' oracles."""
    jf, tf = _pair(_forest(*FORESTS[which]))
    if mode != "f32":
        jf, tf = jf.quantize(mode), tf.quantize(mode)
    k, depth = tf.n_outputs, tf.depth
    scale = getattr(tf, "leaf_scale", None)
    jscale = getattr(jf, "leaf_scale", None)
    bins = _bins(k)
    args = (torch.from_numpy(bins), tf.feature, tf.threshold, tf.leaf_value, tf.n_trees)
    got = forest_traversal.forest_traverse_plain(*args, depth, k, scale).numpy()
    assert got.shape == ((N,) if k == 1 else (N, k))
    jargs = (jnp.asarray(bins), jf.feature, jf.threshold, jf.leaf_value, jf.n_trees)
    pallas = jops.forest_traverse(*jargs, depth, backend="pallas", sample_block=64,
                                  tree_block=8, n_outputs=k, leaf_scale=jscale)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=1e-5, atol=1e-5)
    jor = jref.forest_traverse_ref(*jargs, depth, n_outputs=k, leaf_scale=jscale)
    np.testing.assert_allclose(got, np.asarray(jor), rtol=1e-5, atol=1e-5)
    tor = ref.forest_traverse_ref(*args, depth, n_outputs=k, leaf_scale=scale)
    np.testing.assert_allclose(got, tor.numpy(), rtol=1e-5, atol=1e-5)
    # On the CPU the dispatch is the plain version itself.
    np.testing.assert_array_equal(
        ops.forest_traverse(*args, depth, n_outputs=k, leaf_scale=scale).numpy(), got)


def test_f32_traversal_is_unchanged_by_the_quantized_path():
    """On the f32 layout the dequantize prologue returns its inputs, so the
    plain version is the same sum as before: tree by tree, in slot order."""
    feat, thr, leaf, live, _ = _forest(5, 20, 17, 4, 1)
    bins = torch.from_numpy(_bins(1))
    args = [torch.from_numpy(a) for a in (feat, thr, leaf)]
    th, lv = ref._dequantize_forest(args[1], args[2], None)
    assert th is args[1] and lv is args[2]
    total = torch.zeros(N)
    for t in range(int(live)):
        total = total + ref._tree_leaf_values(bins, *(a[t] for a in args), 4)
    got = forest_traversal.forest_traverse_plain(bins, *args, int(live), 4)
    assert torch.equal(got, total)


@pytest.mark.parametrize("thr,leaf", [(torch.int8, torch.float16), (torch.int16, torch.int8),
                                      (torch.int32, torch.float16), (torch.int64, torch.float32)])
def test_traversal_takes_the_three_layouts_only(thr, leaf):
    """int32/f32, int8/int8 and int16/fp16 (what ``Forest.quantize`` makes);
    any other pair is refused on every device."""
    _, tf = _pair(_forest(*FORESTS["k1"]))
    with pytest.raises(TypeError, match="the layouts are"):
        ops.forest_traverse(torch.from_numpy(_bins()), tf.feature, tf.threshold.to(thr),
                            tf.leaf_value.to(leaf), tf.n_trees, tf.depth)


def test_int8_traversal_needs_its_scale():
    tq = _pair(_forest(*FORESTS["k1"]))[1].quantize("int8")
    with pytest.raises(ValueError, match="leaf_scale"):
        forest_traversal.forest_traverse_plain(
            torch.from_numpy(_bins()), tq.feature, tq.threshold, tq.leaf_value,
            tq.n_trees, tq.depth)


@pytest.mark.parametrize("mode", ["int8", "fp16"])
@pytest.mark.parametrize("which", sorted(FORESTS))
def test_quantized_scores_within_the_documented_bound(mode, which):
    _, tf = _pair(_forest(*FORESTS[which]))
    tq = tf.quantize(mode)
    bins = torch.from_numpy(_bins(7))
    diff = (forest_predict(tq, bins) - forest_predict(tf, bins)).abs().max()
    atol = quantization_atol(tf, tq)
    assert 0.0 < float(diff) <= atol + 1e-6


def _server_case():
    """Raw rows and bin edges whose ``apply_bins`` gives ``_bins``-like ids."""
    rng = np.random.default_rng(4)
    edges = np.sort(rng.standard_normal((F, N_BINS - 1)).astype(np.float32), axis=1)
    x = rng.standard_normal((700, F)).astype(np.float32)
    return x, edges


@pytest.mark.parametrize("mode", [None, "int8", "fp16"])
def test_server_serves_k_output_softmax_rows(mode):
    """``ForestServer(..., objective="multiclass:3", quantize=mode)``: (n, 3)
    softmax rows equal to link(forest_predict) on the installed forest, a
    request over ``max_rows`` reassembled under its uid."""
    _, tf = _pair(_forest(*FORESTS["k3"]))
    x, edges = _server_case()
    server = ForestServer(tf, torch.from_numpy(edges), max_rows=64,
                          objective="multiclass:3", quantize=mode, device="cpu")
    assert type(server.forest) is (QuantizedForest if mode else type(tf))
    if mode:
        assert server.forest.mode == mode
    sizes = [150, 1, 64, 37]
    reqs, lo = [], 0
    for uid, n in enumerate(sizes):
        reqs.append(PredictRequest(uid, x[lo:lo + n]))
        lo += n
    results = server.run(reqs)
    assert [r.uid for r in results] == list(range(len(sizes)))
    link = get_objective("multiclass:3").link
    for req, res in zip(reqs, results):
        bins = apply_bins(torch.from_numpy(req.x), server.bin_edges)
        want = link(forest_predict(server.forest, bins)).numpy()
        assert res.scores.shape == (len(req.x), 3)
        np.testing.assert_allclose(res.scores, want, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(res.scores.sum(1), 1.0, atol=1e-5)
    assert server.waves_served >= 4  # the 150-row request rode three waves


def test_server_raises_on_an_output_mismatch():
    x, edges = _server_case()
    _, k3 = _pair(_forest(*FORESTS["k3"]))
    _, k1 = _pair(_forest(*FORESTS["k1"]))
    with pytest.raises(ValueError, match="has 3 outputs but the forest serves 1"):
        ForestServer(k1, torch.from_numpy(edges), objective="multiclass:3", device="cpu")
    with pytest.raises(ValueError, match="has 1 outputs but the forest serves 3"):
        ForestServer(k3, torch.from_numpy(edges), objective="logistic", device="cpu")
    with pytest.raises(ValueError, match="already quantized"):
        ForestServer(k3.quantize("int8"), torch.from_numpy(edges), quantize="fp16",
                     device="cpu")
    # A QuantizedForest is kept whole.
    server = ForestServer(k3.quantize("fp16"), torch.from_numpy(edges), device="cpu")
    assert isinstance(server.forest, QuantizedForest)
    assert server.run([PredictRequest(0, x[:5])])[0].scores.shape == (5, 3)
