"""The port's PS engine, forest and server against the JAX package.

The reference draws its randomness with ``jax.random``; the tests
recompute those draws from the reference's keys (engine.py:269, :83-84,
learner.py:324-328) and inject them into the port.

Training is held to the repo's cross-backend forest contract — a bitwise
heap prefix (levels 0..3, the whole tree at depth 3), at least 97% of
nodes identical, at most 1% RMS prediction drift — and f matches to 1e-5,
on data whose splits are decisive. The two packages sum in other orders,
so their values differ in the last ulp; where a split is a near-tie that
ulp can flip it, and one flipped split moves the later rounds' gradients
macroscopically. On realistic sparse data the two are therefore held
together at the loss level, as tests/test_ps_engine.py holds its own
batched and per-round programs.
"""
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sgbdt import SGBDTConfig as JSGBDTConfig
from repro.data import synthetic as jsyn
from repro.data.sampling import bernoulli_weights as jbernoulli_weights
from repro.ps.engine import Trainer as JTrainer
from repro.trees.binning import BinnedData as JBinnedData
from repro.trees.forest import forest_predict as jforest_predict
from repro.trees.learner import LearnerConfig as JLearnerConfig
from repro_torch.convert import binned_from_numpy, forest_from_numpy
from repro_torch.core.sgbdt import SGBDTConfig
from repro_torch.ps.engine import Trainer, propose_tree
from repro_torch.serving.forest_server import ForestServer, PredictRequest
from repro_torch.trees.binning import apply_bins
from repro_torch.trees.forest import forest_predict
from repro_torch.trees.learner import LearnerConfig

ROUNDS, STEP = 12, 0.3


def _decisive_data(seed=0, n=600, f=6, n_bins=16):
    """Labels driven by three thresholded features of falling weight, three
    noise features: every split of a depth-3 tree is decisive."""
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, n_bins, (n, f)).astype(np.int32)
    z = (3.0 * (2 * (bins[:, 0] > 8) - 1) + 1.5 * (2 * (bins[:, 1] > 4) - 1)
         + 0.75 * (2 * (bins[:, 2] > 10) - 1))
    y = (rng.random(n) < 1 / (1 + np.exp(-z))).astype(np.float32)
    return JBinnedData(
        bins=jnp.asarray(bins), bin_edges=jnp.zeros((f, n_bins - 1), jnp.float32),
        labels=jnp.asarray(y), multiplicity=jnp.ones(n, jnp.float32), n_bins=n_bins,
    )


def _pair(jdata):
    return jdata, binned_from_numpy(jdata.bins, jdata.bin_edges, jdata.labels,
                                    jdata.multiplicity, jdata.n_bins, device="cpu")


def _cfgs(depth, n_bins):
    j = JSGBDTConfig(
        n_trees=ROUNDS, step_length=STEP, sampling_rate=0.8,
        learner=JLearnerConfig(depth=depth, n_bins=n_bins, feature_fraction=0.8,
                               backend="ref"),
    )
    t = SGBDTConfig(
        n_trees=ROUNDS, step_length=STEP, sampling_rate=0.8,
        learner=LearnerConfig(depth=depth, n_bins=n_bins, feature_fraction=0.8),
    )
    return j, t


def _reference_draws(jdata, seed=0):
    """The reference's per-round (m_prime, feat_mask), as torch tensors."""
    keys = jax.random.split(jax.random.PRNGKey(seed), ROUNDS)
    out = []
    for j in range(ROUNDS):
        r_sample, r_feat = jax.random.split(keys[j])
        m, _ = jbernoulli_weights(r_sample, 0.8, jdata.multiplicity)
        mask = jax.random.uniform(r_feat, (jdata.n_features,)) < 0.8
        out.append((torch.from_numpy(np.array(m)), torch.from_numpy(np.array(mask))))
    return out


def _train_both(pair, depth, workers):
    jdata, tdata = pair
    jcfg, tcfg = _cfgs(depth, jdata.n_bins)
    return (
        JTrainer(jcfg).train(jdata, ("round_robin", workers), seed=0),
        Trainer(tcfg, device="cpu").train(tdata, ("round_robin", workers), seed=0,
                                          draws=_reference_draws(jdata)),
    )


@pytest.fixture(scope="module")
def decisive_pair():
    return _pair(_decisive_data())


@pytest.fixture(scope="module")
def data_pair():
    """A small realsim-like sparse set (the paper's high-diversity regime)."""
    return _pair(jsyn.make_sparse_classification(600, 40, 8, seed=3))


@pytest.fixture(scope="module")
def trained(data_pair):
    """Both packages trained at depth 5 under W = 4 on the same draws."""
    return _train_both(data_pair, 5, 4)


@pytest.mark.parametrize("workers", [1, 4])
def test_training_matches_jax(decisive_pair, workers):
    js, ts = _train_both(decisive_pair, 3, workers)
    jf, tf = js.forest, ts.forest
    assert int(tf.n_trees) == int(jf.n_trees) == ROUNDS and ts.step == ROUNDS
    prefix = (1 << 3) - 1
    for name in ("feature", "threshold"):
        a, b = getattr(tf, name).numpy(), np.asarray(getattr(jf, name))
        np.testing.assert_array_equal(a[:, :prefix], b[:, :prefix])
        assert np.mean(a == b) >= 0.97, f"{name}: too many node flips"
    np.testing.assert_allclose(ts.f.numpy(), np.asarray(js.f), rtol=1e-5, atol=1e-5)
    pt = forest_predict(tf, decisive_pair[1].bins).numpy()
    pj = np.asarray(jforest_predict(jf, decisive_pair[0].bins, backend="ref"))
    scale = np.sqrt(np.mean(pj**2)) + 1e-12
    assert np.sqrt(np.mean((pt - pj) ** 2)) <= 0.01 * scale


def test_training_loss_matches_jax_on_sparse_data(trained, data_pair):
    js, ts = trained
    jdata, tdata = data_pair
    jcfg, tcfg = _cfgs(5, 64)
    l_j = float(jcfg.obj.loss(jdata.labels, js.f, jdata.multiplicity))
    l_t = float(tcfg.obj.loss(tdata.labels, ts.f, tdata.multiplicity))
    assert abs(l_t - l_j) < 0.02, (l_t, l_j)
    # The top of the first tree sees identical inputs and decisive gains.
    np.testing.assert_array_equal(ts.forest.feature[0, :3].numpy(),
                                  np.asarray(js.forest.feature)[0, :3])


def test_training_lowers_loss_and_predict_matches_f(trained, data_pair):
    _, ts = trained
    tdata = data_pair[1]
    _, tcfg = _cfgs(5, 64)
    f0 = torch.full_like(ts.f, float(ts.forest.base_score))
    assert tcfg.obj.loss(tdata.labels, ts.f, tdata.multiplicity) < \
        tcfg.obj.loss(tdata.labels, f0, tdata.multiplicity)
    torch.testing.assert_close(forest_predict(ts.forest, tdata.bins), ts.f,
                               rtol=1e-5, atol=1e-6)


def test_port_training_is_deterministic(data_pair):
    """The port's own draws (a seeded torch.Generator) replay bit for bit."""
    _, tcfg = _cfgs(5, 64)
    tcfg = tcfg._replace(n_trees=4)
    runs = [Trainer(tcfg, device="cpu").train(data_pair[1], ("round_robin", 2), seed=5)
            for _ in range(2)]
    for name in ("feature", "threshold", "leaf_value", "n_trees"):
        assert torch.equal(getattr(runs[0].forest, name), getattr(runs[1].forest, name))
    assert torch.equal(runs[0].f, runs[1].f)


def test_propose_tree_prescales_leaves(data_pair):
    """The push carries v * leaf, and its delta is the scaled tree's gather."""
    jdata, tdata = data_pair
    _, tcfg = _cfgs(5, 64)
    m, mask = _reference_draws(jdata)[0]
    f = torch.zeros(tdata.n_samples)
    tree, delta = propose_tree(tcfg, tdata, f, m_prime=m, feat_mask=mask)
    unscaled, _ = propose_tree(tcfg._replace(step_length=1.0), tdata, f,
                               m_prime=m, feat_mask=mask)
    torch.testing.assert_close(tree.leaf_value, STEP * unscaled.leaf_value)
    assert torch.isin(delta, tree.leaf_value).all()


def test_converted_jax_forest_predicts_the_same(trained, data_pair):
    jf = trained[0].forest
    jdata = data_pair[0]
    tf = forest_from_numpy(jf.feature, jf.threshold, jf.leaf_value, jf.n_trees,
                           jf.base_score, device="cpu")
    want = np.asarray(jforest_predict(jf, jdata.bins, backend="ref"))
    got = forest_predict(tf, data_pair[1].bins).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _server(trained, data_pair, **kw):
    tf = trained[1].forest
    return ForestServer(tf, data_pair[1].bin_edges, max_rows=64, objective="logistic",
                        device="cpu", **kw)


def _expected(server, x):
    bins = apply_bins(torch.from_numpy(x), server.bin_edges)
    return torch.sigmoid(2.0 * forest_predict(server.forest, bins)).numpy()


def test_server_reassembles_chunked_requests(trained, data_pair):
    server = _server(trained, data_pair)
    rng = np.random.default_rng(0)
    sizes = [150, 3, 64, 40, 1]
    reqs = [PredictRequest(uid, rng.standard_normal((n, 40)).astype(np.float32))
            for uid, n in enumerate(sizes)]
    results = server.run(reqs)
    assert [r.uid for r in results] == list(range(len(sizes)))
    for req, res in zip(reqs, results):
        assert res.scores.shape == (req.x.shape[0],)
        np.testing.assert_allclose(res.scores, _expected(server, req.x), rtol=1e-6)
        assert res.latency_s == pytest.approx(res.queue_s + res.compute_s)
        assert res.queue_s >= 0 and res.compute_s > 0
    assert server.waves_served >= 5  # 150 rows alone span three 64-row waves


def test_server_rejects_nonfinite_rows(trained, data_pair):
    server = _server(trained, data_pair)
    x = np.zeros((4, 40), np.float32)
    x[2, 5] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        server.submit(PredictRequest(0, x))
    with pytest.raises(ValueError, match="features"):
        server.submit(PredictRequest(1, np.zeros((2, 39), np.float32)))
    assert server.run() == []


def test_server_flags_nonfinite_rows(trained, data_pair):
    server = _server(trained, data_pair, on_nonfinite="flag")
    x = np.random.default_rng(1).standard_normal((90, 40)).astype(np.float32)
    x[3, 1], x[70, 0], x[71, 2] = np.nan, np.inf, -np.inf
    (res,) = server.run([PredictRequest(7, x)])
    np.testing.assert_array_equal(res.nonfinite_rows, [3, 70, 71])
    np.testing.assert_allclose(res.scores, _expected(server, x), rtol=1e-6)
    assert np.isfinite(res.scores).all()


def test_server_under_concurrent_submit_and_serve(trained, data_pair):
    """Many submitting and serving threads at once (more threads than
    cores, a short switch interval): every request comes back exactly
    once, whole, with its own scores — parts of one request may ride
    waves served by different threads."""
    server = _server(trained, data_pair)
    server.max_rows = 16
    rng = np.random.default_rng(3)
    reqs = [PredictRequest(uid, rng.standard_normal((int(rng.integers(1, 40)), 40))
                           .astype(np.float32)) for uid in range(96)]
    results, res_lock = [], threading.Lock()
    submitted = threading.Event()

    def submit(chunk):
        for r in chunk:
            server.submit(r)

    def serve():
        while not (submitted.is_set() and server.queued_rows() == 0):
            got = server.serve_next_wave()
            with res_lock:
                results.extend(got)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        servers = [threading.Thread(target=serve) for _ in range(8)]
        submitters = [threading.Thread(target=submit, args=(reqs[k::8],)) for k in range(8)]
        for t in servers + submitters:
            t.start()
        for t in submitters:
            t.join(timeout=60)
        submitted.set()
        for t in servers:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in servers + submitters)
    finally:
        sys.setswitchinterval(interval)
    assert sorted(r.uid for r in results) == list(range(len(reqs)))
    for res in results:
        np.testing.assert_allclose(res.scores, _expected(server, reqs[res.uid].x), rtol=1e-6)


def test_server_serve_next_wave_packs_greedily(trained, data_pair):
    server = _server(trained, data_pair)
    for uid, n in enumerate([30, 30, 30]):
        server.submit(PredictRequest(uid, np.zeros((n, 40), np.float32)))
    first = server.serve_next_wave()
    assert [r.uid for r in first] == [0, 1]  # 60 rows fit, the third does not
    assert [r.uid for r in server.serve_next_wave()] == [2]
    assert server.serve_next_wave() == []
