"""Hot swap and continuous serving of the port, against the JAX package.

``load_forest_checkpoint`` on bare and TrainState checkpoints (the
``forest`` parent preferred, ambiguity raising); ``ForestServer``'s hot
swap: a round trip, the ``reload_every_waves`` bound mid-stream, the idle
poller, and a threaded soak with no torn forest/step pair; a JAX-trained
checkpoint served and hot-swapped by the port within 1e-5 of the JAX
``ForestServer``'s scores; ``ForestEngine``: ``route_hash`` equal to the
reference's for 10,000 uids, A/B routing with per-version steps, shadow
traffic, SLO cutting, the background runner, a quantized version within
``quantization_atol`` + 1e-6 of its f32 twin; ``percentile_latencies``
equal to the reference's on the same results. Scores of one forest are
held to the port's own ``forest_predict`` at 1e-6, as the reference's
tests hold theirs.
"""
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro.serving import continuous as jcont
from repro_torch.checkpoint import CheckpointManager, save_pytree
from repro_torch.core.sgbdt import SGBDTConfig
from repro_torch.ps import Trainer
from repro_torch.serving import (
    ForestEngine,
    ForestServer,
    PredictRequest,
    PredictResult,
    load_forest_checkpoint,
    percentile_latencies,
    route_hash,
)
from repro_torch.trees.binning import bin_dataset
from repro_torch.trees.forest import forest_predict, quantization_atol
from repro_torch.trees.learner import LearnerConfig

N_TREES, DEPTH, DIM = 8, 3, 12


def _raw(seed: int = 0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((400, DIM)).astype(np.float32)
    w = rng.standard_normal(DIM).astype(np.float32)
    return x, (x @ w > 0).astype(np.float32)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The port's forest on raw data, checkpointed (TrainState) at steps
    N_TREES / 2 and N_TREES."""
    x, y = _raw()
    data = bin_dataset(x, y, n_bins=64, device="cpu")
    cfg = SGBDTConfig(n_trees=N_TREES, step_length=0.3, sampling_rate=0.9,
                      learner=LearnerConfig(depth=DEPTH, n_bins=64))
    root = tmp_path_factory.mktemp("gbdt_ckpt")
    ckpt = CheckpointManager(root, save_every=1, keep=4)
    state = Trainer(cfg, device="cpu").train(
        data, ("round_robin", 2), seed=0,
        eval_every=N_TREES // 2, eval_fn=lambda st, j: ckpt.maybe_save(j, st))
    half = load_forest_checkpoint(root, N_TREES // 2, like=state.forest, device="cpu")
    return x, data, state, root, half


def _pred(forest, data) -> np.ndarray:
    return forest_predict(forest, data.bins).numpy()


def _same_forest(a, b) -> None:
    for name in ("feature", "threshold", "leaf_value", "n_trees", "base_score"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_checkpoint_loader_reads_state_and_bare_forests(setup, tmp_path):
    x, data, state, root, half = setup
    full = load_forest_checkpoint(root, N_TREES, like=state.forest, device="cpu")
    _same_forest(full, state.forest)
    assert int(half.n_trees) == N_TREES // 2
    assert torch.equal(half.leaf_value[: N_TREES // 2], state.forest.leaf_value[: N_TREES // 2])
    save_pytree(tmp_path, 3, state.forest)  # a bare Forest: paths .feature ...
    _same_forest(load_forest_checkpoint(tmp_path, 3, like=state.forest, device="cpu"),
                 state.forest)
    with pytest.raises(ValueError, match="serving template"):
        load_forest_checkpoint(tmp_path, 3, like=state.forest._replace(
            leaf_value=torch.zeros(N_TREES, 4)), device="cpu")


@pytest.mark.parametrize("others,error", [
    ({"ema": "half", "forest": "full"}, None),  # 'ema' sorts first: the parent decides
    ({"ema": "half", "primary": "full"}, "ambiguous"),
])
def test_checkpoint_loader_prefers_the_forest_parent(setup, tmp_path, others, error):
    x, data, state, root, half = setup
    trees = {"half": half, "full": state.forest}
    save_pytree(tmp_path, 1, {k: trees[v] for k, v in others.items()})
    if error:
        with pytest.raises(KeyError, match=error):
            load_forest_checkpoint(tmp_path, 1, device="cpu")
    else:
        _same_forest(load_forest_checkpoint(tmp_path, 1, like=state.forest, device="cpu"),
                     state.forest)


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_hot_swap_round_trip(setup, quantize):
    """Boot on the old step, reload the newest checkpoint, serve its
    scores; a quantized server re-packs the reloaded forest."""
    x, data, state, root, half = setup
    server = ForestServer(half, data.bin_edges, ckpt_root=root, max_rows=64,
                          model_step=N_TREES // 2, quantize=quantize, device="cpu")
    assert server.maybe_reload() and server.model_step == N_TREES
    assert not server.maybe_reload()  # nothing newer
    out = server.run([PredictRequest(uid=0, x=x[:64])])[0]
    assert out.model_step == N_TREES
    want = state.forest.quantize(quantize) if quantize else state.forest
    if quantize:
        assert server.forest.mode == quantize
        _same_forest(server.forest, want)
    np.testing.assert_allclose(out.scores, forest_predict(want, data.bins[:64]).numpy(),
                               rtol=1e-6, atol=1e-6)


def test_reload_bound_mid_stream(setup, tmp_path):
    """A checkpoint written mid-stream serves within reload_every_waves
    waves though the caller never polls."""
    x, data, state, root, half = setup
    save_pytree(tmp_path, 1, half)
    server = ForestServer(half, data.bin_edges, ckpt_root=tmp_path, max_rows=32,
                          model_step=1, reload_every_waves=2, device="cpu")
    for i in range(8):
        server.submit(PredictRequest(uid=i, x=x[32 * i: 32 * (i + 1)]))
    wave_steps = [server.serve_next_wave()[0].model_step for _ in range(2)]
    save_pytree(tmp_path, 2, state.forest)
    while res := server.serve_next_wave():
        wave_steps.append(res[0].model_step)
    assert wave_steps[:2] == [1, 1] and wave_steps[-1] == 2
    assert wave_steps.index(2) <= 2 + server.reload_every_waves
    out = server.run([PredictRequest(uid=99, x=x[224:256])])[0]
    np.testing.assert_allclose(out.scores, _pred(state.forest, data)[224:256],
                               rtol=1e-6, atol=1e-6)


def test_idle_poller_picks_up_a_new_step(setup, tmp_path):
    x, data, state, root, half = setup
    save_pytree(tmp_path, 1, half)
    server = ForestServer(half, data.bin_edges, ckpt_root=tmp_path, max_rows=32,
                          model_step=1, device="cpu")
    server.start_reload_poller(interval_s=0.01)
    try:
        save_pytree(tmp_path, 2, state.forest)
        deadline = time.perf_counter() + 5.0
        while time.perf_counter() < deadline:
            with server._lock:
                step = server.model_step
            if step == 2:
                break
            time.sleep(0.01)
        assert step == 2 and server.waves_served == 0
    finally:
        server.stop_reload_poller()
    assert server._poller is None
    _same_forest(server.forest, state.forest)


def test_threaded_soak_no_torn_swap(setup, tmp_path):
    """Concurrent submits, two wave threads and a mid-run checkpoint: every
    request answered once, by the forest of the step it is labelled with,
    each thread's steps monotone."""
    x, data, state, root, half = setup
    save_pytree(tmp_path, 1, half)
    server = ForestServer(half, data.bin_edges, ckpt_root=tmp_path, max_rows=16,
                          model_step=1, reload_every_waves=4, device="cpu")
    pred = {1: _pred(half, data), 2: _pred(state.forest, data)}
    n_req, chunk = 60, 5
    slices = [(chunk * i % 300, chunk * i % 300 + chunk) for i in range(n_req)]
    done = threading.Event()
    results: dict[int, list] = {0: [], 1: []}

    def submitter(lo_uid, hi_uid):
        for uid in range(lo_uid, hi_uid):
            lo, hi = slices[uid]
            server.submit(PredictRequest(uid=uid, x=x[lo:hi]))
            time.sleep(0.001)

    def waves(tid):
        while True:
            res = server.serve_next_wave()
            results[tid].extend(res)
            if not res:
                if done.is_set() and server.queued_rows() == 0:
                    return
                time.sleep(0.002)

    def swapper():
        time.sleep(0.05)
        save_pytree(tmp_path, 2, state.forest)

    subs = [threading.Thread(target=submitter, args=(0, n_req // 2)),
            threading.Thread(target=submitter, args=(n_req // 2, n_req))]
    rest = [threading.Thread(target=waves, args=(0,)), threading.Thread(target=waves, args=(1,)),
            threading.Thread(target=swapper)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # interleave the threads finely
    try:
        for t in subs + rest:
            t.start()
        for t in subs:
            t.join(timeout=60)
        done.set()
        for t in rest:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in subs + rest)
    everything = results[0] + results[1]
    assert sorted(r.uid for r in everything) == list(range(n_req))
    for r in everything:
        lo, hi = slices[r.uid]
        np.testing.assert_allclose(r.scores, pred[r.model_step][lo:hi], rtol=1e-5, atol=1e-5)
    for tid in (0, 1):
        steps = [r.model_step for r in results[tid]]
        assert steps == sorted(steps)


def test_jax_trained_checkpoint_served_and_swapped_by_the_port(tmp_path):
    """The JAX package trains and checkpoints a TrainState at steps 4 and 8;
    the port serves step 4, hot-swaps to 8 through its own poll of the same
    root, and answers as the JAX ForestServer does at each step."""
    from repro.checkpoint import CheckpointManager as JManager
    from repro.core.sgbdt import SGBDTConfig as JConfig
    from repro.ps import Trainer as JTrainer
    from repro.serving.forest_server import ForestServer as JServer
    from repro.serving.forest_server import PredictRequest as JRequest
    from repro.serving.forest_server import load_forest_checkpoint as jload
    from repro.trees.binning import bin_dataset as jbin
    from repro.trees.learner import LearnerConfig as JLearner

    x, y = _raw(1)
    jdata = jbin(x, y, n_bins=64)
    cfg = JConfig(n_trees=N_TREES, step_length=0.3, sampling_rate=0.9,
                  learner=JLearner(depth=DEPTH, n_bins=64))
    mgr = JManager(tmp_path, save_every=1, keep=4)
    JTrainer(cfg).train(jdata, ("round_robin", 2), seed=0, eval_every=N_TREES // 2,
                        eval_fn=lambda st, j: mgr.maybe_save(j, st))
    rows = np.random.default_rng(5).standard_normal((50, DIM)).astype(np.float32)
    edges = np.array(jdata.bin_edges)
    server = ForestServer(load_forest_checkpoint(tmp_path, N_TREES // 2, device="cpu"), edges,
                          max_rows=32, model_step=N_TREES // 2, objective="logistic",
                          device="cpu")
    before = server.run([PredictRequest(uid=0, x=rows)])[0]
    server.ckpt_root = tmp_path
    after = server.run([PredictRequest(uid=1, x=rows)])[0]
    assert (before.model_step, after.model_step) == (N_TREES // 2, N_TREES)
    for res, step in ((before, N_TREES // 2), (after, N_TREES)):
        jserver = JServer(jload(tmp_path, step), jdata.bin_edges, max_rows=32,
                          objective="logistic")
        want = jserver.run([JRequest(uid=0, x=rows)])[0].scores
        np.testing.assert_allclose(res.scores, want, rtol=1e-5, atol=1e-5)


def test_route_hash_matches_the_reference():
    uids = list(range(10_000)) + [2**31 - 1, 2**32 + 7, 10**12 + 3]
    assert [route_hash(u) for u in uids] == [jcont.route_hash(u) for u in uids]


def test_engine_ab_routing_and_per_version_steps(setup):
    x, data, state, root, half = setup
    eng = ForestEngine(data.bin_edges, max_rows=64, slo_s=10.0, device="cpu")
    eng.add_version("old", half, weight=0.5, model_step=N_TREES // 2)
    eng.add_version("new", state.forest, weight=0.5, model_step=N_TREES)
    reqs = [PredictRequest(uid=i, x=x[4 * i: 4 * i + 4]) for i in range(50)]
    routed = {r.uid: eng.submit(r) for r in reqs}
    for uid, name in routed.items():  # the reference's split of the same uids
        assert name == ("old" if jcont.route_hash(uid) < 0.5 else "new")
    outs = eng.run()
    assert len(outs) == 50
    pred = {"old": _pred(half, data), "new": _pred(state.forest, data)}
    want_step = {"old": N_TREES // 2, "new": N_TREES}
    for r in outs:
        assert r.version == routed[r.uid] and r.model_step == want_step[r.version]
        np.testing.assert_allclose(r.scores, pred[r.version][4 * r.uid: 4 * r.uid + 4],
                                   rtol=1e-6, atol=1e-6)
    assert 5 < sum(r.version == "old" for r in outs) < 45
    assert eng.version_steps() == want_step
    assert {r.uid: eng.submit(r) for r in reqs} == routed
    eng.flush()
    eng.set_weight("old", 0.0)
    assert all(eng.submit(PredictRequest(uid=u, x=x[:2])) == "new" for u in range(20))
    eng.flush()


def test_engine_shadow_traffic(setup):
    x, data, state, root, half = setup
    eng = ForestEngine(data.bin_edges, max_rows=64, slo_s=10.0, device="cpu")
    eng.add_version("live", state.forest, model_step=N_TREES)
    eng.add_version("cand", half, shadow=True, model_step=N_TREES // 2)
    for i in range(10):
        assert eng.submit(PredictRequest(uid=i, x=x[2 * i: 2 * i + 2])) == "live"
    outs = eng.run()
    assert len(outs) == 10 and all(r.version == "live" for r in outs)
    shadow = eng.shadow_results
    assert sorted(r.uid for r in shadow) == list(range(10))
    pred_half = _pred(half, data)
    for r in shadow:
        assert r.version == "cand" and r.model_step == N_TREES // 2
        np.testing.assert_allclose(r.scores, pred_half[2 * r.uid: 2 * r.uid + 2],
                                   rtol=1e-6, atol=1e-6)
    assert eng.submit(PredictRequest(uid=77, x=x[:3], version="cand")) == "cand"
    assert eng.run() == [] and any(r.uid == 77 for r in eng.shadow_results)
    with pytest.raises(KeyError, match="unknown"):
        eng.submit(PredictRequest(uid=0, x=x[:2], version="nope"))


def test_engine_slo_cutting(setup):
    """A lone small request waits while its budget lasts and is served once
    it is spent; a full wave cuts at once."""
    x, data, state, root, half = setup
    eng = ForestEngine(data.bin_edges, max_rows=32, slo_s=0.3, device="cpu")
    eng.add_version("v", state.forest, model_step=N_TREES)
    eng.run([PredictRequest(uid=0, x=x[:4])])
    eng.submit(PredictRequest(uid=1, x=x[:4]))
    assert eng.step() == []
    time.sleep(0.35)
    out = eng.step()
    assert [r.uid for r in out] == [1] and out[0].queue_s >= 0.3
    eng.submit(PredictRequest(uid=2, x=x[:32]))
    out = eng.step()
    assert [r.uid for r in out] == [2] and out[0].queue_s < 0.3


def test_engine_background_runner(setup):
    x, data, state, root, half = setup
    eng = ForestEngine(data.bin_edges, max_rows=64, slo_s=0.2, device="cpu")
    eng.add_version("v", state.forest)
    eng.start(interval_s=0.002)
    try:
        for uid in range(10):
            eng.submit(PredictRequest(uid=uid, x=x[: uid + 1]))
        deadline, got = time.perf_counter() + 10.0, []
        while len(got) < 10 and time.perf_counter() < deadline:
            got.extend(eng.poll())
            time.sleep(0.01)
    finally:
        eng.stop()
    got.extend(eng.poll())
    assert sorted(r.uid for r in got) == list(range(10))
    assert set(percentile_latencies(got)) == {"queue_p50_ms", "queue_p99_ms", "compute_p50_ms",
                                              "compute_p99_ms", "latency_p50_ms",
                                              "latency_p99_ms"}


@pytest.mark.parametrize("mode", ["int8", "fp16"])
def test_engine_quantized_version_parity(setup, mode):
    x, data, state, root, half = setup
    eng = ForestEngine(data.bin_edges, max_rows=64, slo_s=10.0, device="cpu")
    eng.add_version("f32", state.forest)
    eng.add_version("q", state.forest, quantize=mode, weight=0.0)
    atol = quantization_atol(state.forest, state.forest.quantize(mode))
    eng.submit(PredictRequest(uid=0, x=x[:50], version="f32"))
    eng.submit(PredictRequest(uid=1, x=x[:50], version="q"))
    outs = eng.run()
    assert [r.version for r in outs] == ["f32", "q"]
    np.testing.assert_allclose(outs[1].scores, outs[0].scores, rtol=0, atol=atol + 1e-6)


def test_percentile_latencies_match_the_reference():
    rng = np.random.default_rng(3)
    q, c = rng.random(37) * 0.01, rng.random(37) * 0.02
    port = [PredictResult(uid=i, scores=np.zeros(1), model_step=1, latency_s=q[i] + c[i],
                          queue_s=q[i], compute_s=c[i]) for i in range(37)]
    ref = [jcont.PredictResult(uid=i, scores=np.zeros(1), model_step=1,
                               latency_s=q[i] + c[i], queue_s=q[i], compute_s=c[i])
           for i in range(37)]
    assert percentile_latencies(port) == jcont.percentile_latencies(ref)
    assert percentile_latencies([]) == jcont.percentile_latencies([]) == {}


def test_engine_and_loader_without_device_raise_without_gpu(setup, monkeypatch):
    x, data, state, root, half = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ForestEngine(data.bin_edges)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_forest_checkpoint(root, N_TREES)
    assert ForestEngine(data.bin_edges, device="cpu").device.type == "cpu"
