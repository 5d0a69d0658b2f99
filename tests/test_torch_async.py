"""The port's asynchronous layer against the JAX package, and its own
explicit-schedule forms: traces, runtime checkpoints and replays cross
between the two packages; ``train_worker_parallel``, ``scan_with`` and the
threaded CLI hold the port's own contracts.

The reference draws round i's randomness from ``keys[i]`` of
``jax.random.split(PRNGKey(seed), n_trees)``; the cross-package tests
recompute those draws per ticket (engine.py:83-84, learner.py:324-328) and
inject them into the port (``AsyncRuntime(draws=)``, ``replay_trace(draws=)``).

Standards, as each test states:

  * cross-package replays on decisive data (the splits of a depth-3 tree
    decisive under the round-robin schedule, tests/test_torch_engine.py):
    ``feature`` and ``threshold`` bitwise, ``leaf_value`` within 1e-6,
    ``f`` (a sum of 8 such leaves on |F| up to about 2, a few ulp apart)
    within 1e-6 + 1e-6 |f|. A schedule realized by a race can bring a
    deep node to a near-tie that the two packages' summation orders break
    apart (one node in 56, about one run in twenty); such a forest is held
    to the repo's cross-backend contract instead: every root split
    bitwise, at least 97% of nodes identical, F within 1% RMS;
  * the golden trace (sparse data, 320 x 48; a fixed schedule): the strict
    standard against the committed forest in ``tests/golden/ckpt``;
  * within the port: bitwise.
"""
import importlib.util
import json
import pathlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


from repro import checkpoint as jckpt
from repro.core.sgbdt import SGBDTConfig as JSGBDTConfig
from repro.data.sampling import bernoulli_weights as jbernoulli_weights
from repro.ps import AsyncRuntime as JAsyncRuntime
from repro.ps import RunTrace as JRunTrace
from repro.ps import replay_trace as jreplay_trace
from repro.trees.binning import BinnedData as JBinnedData
from repro.trees.learner import LearnerConfig as JLearnerConfig
from repro_torch.checkpoint import store as tckpt
from repro_torch.convert import binned_from_numpy
from repro_torch.core import async_sgbdt
from repro_torch.core.sgbdt import SGBDTConfig, init_state, train_loss
from repro_torch.data import synthetic as tsyn
from repro_torch.launch import train as ttrain
from repro_torch.ps import AsyncRuntime, RunTrace, replay_trace, train, train_worker_parallel
from repro_torch.ps.engine import Trainer, propose_tree, round_draws, round_seed, unpack_draws
from repro_torch.ps.worker import build_trees_batched
from repro_torch.trees.learner import LearnerConfig

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
_spec = importlib.util.spec_from_file_location("golden_regen", GOLDEN / "regen.py")
regen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(regen)

ROUNDS = 8


@pytest.fixture(scope="module", autouse=True)
def one_op_thread():
    """Each worker thread runs its ops on one CPU thread: four workers of
    the runtime beside the suite's other processes would oversubscribe the
    cores with torch's intra-op pools."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


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


def _port(jdata):
    return binned_from_numpy(jdata.bins, jdata.bin_edges, jdata.labels, jdata.multiplicity,
                             jdata.n_bins, device="cpu")


def _cfgs(rounds=ROUNDS, depth=3, n_bins=16, **kw):
    common = dict(n_trees=rounds, step_length=0.3, sampling_rate=0.8, **kw)
    return (JSGBDTConfig(learner=JLearnerConfig(depth=depth, n_bins=n_bins, backend="ref"),
                         **common),
            SGBDTConfig(learner=LearnerConfig(depth=depth, n_bins=n_bins), **common))


def _reference_draws(jcfg, jdata, seed):
    """Ticket i's (m_prime, q_any, feat_mask) as the reference draws them
    from ``keys[i]``, as torch tensors."""
    keys = jax.random.split(jax.random.PRNGKey(seed), jcfg.n_trees)
    ff = jcfg.learner.feature_fraction
    out = []
    for i in range(jcfg.n_trees):
        r_sample, r_feat = jax.random.split(keys[i])
        m, q = jbernoulli_weights(r_sample, jcfg.sampling_rate, jdata.multiplicity)
        mask = (jax.random.uniform(r_feat, (jdata.n_features,)) < ff if ff < 1.0
                else jnp.ones(jdata.n_features, bool))
        out.append(tuple(torch.from_numpy(np.array(a)) for a in (m, q, mask)))
    return out


def _cross_standard(tstate, jforest, jf, strict: bool = False):
    """The reference's forest and F against the port's state: ``feature``
    and ``threshold`` bitwise, ``leaf_value`` within 1e-6, ``f`` within
    1e-6 + 1e-6 |f|; unless ``strict``, a forest whose structure differs is
    held to the cross-backend contract (root splits bitwise, at least 97%
    of nodes identical, F within 1% RMS)."""
    assert int(tstate.forest.n_trees) == int(jforest.n_trees)
    ours = {n: getattr(tstate.forest, n).numpy() for n in ("feature", "threshold")}
    theirs = {n: np.asarray(getattr(jforest, n)) for n in ("feature", "threshold")}
    if strict or all(np.array_equal(ours[n], theirs[n]) for n in ours):
        for n in ours:
            np.testing.assert_array_equal(ours[n], theirs[n], err_msg=n)
        np.testing.assert_allclose(tstate.forest.leaf_value.numpy(),
                                   np.asarray(jforest.leaf_value), rtol=0, atol=1e-6)
        np.testing.assert_allclose(tstate.f.numpy(), np.asarray(jf), rtol=1e-6, atol=1e-6)
        return
    for n in ours:
        np.testing.assert_array_equal(ours[n][:, 0], theirs[n][:, 0], err_msg=n)
        assert np.mean(ours[n] == theirs[n]) >= 0.97, f"{n}: too many node flips"
    f, want = tstate.f.numpy(), np.asarray(jf)
    assert np.sqrt(np.mean((f - want) ** 2)) <= 0.01 * np.sqrt(np.mean(want ** 2))


def _identical(a, b) -> bool:
    return all(torch.equal(getattr(a.forest, n), getattr(b.forest, n))
               for n in ("feature", "threshold", "leaf_value", "n_trees")) \
        and torch.equal(a.f, b.f)


@pytest.fixture(scope="module")
def decisive():
    jdata = _decisive_data()
    return jdata, _port(jdata)


@pytest.fixture(scope="module")
def reference_run(decisive):
    """A reference ``AsyncRuntime`` run at W = 3, seed 2."""
    jcfg, _ = _cfgs()
    rt = JAsyncRuntime(jcfg, decisive[0], n_workers=3)
    return rt.run(seed=2)


def test_reference_trace_replays_in_the_port(decisive, reference_run, tmp_path):
    """A reference trace, loaded by the port, replays on the reference's
    draws to the reference's forest (the cross-package standard)."""
    jcfg, tcfg = _cfgs()
    jstate, jtrace = reference_run
    trace = RunTrace.load(jtrace.save(tmp_path / "ref.json"))
    state, losses = replay_trace(tcfg, decisive[1], trace,
                                 draws=_reference_draws(jcfg, decisive[0], jtrace.seed))
    _cross_standard(state, jstate.forest, jstate.f)
    assert losses.shape == (ROUNDS,) and torch.isfinite(losses).all()


def test_port_trace_replays_in_the_reference(decisive, tmp_path):
    """A port run at W = 4 on the reference's draws: its trace, loaded by
    the reference, replays there to the port's forest (the cross-package
    standard); within the port it replays bitwise."""
    jcfg, tcfg = _cfgs()
    draws = _reference_draws(jcfg, decisive[0], 3)
    rt = AsyncRuntime(tcfg, decisive[1], n_workers=4, draws=draws)
    state, trace = rt.run(seed=3)
    assert _identical(state, rt.replay(trace)[0])
    jtrace = JRunTrace.load(trace.save(tmp_path / "port.json"))
    jstate, _ = jreplay_trace(jcfg, decisive[0], jtrace)
    _cross_standard(state, jstate.forest, jstate.f)


def test_traces_cross_with_equal_summaries(decisive, reference_run, tmp_path):
    """Either package loads the other's trace file: every row, the events,
    ``summary`` and ``staleness_histogram`` equal; the saved JSON has the
    same fields."""
    _, tcfg = _cfgs()
    _, jtrace = reference_run
    ttrace = RunTrace.load(jtrace.save(tmp_path / "ref.json"))
    rt = AsyncRuntime(tcfg, decisive[1], n_workers=2, shard_pulls=4)
    _, own = rt.run(seed=1)
    back = JRunTrace.load(own.save(tmp_path / "port.json"))
    for a, b in ((jtrace, ttrace), (back, own)):
        for name in ("schedule", "key_index", "worker", "epoch", "pull_bytes", "step_scale",
                     "t_build", "t_queue", "t_fold"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
        assert a.summary() == b.summary()
        assert a.staleness_histogram() == b.staleness_histogram()
        assert a.events == b.events and a.n_parts == b.n_parts
    assert set(json.loads((tmp_path / "port.json").read_text())) == \
        set(json.loads((tmp_path / "ref.json").read_text()))


def test_golden_trace_replays_to_the_committed_forest():
    """``tests/golden/run_trace.json`` (a reference W = 3 run, seed 5)
    replayed through the port on the reference's draws gives the forest
    committed in ``tests/golden/ckpt`` (the cross-package standard)."""
    jcfg, jdata = regen.golden_config(), regen.golden_data()
    tcfg = SGBDTConfig(n_trees=jcfg.n_trees, step_length=jcfg.step_length,
                       sampling_rate=jcfg.sampling_rate, loss=jcfg.loss,
                       learner=LearnerConfig(depth=jcfg.learner.depth,
                                             n_bins=jcfg.learner.n_bins,
                                             hist_mode=jcfg.learner.hist_mode))
    trace = RunTrace.load(GOLDEN / "run_trace.json")
    state, _ = replay_trace(tcfg, _port(jdata), trace,
                            draws=_reference_draws(jcfg, jdata, trace.seed))
    committed = jckpt.restore_pytree(
        GOLDEN / "ckpt", regen.GOLDEN_STEP,
        jax.tree.map(np.asarray, _jax_like(jcfg, jdata)))
    _cross_standard(state, committed.forest, committed.f, strict=True)


def _jax_like(jcfg, jdata):
    from repro.core.sgbdt import init_state

    return init_state(jcfg, jdata)


def test_reference_runtime_checkpoint_replays_in_the_port(decisive, tmp_path):
    """A reference run halted at fold 5 (checkpoints at 3 and 5, the held
    stale versions in them) and resumed: the port's
    ``replay_from_checkpoint`` restores the reference's checkpoint and
    replays the trace suffix to the reference's forest (the cross-package
    standard).

    The reference's race realizes a different schedule on every run. On
    some a node meets an exact tie in f64 between two splits, which the two
    packages' f32 sums break apart (``tools/runtime_schedule_ties.py``: 6
    of 480 sampled runs, each at one node whose two gains are equal in
    f64). So both learners here ask for a child mass of 10, as the reverse
    test below does: none of 480 sampled runs then parts the packages."""
    jcfg, tcfg = (c._replace(learner=c.learner._replace(min_child_hess=10.0))
                  for c in _cfgs())
    ck = tmp_path / "ck"
    rt = JAsyncRuntime(jcfg, decisive[0], n_workers=3)
    _, prefix = rt.run(seed=4, checkpoint_dir=ck, checkpoint_every=3, halt_at_fold=5)
    jstate, combined = JAsyncRuntime(jcfg, decisive[0], n_workers=2).resume(prefix, ck)
    trace = RunTrace.load(combined.save(tmp_path / "t.json"))
    port = AsyncRuntime(tcfg, decisive[1], n_workers=2,
                        draws=_reference_draws(jcfg, decisive[0], 4))
    _cross_standard(port.replay_from_checkpoint(ck, trace), jstate.forest, jstate.f)


def test_port_runtime_checkpoint_replays_in_the_reference(decisive, tmp_path):
    """The reverse: a port run (on the reference's draws) halted at fold 5
    with checkpoints, resumed; the reference restores the port's
    checkpoint and replays the suffix to the port's forest (the
    cross-package standard); the port's own replay is bitwise.

    The race realizes a different schedule on every run. On some (22% of
    1277 sampled) a level-2 node holds 7 drawn samples that two features
    split as mirror images: an exact tie in exact arithmetic, which the
    two packages' f32 sums break apart, and the mirrored split routes the
    node's undrawn samples elsewhere (F 1.7-2.5% RMS apart). So both
    learners here ask for a child mass of 10 (eight drawn samples at
    weight 1.25), which no such node has: the splits stay decisive under
    every sampled schedule."""
    jcfg, tcfg = (c._replace(learner=c.learner._replace(min_child_hess=10.0))
                  for c in _cfgs())
    ck = tmp_path / "ck"
    draws = _reference_draws(jcfg, decisive[0], 6)
    rt = AsyncRuntime(tcfg, decisive[1], n_workers=3, draws=draws)
    _, prefix = rt.run(seed=6, checkpoint_dir=ck, checkpoint_every=3, halt_at_fold=5)
    state, combined = AsyncRuntime(tcfg, decisive[1], n_workers=2, draws=draws).resume(
        prefix, ck)
    assert _identical(state, rt.replay_from_checkpoint(ck, combined))
    jtrace = JRunTrace.load(combined.save(tmp_path / "t.json"))
    jstate = JAsyncRuntime(jcfg, decisive[0], n_workers=2).replay_from_checkpoint(ck, jtrace)
    _cross_standard(state, jstate.forest, jstate.f)


# --------------------------------------------------- the port's own forms
@pytest.fixture(scope="module")
def small():
    data = tsyn.make_sparse_classification(400, 60, 6, seed=5, device="cpu")
    cfg = SGBDTConfig(n_trees=12, step_length=0.3, sampling_rate=0.8,
                      learner=LearnerConfig(depth=3, n_bins=64))
    return cfg, data


def test_round_draws_are_independent_of_thread_and_order(small):
    """Ticket i's draws are a pure function of (seed, i): drawn in order on
    this thread, or in reverse from 4 threads at once, the same bits; other
    tickets and seeds differ."""
    cfg, data = small
    want = [round_draws(cfg, data, 7, i) for i in range(12)]
    got = {}

    def body(t):
        for i in reversed(range(t, 12, 4)):
            got[i] = round_draws(cfg, data, 7, i)

    threads = [threading.Thread(target=body, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    for i in range(12):
        assert all(torch.equal(a, b) for a, b in zip(want[i], got[i])), i
    m0, q0, mask0 = want[0]
    assert torch.equal(q0, m0 > 0) and m0.dtype == torch.float32 and mask0.dtype == torch.bool
    assert not torch.equal(want[1][0], m0)
    assert not torch.equal(round_draws(cfg, data, 8, 0)[0], m0)
    assert round_seed(7, 0) != round_seed(0, 7) and 0 <= round_seed(7, 0) < 2**63


@pytest.mark.parametrize("workers", [1, 4])
def test_scan_with_equals_train_and_the_replay_of_round_robin(small, workers):
    """``train(("round_robin", W))`` and ``scan_with`` over
    ``worker_round_robin`` with the identity ticket order give the same
    forest bit for bit; the per-round losses are each round's loss."""
    from repro_torch.ps.schedules import worker_round_robin

    cfg, data = small
    looped = train(cfg, data, ("round_robin", workers), seed=3)
    sched = worker_round_robin(cfg.n_trees, workers)
    scanned, losses = Trainer(cfg, device="cpu").scan_with(
        data, sched, np.arange(cfg.n_trees), workers, seed=3)
    assert _identical(looped, scanned)
    assert losses[-1] == train_loss(cfg, data, looped)
    via_shim, shim_losses = async_sgbdt.train_async_scan(
        cfg, data, sched, np.arange(cfg.n_trees), workers, seed=3)
    assert _identical(looped, via_shim) and torch.equal(losses, shim_losses)
    assert _identical(looped, async_sgbdt.train_async(cfg, data, sched, seed=3))
    ts, ts_losses = Trainer(cfg, device="cpu").train_scan(data, ("round_robin", workers), 3)
    assert _identical(looped, ts) and torch.equal(losses, ts_losses)


def test_scan_with_rejects_bad_tickets_and_rings(small):
    cfg, data = small
    trainer = Trainer(cfg, device="cpu")
    sched = np.maximum(0, np.arange(cfg.n_trees) - 3)
    with pytest.raises(ValueError, match="key_index"):
        trainer.scan_with(data, sched, np.arange(cfg.n_trees - 1), 4)
    with pytest.raises(ValueError, match="ring_size"):
        trainer.scan_with(data, sched, np.arange(cfg.n_trees), 3)


@pytest.mark.parametrize("objective,workers,rho", [("logistic", 4, 0.0),
                                                   ("logistic", 3, 0.1),
                                                   ("multiclass:3", 4, 0.0)])
def test_train_worker_parallel_equals_the_loop(objective, workers, rho):
    """The pool a block at a time equals ``train(("round_robin", W))`` bit
    for bit, K > 1 and the adaptive step included."""
    if objective == "logistic":
        data = tsyn.make_sparse_classification(400, 60, 6, seed=5, device="cpu")
    else:
        data = tsyn.make_multiclass_classification(300, 20, 3, seed=2, device="cpu")
    cfg = SGBDTConfig(n_trees=10, step_length=0.3, sampling_rate=0.8, objective=objective,
                      adaptive_step=rho, learner=LearnerConfig(depth=3, n_bins=64))
    seen = []
    par = train_worker_parallel(cfg, data, workers, seed=1, eval_every=4,
                                eval_fn=lambda st, j: seen.append(j))
    assert _identical(par, train(cfg, data, ("round_robin", workers), seed=1))
    blocks = [(b0, min(b0 + workers, 10)) for b0 in range(0, 10, workers)]
    assert seen == [b1 for b0, b1 in blocks if b1 // 4 > b0 // 4]  # block ends past 4k



def test_build_trees_batched_stacks_each_lanes_propose_tree(small):
    """A block's lanes: each is ``propose_tree`` on its own (target, draws),
    stacked on a leading W axis, bit for bit."""
    cfg, data = small
    f0 = init_state(cfg, data).f
    targets = [f0 + 0.1 * k for k in range(3)]
    draws = [round_draws(cfg, data, 4, i) for i in range(3)]
    trees, deltas = build_trees_batched(cfg, data, targets, draws)
    assert deltas.shape == (3, data.n_samples)
    for lane, (target, d) in enumerate(zip(targets, draws)):
        m_prime, _, feat_mask = unpack_draws(d)
        tree, delta = propose_tree(cfg, data, target, None, m_prime, feat_mask)
        assert all(torch.equal(a[lane], b) for a, b in zip(trees, tree))
        assert torch.equal(deltas[lane], delta)

def test_one_worker_run_is_the_loop_under_its_realized_schedule(small):
    """One worker folds its tickets in order, and its pulls never go back
    (k(j) is non-decreasing; how far the worker runs ahead of the server's
    folds is the race's): the threaded forest is the loop's under that
    realized schedule, bit for bit."""
    cfg, data = small
    state, trace = AsyncRuntime(cfg, data, n_workers=1).run(seed=9)
    assert trace.key_index.tolist() == list(range(cfg.n_trees))
    assert (np.diff(trace.schedule) >= 0).all() and trace.schedule[0] == 0
    assert _identical(state, train(cfg, data, trace.schedule, seed=9))


# -------------------------------------------------------------------- CLI
def test_train_cli_threads_verify_replay_and_resume(tmp_path, capsys):
    """``--runtime threads --device cpu`` with a trace, checkpoints every 3
    folds, ``--verify-resume`` and ``--verify-replay``: exits clean with
    both identities True and a loadable trace."""
    trace_path = tmp_path / "trace.json"
    state, trace = ttrain.main([
        "--arch", "gbdt", "--device", "cpu", "--runtime", "threads", "--steps", "6",
        "--workers", "4", "--verify-replay", "--trace-out", str(trace_path),
        "--checkpoint-dir", str(tmp_path / "ck"), "--checkpoint-every", "3",
        "--verify-resume", "--shard-pulls", "8", "--adaptive-step", "0.1"])
    out = capsys.readouterr().out
    assert "REAL worker threads" in out and "device=cpu" in out
    assert "record-and-replay identical forest: True" in out
    assert "checkpoint + trace-suffix replay identical: True" in out
    assert "sharded pulls (P=8)" in out and "adaptive step (rho=0.1)" in out
    assert RunTrace.load(trace_path).n_trees == 6 == state.step
    assert tckpt.steps(tmp_path / "ck") == [3, 6]


def test_train_cli_threads_halt_then_resume(tmp_path, capsys):
    """``--halt-at-fold 3`` leaves a prefix trace and checkpoints;
    ``--resume-from`` finishes the run on 2 workers with a crash fault and
    ``--verify-resume``; the combined trace replays bitwise."""
    common = ["--arch", "gbdt", "--device", "cpu", "--runtime", "threads", "--steps", "6",
              "--checkpoint-dir", str(tmp_path / "ck"), "--trace-out",
              str(tmp_path / "t.json")]
    ttrain.main([*common, "--workers", "3", "--checkpoint-every", "2",
                 "--halt-at-fold", "3"])
    assert "halted at fold 3" in capsys.readouterr().out
    assert RunTrace.load(tmp_path / "t.json").n_trees == 3
    state, trace = ttrain.main([*common, "--workers", "2", "--resume-from",
                                str(tmp_path / "t.json"), "--verify-resume"])
    out = capsys.readouterr().out
    assert "resuming from trace prefix" in out
    assert "checkpoint + trace-suffix replay identical: True" in out
    assert trace.events[-1]["kind"] == "resume" and trace.n_trees == 6


def test_train_cli_threads_refuses_replay_of_a_halted_prefix(tmp_path):
    with pytest.raises(SystemExit, match="complete run"):
        ttrain.main(["--arch", "gbdt", "--device", "cpu", "--runtime", "threads", "--steps",
                     "4", "--workers", "2", "--halt-at-fold", "2", "--verify-replay"])
    with pytest.raises(SystemExit, match="checkpoint-dir"):
        ttrain.main(["--arch", "gbdt", "--device", "cpu", "--runtime", "threads", "--steps",
                     "4", "--workers", "2", "--checkpoint-every", "2"])


def test_train_cli_scan_prints_the_round_losses(capsys):
    """``--scan``: the explicit-schedule form, the first and last rounds'
    losses printed as the reference prints them, the forest the loop's."""
    state = ttrain.main(["--arch", "gbdt", "--device", "cpu", "--steps", "3", "--workers",
                         "2", "--scan"])
    out = capsys.readouterr().out
    assert "(scan form" in out and "loss " in out and " -> " in out
    cfg = ttrain.gbdt_config("logistic", 3)
    _, data = ttrain.gbdt_dataset_for("logistic", 0, device="cpu")
    assert _identical(state, train(cfg, data, ("round_robin", 2)))
