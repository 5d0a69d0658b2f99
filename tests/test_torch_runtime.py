"""The port's host-async PS runtime (``repro_torch.ps.runtime``) on the CPU,
held to its own contracts, as ``tests/test_runtime.py`` holds the JAX
package's:

  * record-and-replay: a threaded run's realized (k(j), ticket) trace,
    replayed through ``Trainer.scan_with``, gives the same ``feature``,
    ``threshold``, ``leaf_value`` and ``f`` bit for bit, at W = 4 and for
    K = 5, after faults, after halt and resume, under sharded pulls and
    under the adaptive step;
  * the realized schedule is a valid causal k(j) and the tickets a
    permutation;
  * the v1/v2 trace schema: JSON round trips, v1 loads, unknown versions
    and fields fail loudly;
  * the kernel wrappers' launch counts stay exact under 8 threads, the
    split decision keeps one workspace a stream, and a library loads once
    however many threads ask for it first.

Sizes: N 600, F 150, depth 4, 24 trees (a run takes well under a second).
"""
import json
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import steps as ckpt_steps
from repro_torch.core.sgbdt import SGBDTConfig, init_state, train_loss
from repro_torch.core.simulator import crossvalidate_schedule, staleness_stats
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels import _build, split_scan
from repro_torch.ps import AsyncRuntime, FaultPlan, RunTrace, replay_trace, resolve_schedule
from repro_torch.trees.learner import LearnerConfig


@pytest.fixture(scope="module", autouse=True)
def one_op_thread():
    """Each worker thread runs its ops on one CPU thread: four workers of
    the runtime beside the suite's other processes would oversubscribe the
    cores with torch's intra-op pools."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def sparse_data():
    return tsyn.make_sparse_classification(600, 150, 8, seed=3, device="cpu")


@pytest.fixture(scope="module")
def rt_cfg():
    return SGBDTConfig(n_trees=24, step_length=0.3, sampling_rate=0.8,
                       learner=LearnerConfig(depth=4, n_bins=64))


def _identical(a, b) -> bool:
    return all(torch.equal(getattr(a.forest, n), getattr(b.forest, n))
               for n in ("feature", "threshold", "leaf_value", "n_trees")) \
        and torch.equal(a.f, b.f)


@pytest.fixture(scope="module")
def threaded_run(rt_cfg, sparse_data):
    rt = AsyncRuntime(rt_cfg, sparse_data, n_workers=4)
    state, trace = rt.run(seed=0)
    return rt, state, trace


def test_record_and_replay_identical_forest(rt_cfg, sparse_data, threaded_run):
    rt, state, trace = threaded_run
    st_replay, losses = rt.replay(trace)
    assert _identical(state, st_replay)
    assert losses.shape == (rt_cfg.n_trees,)
    st_again, _ = replay_trace(rt_cfg, sparse_data, trace)  # a fresh Trainer
    assert _identical(state, st_again)


def test_builds_overlap_across_workers(rt_cfg, sparse_data):
    """The workers do not take turns: with every build held open for 50 ms
    (a sleep inside the build phase, which drops the GIL), four workers'
    builds overlap, the concurrency (sum t_build / makespan) exceeds 2 and
    the mean staleness comes near W - 1; the trace still replays bitwise."""
    rt = AsyncRuntime(rt_cfg, sparse_data, n_workers=4, worker_delay=[0.05] * 4)
    state, trace = rt.run(seed=0)
    assert float(trace.t_build.sum()) / trace.makespan > 2.0
    assert trace.summary()["mean_staleness"] > 2.0
    assert _identical(state, rt.replay(trace)[0])


def test_trace_is_valid_schedule(rt_cfg, threaded_run):
    _, state, trace = threaded_run
    resolve_schedule(trace.schedule, rt_cfg.n_trees)
    assert sorted(trace.key_index.tolist()) == list(range(rt_cfg.n_trees))
    assert set(trace.worker.tolist()) <= set(range(4))
    assert trace.makespan > 0 and (trace.t_build > 0).all()
    assert sum(trace.staleness_histogram().values()) == rt_cfg.n_trees
    assert state.step == rt_cfg.n_trees and int(state.forest.n_trees) == rt_cfg.n_trees


def test_trace_json_roundtrip_and_replay(rt_cfg, sparse_data, threaded_run, tmp_path):
    _, state, trace = threaded_run
    back = RunTrace.load(trace.save(tmp_path / "trace.json"))
    assert back.n_workers == trace.n_workers and back.seed == trace.seed
    for name in ("schedule", "key_index", "worker", "epoch", "pull_bytes", "step_scale"):
        np.testing.assert_array_equal(getattr(back, name), getattr(trace, name))
    np.testing.assert_allclose(back.t_build, trace.t_build)
    assert back.makespan == pytest.approx(trace.makespan)
    assert _identical(state, replay_trace(rt_cfg, sparse_data, back)[0])


def test_straggler_shifts_staleness(rt_cfg, sparse_data):
    """One slow worker's pushes are staler than the fast workers', and the
    run still trains."""
    rt = AsyncRuntime(rt_cfg, sparse_data, n_workers=4, worker_delay={0: 0.1})
    state, trace = rt.run(seed=0)
    from_straggler = trace.worker == 0
    assert from_straggler.any() and from_straggler.sum() < (~from_straggler).sum()
    stale = trace.staleness
    assert stale[from_straggler].mean() > stale[~from_straggler].mean()
    l0 = float(train_loss(rt_cfg, sparse_data, init_state(rt_cfg, sparse_data)))
    assert float(train_loss(rt_cfg, sparse_data, state)) < 0.9 * l0


def test_crossvalidation_helpers(threaded_run):
    _, _, trace = threaded_run
    stats = staleness_stats(trace.schedule)
    assert stats["mean_staleness"] == pytest.approx(float(trace.staleness.mean()))
    xval = crossvalidate_schedule(trace.schedule, trace.cluster_spec(),
                                  makespan=trace.makespan)
    assert xval["realized"]["mean_staleness"] == stats["mean_staleness"]
    assert xval["realized_makespan"] == pytest.approx(trace.makespan)
    assert xval["makespan_ratio"] > 0
    assert trace.crossvalidate()["realized"] == stats


def test_multioutput_replay():
    """K = 5: stacked tree groups, one push each, replay bitwise."""
    data = tsyn.make_multiclass_classification(300, 20, 5, seed=11, device="cpu")
    cfg = SGBDTConfig(n_trees=8, step_length=0.2, sampling_rate=0.9,
                      objective="multiclass:5", learner=LearnerConfig(depth=3, n_bins=64))
    rt = AsyncRuntime(cfg, data, n_workers=4)
    state, trace = rt.run(seed=1)
    assert _identical(state, rt.replay(trace)[0])
    assert int(state.forest.n_trees) == 40 and state.f.shape == (300, 5)


def test_runtime_rejects_bad_args(rt_cfg, sparse_data, threaded_run):
    with pytest.raises(ValueError):
        AsyncRuntime(rt_cfg, sparse_data, n_workers=0)
    with pytest.raises(ValueError, match="rounds"):
        replay_trace(rt_cfg._replace(n_trees=rt_cfg.n_trees + 1), sparse_data,
                     threaded_run[2])
    with pytest.raises(ValueError, match="halt_at_fold"):
        AsyncRuntime(rt_cfg, sparse_data, n_workers=2).run(halt_at_fold=0)


# ---------------------------------------------------- elastic + fault injection
@pytest.fixture(scope="module")
def fault_run(rt_cfg, sparse_data):
    """W = 4 with a crash (ticket 5), a graceful leave (ticket 9) and a join
    of worker 7 at fold 10."""
    plan = FaultPlan(crash_tickets={5}, leave_tickets={9}, join_at={7: 10})
    rt = AsyncRuntime(rt_cfg, sparse_data, n_workers=4, faults=plan)
    state, trace = rt.run(seed=0)
    return rt, state, trace


def test_fault_plan_validation(rt_cfg, sparse_data):
    with pytest.raises(ValueError):
        FaultPlan(crash_tickets={3}, leave_tickets={3})
    with pytest.raises(ValueError):
        FaultPlan(crash_tickets={-1})
    with pytest.raises(ValueError):
        FaultPlan(join_at={1: -2})
    with pytest.raises(ValueError):
        AsyncRuntime(rt_cfg, sparse_data, n_workers=2,
                     faults=FaultPlan(join_at={5: rt_cfg.n_trees + 1}))


def test_membership_events_recorded(rt_cfg, fault_run):
    _, _, trace = fault_run
    by_kind = {e["kind"]: e for e in trace.events}
    assert set(by_kind) == {"crash", "leave", "join"}
    assert by_kind["crash"]["ticket"] == 5 and by_kind["leave"]["ticket"] == 9
    assert by_kind["join"]["worker"] == 7 and by_kind["join"]["fold"] >= 10
    assert trace.n_epochs == 4 and trace.epoch.min() == 0
    assert sorted(trace.key_index.tolist()) == list(range(rt_cfg.n_trees))
    assert 7 in set(trace.worker.tolist())
    assert sorted(trace.membership_deltas()) == sorted([
        (by_kind["crash"]["fold"], -1), (by_kind["leave"]["fold"], -1),
        (by_kind["join"]["fold"], 1)])


def test_elastic_trace_replays_bitwise(rt_cfg, sparse_data, fault_run):
    _, state, trace = fault_run
    assert _identical(state, replay_trace(rt_cfg, sparse_data, trace)[0])


def test_fault_plan_is_deterministic(rt_cfg, sparse_data):
    """Crash and leave key off tickets, not timing: the same plan gives the
    same event set, and each run replays bitwise."""
    plan = FaultPlan(crash_tickets={2}, leave_tickets={6})
    for _ in range(2):
        rt = AsyncRuntime(rt_cfg, sparse_data, n_workers=3, faults=plan)
        state, trace = rt.run(seed=0)
        assert [(e["kind"], e["ticket"]) for e in trace.events] == [("crash", 2),
                                                                    ("leave", 6)]
        assert sorted(trace.key_index.tolist()) == list(range(rt_cfg.n_trees))
        assert _identical(state, rt.replay(trace)[0])


def test_all_workers_dead_is_a_loud_error(rt_cfg, sparse_data):
    rt = AsyncRuntime(rt_cfg, sparse_data, n_workers=2,
                      faults=FaultPlan(crash_tickets={0, 1}))
    with pytest.raises(RuntimeError, match="no live workers"):
        rt.run(seed=0)


def test_worker_failure_fails_the_run(rt_cfg, sparse_data, monkeypatch):
    """A worker's exception ends the run with it, as the reference's does."""
    rt = AsyncRuntime(rt_cfg, sparse_data, n_workers=2)
    calls = []
    propose = rt._propose

    def failing(*a):
        calls.append(1)
        if len(calls) > 3:  # after the warm-up
            raise FloatingPointError("planted")
        return propose(*a)

    monkeypatch.setattr(rt, "_propose", failing)
    with pytest.raises(RuntimeError, match="async worker failed") as err:
        rt.run(seed=0)
    assert isinstance(err.value.__cause__, FloatingPointError)


# ------------------------------------------------------------- trace schema
_V2_ONLY = ("epoch", "pull_bytes", "step_scale", "events", "n_parts", "full_pull_bytes",
            "adaptive_rho")


def test_trace_v1_still_loads(tmp_path, threaded_run):
    _, _, trace = threaded_run
    d = trace.to_json()
    d["trace_version"] = 1
    for key in _V2_ONLY:
        d.pop(key)
    path = tmp_path / "v1.json"
    path.write_text(json.dumps(d))
    back = RunTrace.load(path)
    np.testing.assert_array_equal(back.schedule, trace.schedule)
    assert back.events == () and back.n_epochs == 1
    assert (back.step_scale == 1.0).all() and back.adaptive_rho == 0.0


@pytest.mark.parametrize("version", [99, None])
def test_trace_unknown_version_fails_loudly(tmp_path, threaded_run, version):
    d = threaded_run[2].to_json()
    if version is None:
        d.pop("trace_version")
    else:
        d["trace_version"] = version
    path = tmp_path / "bad.json"
    path.write_text(json.dumps(d))
    with pytest.raises(ValueError, match="unknown RunTrace schema version"):
        RunTrace.load(path)


@pytest.mark.parametrize("version", [1, 2])
def test_trace_unknown_field_fails_loudly(tmp_path, threaded_run, version):
    d = threaded_run[2].to_json()
    if version == 1:
        for key in _V2_ONLY:
            d.pop(key)
    d["trace_version"] = version
    d["mystery"] = 1
    path = tmp_path / f"bad_{version}.json"
    path.write_text(json.dumps(d))
    with pytest.raises(ValueError, match="mystery"):
        RunTrace.load(path)


# ------------------------------------------------------------- sharded pulls
@pytest.mark.parametrize("parts", [16, 600])
def test_sharded_pulls_count_bytes_and_replay_bitwise(rt_cfg, sparse_data, parts):
    """Each pull's bytes are a recount from its ticket's sample (4 bytes a
    pulled row, the request bitmap), and the run replays bitwise through
    the full-table engine."""
    from repro_torch.ps.engine import round_draws

    rt = AsyncRuntime(rt_cfg, sparse_data, n_workers=4, shard_pulls=parts)
    state, trace = rt.run(seed=0)
    assert trace.n_parts == parts and trace.full_pull_bytes == 4 * 600
    sizes = np.full(parts, 600 // parts)
    sizes[: 600 % parts] += 1
    part = np.repeat(np.arange(parts), sizes)
    for j, i in enumerate(trace.key_index.tolist()):
        q_any = round_draws(rt_cfg, sparse_data, 0, i)[1].numpy()
        touched = np.zeros(parts, bool)
        touched[part[q_any]] = True
        assert trace.pull_bytes[j] == 4 * sizes[touched].sum() + (parts + 7) // 8
    if parts == 600:
        assert trace.summary()["pull_reduction"] > 0.05
    assert _identical(state, replay_trace(rt_cfg, sparse_data, trace)[0])


def test_sharded_pulls_gated_to_rowwise_objectives():
    data = tsyn.make_ranking(8, 16, 40, seed=0, device="cpu")
    cfg = SGBDTConfig(n_trees=4, step_length=0.2, sampling_rate=0.9, objective="lambdarank",
                      learner=LearnerConfig(depth=3, n_bins=32))
    with pytest.raises(ValueError, match="not rowwise"):
        AsyncRuntime(cfg, data, n_workers=2, shard_pulls=4)


def test_sharded_pulls_bounds(rt_cfg, sparse_data):
    with pytest.raises(ValueError, match="shard_pulls"):
        AsyncRuntime(rt_cfg, sparse_data, n_workers=2, shard_pulls=601)


# ------------------------------------------------------------- crash-resume
def test_halt_resume_replay_parity(rt_cfg, sparse_data, tmp_path):
    """Halt mid-run, resume from the on-disk trace prefix + checkpoints:
    the combined trace replays bitwise from scratch, and the final state
    rebuilds bitwise from checkpoint + trace suffix."""
    ck, tr = tmp_path / "ck", tmp_path / "trace.json"
    rt = AsyncRuntime(rt_cfg, sparse_data, n_workers=4)
    _, prefix = rt.run(seed=0, checkpoint_dir=ck, checkpoint_every=5, halt_at_fold=13,
                       trace_path=tr)
    assert prefix.n_trees == 13 and ckpt_steps(ck) == [5, 10, 13]
    on_disk = RunTrace.load(tr)
    np.testing.assert_array_equal(on_disk.schedule, prefix.schedule)
    rt2 = AsyncRuntime(rt_cfg, sparse_data, n_workers=4)
    state, combined = rt2.resume(on_disk, ck)
    assert combined.n_trees == rt_cfg.n_trees
    np.testing.assert_array_equal(combined.schedule[:13], prefix.schedule)
    np.testing.assert_array_equal(combined.key_index[:13], prefix.key_index)
    assert combined.events[-1]["kind"] == "resume" and combined.events[-1]["fold"] == 13
    assert _identical(state, replay_trace(rt_cfg, sparse_data, combined)[0])
    assert _identical(state, rt2.replay_from_checkpoint(ck, combined))


def test_resume_reissues_lost_inflight_tickets(rt_cfg, sparse_data, tmp_path):
    ck = tmp_path / "ck"
    rt = AsyncRuntime(rt_cfg, sparse_data, n_workers=4)
    _, prefix = rt.run(seed=0, checkpoint_dir=ck, checkpoint_every=6, halt_at_fold=9)
    folded = set(prefix.key_index.tolist())
    rt2 = AsyncRuntime(rt_cfg, sparse_data, n_workers=2)  # elastic: W = 4 -> 2
    state, combined = rt2.resume(prefix, ck)
    assert sorted(combined.key_index[9:].tolist()) == sorted(set(range(24)) - folded)
    assert set(combined.worker[9:].tolist()) <= {0, 1}
    assert _identical(state, rt2.replay(combined)[0])
    with pytest.raises(ValueError, match="no checkpoint"):
        rt2.resume(prefix, tmp_path / "empty")
    with pytest.raises(ValueError, match="nothing to resume"):
        rt2.resume(combined, ck)


# ------------------------------------------------------------- adaptive step
def test_adaptive_step_scales_recorded_and_replayed(rt_cfg, sparse_data):
    acfg = rt_cfg._replace(adaptive_step=0.05)
    rt = AsyncRuntime(acfg, sparse_data, n_workers=4)
    state, trace = rt.run(seed=0)
    assert trace.adaptive_rho == 0.05
    tau = trace.staleness.astype(np.float32)
    expect = np.float32(1.0) / (np.float32(1.0) + np.float32(6.0 * 0.05) * tau)
    np.testing.assert_array_equal(trace.step_scale, expect)
    assert (trace.step_scale[tau > 0] < 1.0).all()
    assert trace.summary()["step_scale_mean"] == pytest.approx(float(expect.mean()))
    assert _identical(state, replay_trace(acfg, sparse_data, trace)[0])
    with pytest.raises(ValueError, match="adaptive_rho"):
        replay_trace(rt_cfg, sparse_data, trace)


# ------------------------------------------- kernel wrappers under threads
@pytest.fixture
def fast_switching():
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        yield
    finally:
        sys.setswitchinterval(old)


def _run_threads(n, target):
    threads = [threading.Thread(target=target, args=(t,)) for t in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)


def test_launch_counts_stay_exact_under_8_threads(fast_switching, monkeypatch):
    """8 threads, each on a stream of its own, launch the split decision's
    wrapper 300 times (a stand-in entry point on CPU tensors): the count is
    exact, and each stream gets one workspace of its own, reused."""
    monkeypatch.setattr(_build, "function", lambda *a, **k: (lambda *args: 0))
    local = threading.local()  # thread idents may be reused; the streams may not
    monkeypatch.setattr(_build, "stream_of", lambda dev: local.stream)
    monkeypatch.setattr(split_scan, "_WORK", {})
    monkeypatch.setattr(split_scan, "launches", 0)
    hist = torch.zeros((2, 4, 3, 8))
    mask = torch.ones(3, dtype=torch.int32)
    seen = {}

    def body(t):
        local.stream = 1000 + t
        for _ in range(300):
            split_scan._launch(hist, 1.0, 1e-3, mask)
        seen[t] = _build.stream_of(hist.device)

    _run_threads(8, body)
    assert split_scan.launches == 8 * 300
    keys = set(split_scan._WORK)
    assert keys == {(hist.device, s) for s in seen.values()} and len(keys) == 8
    assert len({id(w) for w in split_scan._WORK.values()}) == 8


def test_library_loads_once_under_8_threads(fast_switching, monkeypatch):
    """8 threads' first use of a library builds and opens it once."""
    import time

    builds, opens = [], []

    def build_all():
        builds.append(1)
        time.sleep(0.05)
        return {"fake_lib": "libfake.so"}

    class FakeLib:
        def __init__(self, path):
            opens.append(path)
            self.sym = lambda *a: 0

    monkeypatch.setattr(_build, "build_all", build_all)
    monkeypatch.setattr(_build.ctypes, "CDLL", FakeLib)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_FUNCTIONS", {})
    got = []
    _run_threads(8, lambda t: got.append(_build.function("fake_lib", "sym", [])))
    assert len(builds) == len(opens) == 1 and len({id(f) for f in got}) == 1
