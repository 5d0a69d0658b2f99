"""The smoke test's yardsticks, on the CPU: the library call that a histogram
kernel is timed against computes the function on every repetition (a fresh
zeroed output, not sums piled up in one buffer), and a kernel's ``kernels``
line entry carries its main shape's stats with the largest error of all."""
import numpy as np
import pytest
import torch

import chip_smoke
from repro_torch.kernels import histogram


@pytest.fixture
def timed_calls(monkeypatch):
    """Run each timed function three times instead of timing it; collect
    the results; no device time is taken."""
    calls = []

    def fake_cuda_ms(fn, reps=20, warmup=2):
        calls.append([fn() for _ in range(3)])
        return 0.0

    monkeypatch.setattr(chip_smoke, "cuda_ms", fake_cuda_ms)
    monkeypatch.setattr(chip_smoke, "_PENDING", [])
    return calls


@pytest.mark.parametrize("n_nodes,subset", [(1, False), (8, True)])
def test_library_yardstick_computes_the_histogram_each_call(timed_calls, n_nodes, subset):
    rng = np.random.default_rng(n_nodes)
    n, f, b = 300, 7, 16
    bins = torch.from_numpy(rng.integers(0, b, (n, f)).astype(np.int32))
    node = torch.from_numpy(rng.integers(-1, n_nodes, n).astype(np.int32))
    grad = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    hess = torch.from_numpy(rng.random(n).astype(np.float32))
    active = torch.tensor([6, 1, 3], dtype=torch.int32) if subset else None
    rows = n_nodes if active is None else active.shape[0]
    want = histogram.histogram_plain(bins, node, grad, hess, n_nodes, b, active)
    # The cells as the smoke test builds them, before the timer starts.
    row_of = torch.full((n_nodes,), -1, dtype=torch.int64)
    row_of[torch.arange(n_nodes) if active is None else active.long()] = torch.arange(rows)
    r = torch.where(node >= 0, row_of[node.long().clamp(min=0)], -1)
    keep = r >= 0
    cell = ((r[:, None] * f + torch.arange(f)) * b + bins.long())[keep]
    seg = torch.cat([cell.reshape(-1), (cell + rows * f * b).reshape(-1)])
    vals = torch.cat([grad[keep][:, None].expand(-1, f).reshape(-1),
                      hess[keep][:, None].expand(-1, f).reshape(-1)])
    into = chip_smoke.library_times(seg, vals, 2 * rows * f * b, {})
    assert {"library_ms", "library_device_ms", "library_accumulating_ms"} <= set(into)
    library, accumulating = timed_calls
    for out in library:  # every repetition: the whole function, zeros included
        torch.testing.assert_close(out.reshape(want.shape), want, rtol=1e-5, atol=1e-6)
    # The PR-14 figure: one buffer, so the sums pile up across repetitions.
    torch.testing.assert_close(accumulating[-1].reshape(want.shape),
                               len(accumulating) * want, rtol=1e-5, atol=1e-5)


def test_line_stats_take_the_main_shape_and_the_largest_error():
    shapes = {"level0": {"ms": 1.0, "device_ms": 0.5, "max_abs_err": 3e-4,
                         "device_kernels": {"k": 0.5}, "entries_hit": 7},
              "level8": {"ms": 2.0, "device_ms": 1.5, "max_abs_err": 1e-4,
                         "device_kernels": {"k": 1.5}, "entries_hit": 3}}
    line = chip_smoke.line_stats(shapes, "level8", drop=("entries_hit",))
    assert line == {"ms": 2.0, "device_ms": 1.5, "max_abs_err": 3e-4}


@pytest.mark.parametrize("mode", [None, "int8", "fp16"])
def test_traversal_bound_counts_each_layout_s_bytes(mode):
    """Bytes: each bin cell a walk reads (counted here by a plain loop),
    each live tree's arrays in their packed types (and an int8 tree's
    scale), the live count and the (N, K) output; operations: depth compares
    and index steps a (sample, tree) pair, plus the int8 product."""
    rng = np.random.default_rng(1)
    n, f, depth, k, slots, live = 37, 9, 3, 2, 12, 7
    bins = torch.from_numpy(rng.integers(0, 16, (n, f)).astype(np.int32))
    fo = chip_smoke.forest_from_numpy(
        rng.integers(0, f, (slots, 7)), rng.integers(0, 16, (slots, 7)),
        rng.standard_normal((slots, 8)), live, np.zeros(k), device="cpu")
    if mode:
        fo = fo.quantize(mode)
    seen = set()
    for s in range(n):
        for t in range(live):
            node = 0
            for _ in range(depth):
                feat = int(fo.feature[t, node])
                seen.add((s, feat))
                node = 2 * node + 1 + int(bins[s, feat] > int(fo.threshold[t, node]))
    per_tree = {None: 4 * 7 + 4 * 7 + 4 * 8, "int8": 4 * 7 + 7 + 8 + 4,
                "fp16": 4 * 7 + 2 * 7 + 2 * 8}[mode]
    nbytes = 4 * len(seen) + live * per_tree + 4 + 4 * n * k
    ops = n * live * (3 * depth + 1 + (mode == "int8"))
    ms, by, cells = chip_smoke.traversal_bound(bins, fo, live)
    assert cells == len(seen)
    assert (ms, by) == chip_smoke.bound(nbytes, ops)


def test_traversal_form_checks_run_on_the_cpu(timed_calls, monkeypatch):
    """The new forms' checks at a few rows and 40 rounds' slots: every
    form's stats with the contract's keys, the serving wave's shape timed
    beside the full one, each shape's launch plan, and the ragged case."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    for name in ("CFG", "MC_CFG"):
        monkeypatch.setattr(chip_smoke, name, getattr(chip_smoke, name)._replace(n_trees=40))
    monkeypatch.setattr(chip_smoke, "RAGGED_LIVE", {"realsim": 23, "multiclass": 123})
    rng = np.random.default_rng(2)
    realsim = torch.from_numpy(rng.integers(0, 64, (24, 50)).astype(np.int32))
    multi = torch.from_numpy(rng.integers(0, 64, (24, 60)).astype(np.int32))
    report = {}
    stats = chip_smoke.check_traversal_forms(realsim, multi, rng, report)
    assert set(stats) == set(chip_smoke.TRAV_FORMS)
    for name, st in stats.items():
        assert st["max_abs_err"] == 0.0 and st["library_ms"] is None
        assert {"ms", "device_ms", "plain_ms", "bound_ms", "bound_by"} <= set(st)
        shapes = report["forest_traverse_form_shapes"][name]
        assert shapes["ragged"]["live"] % (5 if "k5" in name else 16) != 0
        assert {"ms", "device_ms", "plain_ms", "bound_ms"} <= set(shapes["wave"])
        assert "ms" not in shapes["ragged"]
        for st in shapes.values():
            plan = st["plan"]
            assert plan["slab"] >= st["rows"] and plan["samples"] % 32 == 0
            assert plan["grid"][1] == -(-st["rows"] // plan["samples"])
    # Two timed shapes a form (full and wave); device times taken later.
    assert len(chip_smoke._PENDING) == 2 * len(stats)
    line = chip_smoke.traversal_times({k: {**v, "device_ms": 0.0} for k, v in
                                       report["forest_traverse_form_shapes"][name].items()})
    assert line.startswith("full ") and "; wave " in line and "ragged" not in line


@pytest.mark.parametrize("fn,label", [
    ("_ZN52_GLOBAL__N__9310e880_19_forest_traversal_cu_951f366911walk_stagedIifLi2EEEvPKiPKhS3_"
     "S3_PKT_PKT0_PKfS3_Pfiiiiiiii", "walk_staged<ifLi2>"),
    ("_ZN52_GLOBAL__N__9310e880_19_forest_traversal_cu_951f366911walk_globalIs6__halfEEvPKiS3_"
     "PKT_PKT0_PKfS3_Pfiiiiii", "walk_global<s6__half>"),
    ("_ZN52_GLOBAL__N__9310e880_19_forest_traversal_cu_951f366913narrow_kernelEPKiPjPiiiii",
     "narrow_kernel"),
    ("_ZN52_GLOBAL__N__9310e880_19_forest_traversal_cu_951f366910sum_kernelEPKfPKiPfiii",
     "sum_kernel"),
])
def test_ptxas_traversal_labels(fn, label):
    assert chip_smoke.trav_label(fn) == label


def test_level_phases_split_a_fused_level_by_kernel():
    """Phase A is every histogram launch, B the decide kernel, C the route
    kernel, by the profiler's kernel names."""
    by_name = {"(anonymous namespace)::row_place_kernel(int const*, int)": 0.002,
               "void (anonymous namespace)::hist_kernel<8>(int const*, float)": 0.03,
               "(anonymous namespace)::level_decide_kernel(float*, float const*)": 0.01,
               "(anonymous namespace)::level_route_kernel(int const*, int const*)": 0.004}
    assert chip_smoke.level_phases(by_name) == pytest.approx({"A": 0.032, "B": 0.01, "C": 0.004})


def test_multiclass_kernel_checks_run_on_the_cpu(timed_calls, monkeypatch):
    """The histogram, split gain and fused level checks on multiclass data
    (a few hundred rows, F 12, K 5) at each of a depth-6 tree's levels:
    every level's stats with the contract's keys, the device times left
    pending, and the kernels-line stats taken at the deepest level."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    x, y = chip_smoke.synthetic.multiclass_xy(300, 12, 5, seed=1)
    data = chip_smoke.bin_dataset(x, y, n_bins=64, device="cpu")
    state = chip_smoke.init_state(chip_smoke.MC_CFG, data)
    report = {}
    shapes = chip_smoke.check_multiclass_kernels(data, state, report)
    levels = [f"level{lv}" for lv in range(chip_smoke.MC_CFG.learner.depth)]
    assert set(shapes) == {"histogram", "split_gain", "level_build"}
    for per in shapes.values():
        assert list(per) == levels
        for st in per.values():
            assert {"ms", "device_ms", "max_abs_err", "plain_ms", "bound_ms",
                    "bound_by", "library_ms"} <= set(st)
            assert st["device_ms"] is None
    assert report["multiclass_histogram_samples_hit"]["level0"] == 300
    # One pending device time per check, and one per histogram yardstick.
    assert len(chip_smoke._PENDING) == 4 * len(levels)
    line = chip_smoke.line_stats(shapes["level_build"], levels[-1],
                                 drop=("staged_ms", "samples_hit"))
    assert line["max_abs_err"] == max(st["max_abs_err"] for st in shapes["level_build"].values())


@pytest.mark.parametrize("scale_by,shift,passes", [
    ("gain", 0.0, True), ("gain", 3e-5, False),
    ("terms", 3e-5, True), ("terms", 0.1, False)])
def test_split_gain_tolerance_scales_with_its_terms(timed_calls, monkeypatch, scale_by, shift,
                                                    passes):
    """A node whose best gain (about 1) is a small difference of terms near
    200: two ulps of the terms (3e-5) pass when the atol scales with the
    terms and fail when it scales with the gain; an error of 0.1 fails
    both ways."""
    rng = np.random.default_rng(3)
    g = (200.0 / 64 + 0.05 * rng.standard_normal((2, 3, 64))).astype(np.float32)
    hist = torch.stack([torch.from_numpy(g), torch.full((2, 3, 64), 200.0 / 64)])
    plain = chip_smoke.split_scan.split_gain_plain(hist, 1.0, 1.0)
    fin = torch.isfinite(plain)
    assert float(plain[fin].abs().max()) < 5.0
    monkeypatch.setattr(chip_smoke.split_scan, "split_gain",
                        lambda *a: torch.where(fin, plain + shift, plain))
    if passes:
        chip_smoke.split_gain_case(hist, 1.0, 1.0, scale_by=scale_by)
    else:
        with pytest.raises(AssertionError, match="over tolerance"):
            chip_smoke.split_gain_case(hist, 1.0, 1.0, scale_by=scale_by)


PTXAS_LOG = [
    "ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async instructions are "
    "serialized due to the presence of Extern calls in the function '_Z7k_slowv'",
    "ptxas info    : (C7519) warpgroup.arrive is injected in around line 40 by compiler to "
    "allow use of registers in GMMA in function '_Z7k_fastv'",
    "ptxas info    : Function properties for _Z7k_fastv",
    "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
    "ptxas info    : Used 168 registers, used 16 barriers",
    "ptxas info    : Function properties for _Z7k_slowv",
    "    8 bytes stack frame, 12 bytes spill stores, 20 bytes spill loads",
    "ptxas info    : Used 255 registers, used 1 barriers, 1024 bytes smem",
]


def test_ptxas_kernels_reads_registers_spills_and_serialized_wgmma():
    """The smoke test's ptxas gate: registers and spill bytes a kernel, and
    the notice that serialized a kernel's wgmma (not the injected-fence
    notice, which costs nothing)."""
    got = {k["function"]: k for k in chip_smoke.ptxas_kernels(PTXAS_LOG)}
    assert got["_Z7k_fastv"] == {"function": "_Z7k_fastv", "registers": 168,
                                 "spill_stores": 0, "spill_loads": 0, "serialized": False}
    assert got["_Z7k_slowv"] == {"function": "_Z7k_slowv", "registers": 255,
                                 "spill_stores": 12, "spill_loads": 20, "serialized": True}


@pytest.mark.parametrize("fn,label", [
    ("_ZN12_GLOBAL__N_112split_kernelILi2ELb1EEEvN12_GLOBAL__N_19SplitArgsE",
     "split_kernel<2, decide>"),
    ("_ZN12_GLOBAL__N_112split_kernelILi8ELb0EEEvN12_GLOBAL__N_19SplitArgsE",
     "split_kernel<8, surface>"),
])
def test_ptxas_split_labels(fn, label):
    assert chip_smoke.split_label(fn) == label


@pytest.mark.parametrize("f,b", [(40, 64), (1500, 16)])
def test_split_decide_ties_run_on_the_cpu(f, b):
    """The smoke test's tie check through the decision form: the first of
    the planted maxima, then the next once it is masked."""
    chip_smoke.split_decide_ties(f, b, torch.device("cpu"))


def test_split_gain_case_rejects_a_wrong_decision(timed_calls, monkeypatch):
    """The decision must be the plain chain's on the kernel's own surface:
    a decision one cell off fails the check."""
    rng = np.random.default_rng(5)
    g = rng.standard_normal((3, 4, 16)).astype(np.float32)
    hist = torch.stack([torch.from_numpy(g), torch.full((3, 4, 16), 1.25)])
    mask = torch.tensor([1, 0, 1, 1], dtype=torch.int32)
    stats = chip_smoke.split_gain_case(hist, 1.0, 1e-3, mask=mask)
    assert stats["device_ms"] is None and stats["bound_by"] == "bytes"
    right = chip_smoke.split_scan.split_gain_decide

    def off_by_one(*a):
        gain, best, idx = right(*a)
        return gain, best, idx + 1
    monkeypatch.setattr(chip_smoke.split_scan, "split_gain_decide", off_by_one)
    with pytest.raises(AssertionError, match="decision differs"):
        chip_smoke.split_gain_case(hist, 1.0, 1e-3, mask=mask)


@pytest.mark.parametrize("sees_device,rows,by", [
    (True, [("split_kernel<2, true>", 0.4, 2), ("other", 0.2, 2)], "profiler"),
    (True, [], "events"),
    (False, [("split_kernel<2, true>", 0.4, 2)], "events"),
])
def test_device_times_fall_back_to_events_without_a_device_trace(
        timed_calls, monkeypatch, sees_device, rows, by):
    """A pending device time comes from the profiler's kernels where its
    trace holds them; where the profiler records no device time in this
    process, or no trace of the function holds a kernel, it is the
    CUDA-event time of as many calls, and says so."""
    monkeypatch.setattr(chip_smoke, "profiler_sees_device", lambda: sees_device)
    monkeypatch.setattr(chip_smoke, "device_trace", lambda fn, reps: list(rows))
    d = chip_smoke.event_times(lambda: 1, reps=2)
    assert d["device_ms"] is None
    chip_smoke.fill_device_times()
    assert d["device_ms_by"] == by and chip_smoke._PENDING == []
    if by == "profiler":
        assert d["device_ms"] == pytest.approx(0.3)
        assert d["device_launches"] == {"split_kernel<2, true>": 1.0, "other": 1.0}
    else:
        assert d["device_ms"] == 0.0 and d["device_kernels"] == {}
        assert len(timed_calls) == 2  # the event timing, then the fallback's


def test_chain_calls_count_host_ops_without_a_device_trace():
    """The argmax and masked_fill count reads the trace's host-side ops, so
    a trace with no device activity still sees the plain decision chain,
    and sees none in the surface alone."""
    from torch.profiler import ProfilerActivity, profile

    hist = torch.stack([torch.randn(3, 4, 16), torch.full((3, 4, 16), 1.25)])
    mask = torch.tensor([1, 0, 1, 1], dtype=torch.int32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        chip_smoke.split_scan.split_gain(hist, 1.0, 1e-3)
    assert chip_smoke.chain_calls(prof, []) == 0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        chip_smoke.split_scan.split_gain_decide(hist, 1.0, 1e-3, mask)
    assert chip_smoke.chain_calls(prof, []) >= 2
    host = chip_smoke.chain_calls(prof, [])
    assert chip_smoke.chain_calls(prof, [("reduce_kernel<ArgMaxOps>", 0.1, 3)]) == host + 3


def test_chain_calls_mode_sees_the_plain_chain_in_a_round():
    """The warm-up round's argmax and masked_fill count needs no profiler:
    on the CPU the staged level decides by the plain chain, which the mode
    counts at every level of every tree; outside the mode nothing counts."""
    x, y = chip_smoke.synthetic.multiclass_xy(200, 8, 2, seed=3)
    data = chip_smoke.bin_dataset(x, y, n_bins=16, device="cpu")
    cfg = chip_smoke.CFG._replace(
        n_trees=4, learner=chip_smoke.CFG.learner._replace(depth=3, n_bins=16))
    with chip_smoke.ChainCalls() as chain:
        chip_smoke.Trainer(cfg, device="cpu").train(data, ("round_robin", 2), seed=0,
                                                      rounds=1)
        counted = chain.calls
    assert counted >= 2 * 3  # a masked_fill and an argmax a level, at least one tree
    torch.argmax(torch.zeros(3))
    assert chain.calls == counted


@pytest.mark.parametrize("by,share,text", [("profiler", 0.5, "50%"),
                                           ("events", None, "not measured")])
def test_busy_share_only_from_a_profiled_device_time(by, share, text):
    """A CUDA-event span holds the device's idle gaps, so no busy share is
    read from it."""
    got = chip_smoke.busy({"device_ms_by": by}, 2.0, 4.0)
    assert got == share and chip_smoke.pct(got) == text


@pytest.fixture
def handoff_run(tmp_path, monkeypatch):
    """The handoff phase's input at a small size on the CPU: ``drive``'s
    second staged run checkpointed at rounds 2 and 4 (``train(ckpt=)``)."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    cfg = chip_smoke.CFG._replace(
        n_trees=12, learner=chip_smoke.CFG.learner._replace(depth=3))
    for name, value in (("CFG", cfg), ("ROUNDS", 4), ("HANDOFF_HALF", 2), ("RELOAD_REPS", 2),
                        ("ENGINE_GAP_S", 0.0), ("ENGINE_SLO_S", 0.01)):
        monkeypatch.setattr(chip_smoke, name, value)
    x, y = chip_smoke.synthetic.sparse_classification_xy(700, 30, 6, seed=2)
    data = chip_smoke.bin_dataset(x, y, n_bins=64, device="cpu")
    ckpt = chip_smoke.checkpoint.CheckpointManager(tmp_path, save_every=2, keep=4)
    state = chip_smoke.train(data, cfg, ckpt=ckpt)
    return {"data": data, "x": x, "runs": {"again": state}, "ckpt_root": tmp_path}


def test_draw_requests_sizes_and_slices():
    x = np.arange(5000, dtype=np.float32)[:, None].repeat(3, 1)
    reqs = chip_smoke.draw_requests(x, np.random.default_rng(1), 30)
    again = chip_smoke.draw_requests(x, np.random.default_rng(1), 30)
    assert [r.uid for r in reqs] == list(range(30)) and len(reqs[0].x) == 600
    assert all(1 <= len(r.x) <= 256 for r in reqs[1:])
    assert all(np.array_equal(a.x, b.x) for a, b in zip(reqs, again))
    assert all(np.array_equal(r.x[:, 0], np.arange(r.x[0, 0], r.x[0, 0] + len(r.x)))
               for r in reqs)


def test_handoff_checks_pass_on_a_small_cpu_run(handoff_run):
    run = handoff_run
    state = run["runs"]["again"]
    restored = chip_smoke.check_restore(run)
    assert restored["steps"] == [2, 4] and list(restored["shapes"]) == [
        p for p, _ in chip_smoke.REF_LAYOUT]
    f2 = chip_smoke.load_forest_checkpoint(run["ckpt_root"], 2, like=state.forest, device="cpu")
    f4 = chip_smoke.load_forest_checkpoint(run["ckpt_root"], 4, like=state.forest, device="cpu")
    reqs = chip_smoke.draw_requests(run["x"], np.random.default_rng(3), 8)
    swap = chip_smoke.check_swap(run, f2, reqs)
    assert set(swap["reload_ms"]) == {"f32", "int8", "fp16"} and swap["live"].model_step == 4
    poller = chip_smoke.check_poller(run, swap["live"])
    assert poller["pickup_ms"] < 1e3 * chip_smoke.POLL_BOUND_S
    engine = chip_smoke.check_engine(run, f2, f4, chip_smoke.draw_requests(
        run["x"], np.random.default_rng(4), 24))
    assert engine["requests"] == 24 and sum(engine["split"].values()) == 24
    assert engine["max_abs_err"]["full"] <= engine["quantization_atol"] + 1e-6


def test_handoff_checks_fail_a_planted_fault(handoff_run, monkeypatch):
    """A corrupt leaf, a server that never swaps and a misrouted request
    each fail their gate."""
    run = handoff_run
    state = run["runs"]["again"]
    f2 = chip_smoke.load_forest_checkpoint(run["ckpt_root"], 2, like=state.forest, device="cpu")
    reqs = chip_smoke.draw_requests(run["x"], np.random.default_rng(3), 4)
    with monkeypatch.context() as m:
        m.setattr(chip_smoke.ForestServer, "maybe_reload", lambda self: False)
        with pytest.raises(AssertionError, match="maybe_reload left"):
            chip_smoke.check_swap(run, f2, reqs)
    with monkeypatch.context() as m:
        m.setattr(chip_smoke, "route_hash", lambda uid: 0.99)
        with pytest.raises(AssertionError, match="route_hash picks"):
            chip_smoke.check_engine(run, f2, state.forest, reqs)
    leaf = chip_smoke.checkpoint.step_dir(run["ckpt_root"], 4) / "leaf_00002.npy"
    raw = bytearray(leaf.read_bytes())
    raw[-1] ^= 0x01
    leaf.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="CRC"):
        chip_smoke.check_restore(run)


def test_configs_come_from_the_ported_modules():
    from repro_torch.configs import gbdt
    from repro_torch.launch.train import gbdt_config

    assert chip_smoke.CFG == gbdt.EXPERIMENTS["efficiency-realsim"].config
    assert chip_smoke.MC_CFG == gbdt_config("multiclass:5", 400)
    assert chip_smoke.MC_CFG.learner.depth == 6 and chip_smoke.MC_CFG.step_length == 0.15


@pytest.fixture
def step_data(monkeypatch):
    """The e2006 and step-rules phase's configurations at a small size on the
    CPU: realsim's configuration at depth 3, 4 rounds; the plain fused level
    counted as a launch (the CPU launches no kernel)."""
    from repro_torch.kernels import level_build

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    cfg = chip_smoke.CFG._replace(n_trees=12, learner=chip_smoke.CFG.learner._replace(depth=3))
    fused = cfg._replace(learner=cfg.learner._replace(backend="fused"))
    for name, value in (("CFG", cfg), ("CFG_FUSED", fused), ("ROUNDS", 4),
                        ("NEWTON_CFG", cfg._replace(step_kind="newton")),
                        ("NEWTON_CFG_FUSED", fused._replace(step_kind="newton")),
                        ("ADAPTIVE_CFG", cfg._replace(adaptive_step=chip_smoke.STEP_RHO))):
        monkeypatch.setattr(chip_smoke, name, value)
    plain = level_build.level_build_plain

    def counted(*args, **kw):
        level_build.launches += 1
        return plain(*args, **kw)

    monkeypatch.setattr(level_build, "level_build_plain", counted)
    x, y = chip_smoke.synthetic.sparse_classification_xy(700, 30, 6, seed=2)
    return chip_smoke.bin_dataset(x, y, n_bins=64, device="cpu")


def _step_runs(data):
    """The phase's realsim runs, as ``drive_e2006`` makes them."""
    runs = {}
    with chip_smoke.recorded_scales() as scales:
        fused: list = []
        runs["newton"] = chip_smoke.train(data, chip_smoke.NEWTON_CFG)
        runs["newton_fused"] = chip_smoke.train(data, chip_smoke.NEWTON_CFG_FUSED, [], fused)
        runs["fixed_w1"] = chip_smoke.train(data, chip_smoke.CFG, workers=1)
        runs["adaptive_w1"] = chip_smoke.train(data, chip_smoke.ADAPTIVE_CFG, workers=1)
        runs["adaptive_w4"] = chip_smoke.train(data, chip_smoke.ADAPTIVE_CFG)
    return runs, fused, scales, chip_smoke.train(data, chip_smoke.CFG)


def test_step_rule_checks_pass_on_a_small_cpu_run(step_data):
    runs, fused, scales, fixed_w4 = _step_runs(step_data)
    assert len(scales) == 2 * chip_smoke.ROUNDS and fused == [3] * chip_smoke.ROUNDS
    newton = chip_smoke.check_newton(step_data, runs["newton"], runs["newton_fused"], fused,
                                     fixed_w4)
    assert newton["fused_levels"] == [0, 1, 2]
    adaptive = chip_smoke.check_adaptive(step_data, runs, fixed_w4, scales)
    assert adaptive["scales_w4"][:4] == pytest.approx([1.0, 1 / 1.6, 1 / 2.2, 1 / 2.8])


def test_step_rule_checks_fail_planted_faults(step_data, monkeypatch):
    """A Newton run that drops the hessian (the gradient step's weights m')
    and a scale applied to the delta and not to the leaves each fail their
    gate."""
    engine = chip_smoke.ps_engine
    propose = engine.propose_tree
    with monkeypatch.context() as m:
        m.setattr(engine, "propose_tree", lambda cfg, *a, **k: propose(
            cfg._replace(step_kind="gradient"), *a, **k))
        runs, fused, scales, fixed_w4 = _step_runs(step_data)
    with pytest.raises(AssertionError, match="hessian weights m' h"):
        chip_smoke.check_newton(step_data, runs["newton"], runs["newton_fused"], fused,
                                fixed_w4)
    with monkeypatch.context() as m:
        m.setattr(engine, "scale_push", lambda cfg, data, tree, scale: (
            tree, scale * engine.apply_tree(tree, data.bins)))
        runs, fused, scales, fixed_w4 = _step_runs(step_data)
    chip_smoke.check_newton(step_data, runs["newton"], runs["newton_fused"], fused, fixed_w4)
    # Four rounds at W = 4 all build from F^0: with unscaled leaves the
    # forest is the fixed step's, which is the first gate to fail.
    with pytest.raises(AssertionError, match="W = 4: the forest is the fixed step's"):
        chip_smoke.check_adaptive(step_data, runs, fixed_w4, scales)
    # Round 3 changed: the forests differ, and round 1's unscaled leaves fail.
    runs["adaptive_w4"].forest.leaf_value[chip_smoke.ROUNDS - 1] *= 2
    with pytest.raises(AssertionError, match="round 1's leaves are not the fixed run's"):
        chip_smoke.check_adaptive(step_data, runs, fixed_w4, scales)


def test_e2006_serving_checks_fail_an_answer_off_by_one_leaf(step_data):
    """The squared-error forest served f32, int8 and fp16 passes; the same
    answers with one row moved by one leaf of the forest fail."""
    x, y = chip_smoke.synthetic.sparse_regression_xy(600, 40, 5, seed=4)
    data = chip_smoke.bin_dataset(x, y, n_bins=64, device="cpu")
    cfg = chip_smoke.E2006_CFG._replace(n_trees=8, step_length=0.3,
                                        learner=chip_smoke.E2006_CFG.learner._replace(depth=3))
    assert cfg.obj.name == "mse"
    state = chip_smoke.train(data, cfg)
    rng = np.random.default_rng(5)
    served = {mode: chip_smoke.serve(state.forest, x, data.bin_edges, rng, objective="mse",
                                     quantize=mode) for mode in chip_smoke.QUANT_MODES}
    stats = chip_smoke.check_serving_modes("e2006", state.forest, x, data.bin_edges, served,
                                           "cpu")
    assert set(stats) == {"e2006 f32", "e2006 int8", "e2006 fp16"}
    _, _, results = served[None]
    leaves = state.forest.leaf_value[2]
    results[3].scores[0] += float(leaves[leaves.abs().argmax()])  # a nonzero leaf
    with pytest.raises(AssertionError):
        chip_smoke.check_serving_modes("e2006", state.forest, x, data.bin_edges, served, "cpu")


def test_e2006_phase_configs_come_from_the_ported_modules():
    from repro_torch.configs import gbdt

    assert chip_smoke.E2006_CFG == gbdt.EXPERIMENTS["efficiency-e2006"].config
    assert chip_smoke.E2006_CFG.obj.name == "mse" and chip_smoke.E2006_CFG.learner.depth == 9
    assert chip_smoke.NEWTON_CFG == chip_smoke.CFG._replace(step_kind="newton")
    assert chip_smoke.ADAPTIVE_CFG.adaptive_step == chip_smoke.STEP_RHO > 0
    assert set(chip_smoke.OBJECTIVE_TRAIN_CLIS) == {"mse", "quantile:0.9", "huber", "lambdarank"}
    assert set(chip_smoke.OBJECTIVE_SERVE_CLIS) == {"mse", "lambdarank"}
    assert {k for k, _ in chip_smoke.E2006_LINE.values()} == set(chip_smoke.KERNELS)


@pytest.fixture
def threads_phase(monkeypatch, tmp_path):
    """The threads phase at a small size on the CPU: realsim's configuration
    at depth 3 (24 trees, 20 for the short runs, the CLI at 6 steps on the
    CPU), its data 700 x 30; every kernel's plain version counted as a
    launch (the CPU launches no kernel), streams stood in by the CPU's
    synchronous order, the fused child run in-process."""
    import contextlib
    import io
    import json

    from repro_torch.kernels import forest_traversal, histogram, level_build, split_scan

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a, **k: None)
    cfg = chip_smoke.CFG._replace(n_trees=24, learner=chip_smoke.CFG.learner._replace(depth=3))
    fused = cfg._replace(learner=cfg.learner._replace(backend="fused"))
    cli = ["--arch", "gbdt", "--device", "cpu", "--runtime", "threads", "--steps", "6",
           "--workers", "4", "--verify-replay", "--checkpoint-dir", str(tmp_path / "cli"),
           "--checkpoint-every", "3", "--verify-resume"]
    for name, value in (("CFG", cfg), ("CFG_FUSED", fused), ("THREADS_SHORT", 20),
                        ("THREADS_CFG", cfg._replace(n_trees=20)), ("THREADS_CLI", cli),
                        ("THREADS_DIR", tmp_path / "threads"), ("THREADS_SPLIT_REPS", 5),
                        ("THREADS_REPS", 3), ("THREADS_HALT", 10), ("THREADS_CKPT_EVERY", 4)):
        monkeypatch.setattr(chip_smoke, name, value)
    for mod, name in ((histogram, "histogram_plain"), (split_scan, "split_gain_decide_plain"),
                      (level_build, "level_build_plain")):
        plain = getattr(mod, name)

        def counted(*args, _plain=plain, _mod=mod, **kw):
            _mod.launches += 1
            return _plain(*args, **kw)

        monkeypatch.setattr(mod, name, counted)
    traverse = forest_traversal.forest_traverse_plain

    def traverse_counted(*args, **kw):
        forest_traversal.form_launches["f32"] += 1
        return traverse(*args, **kw)

    monkeypatch.setattr(forest_traversal, "forest_traverse_plain", traverse_counted)
    x, y = chip_smoke.synthetic.sparse_classification_xy(700, 30, 6, seed=2)
    data = chip_smoke.bin_dataset(x, y, n_bins=64, device="cpu")
    monkeypatch.setattr(chip_smoke.gbdt_configs, "get", lambda name, device=None: (cfg, data))

    def fused_in_process():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            chip_smoke.threads_fused_child("cpu")
        return {**json.loads(buf.getvalue().splitlines()[-1]), "process_s": 0.0}

    monkeypatch.setattr(chip_smoke, "threads_fused", fused_in_process)
    return {"data": data, "x": x}


def test_threads_phase_passes_and_fails_planted_faults_on_a_small_cpu_run(threads_phase,
                                                                         monkeypatch):
    """The phase's gates pass on a small CPU run; then a replay that
    drifts, a step scale off by one ulp and a pull byte count off by one
    each fail their gate, and so does a launch count that loses launches
    under streams."""
    run = chip_smoke.drive_threads(torch.device("cpu"), threads_phase)
    report = {}
    checked = chip_smoke.check_threads(run, report)
    info = report["threads"]
    assert info["summary"]["n_trees"] == 24 and set(checked) == set(
        chip_smoke.THREADS_LINE.values())
    assert sum(info["staleness_histogram"].values()) == 24 and info["concurrency"] > 0
    assert run["fused"]["launches"]["level_build"] == 3 * 21
    assert all(run["counts"][k] > 0 for k in ("histogram", "split_gain", "forest_traverse"))
    stats = {"ms": 1.0, "device_ms": 1.0, "plain_ms": 2.0, "bound_ms": 0.5,
             "bound_by": "bytes", "library_ms": None, "max_abs_err": 0.0}
    report["kernels"] = {k: dict(stats) for k in ("histogram", "split_gain", "forest_traverse")}
    report["level_build_shapes"] = {"level0": dict(stats, staged_ms=1.0, samples_hit=3)}
    line = chip_smoke.threads_line(run, checked, report)
    assert [e["name"] for e in line] == list(chip_smoke.THREADS_LINE)
    assert all(e["launches"] > 0 and "staged_ms" not in e for e in line)

    with monkeypatch.context() as m:
        m.setattr(run["rt"], "replay", lambda trace: (run["loop"], torch.zeros(24)))
        with pytest.raises(AssertionError, match="400-tree run vs its replay|differs"):
            chip_smoke.check_threads(run, {})
    _, _, atr = run["runs"]["adaptive"]
    atr.step_scale[5] = np.nextafter(atr.step_scale[5], np.float32(0))
    with pytest.raises(AssertionError, match="staleness_scales"):
        chip_smoke.check_threads(run, {})
    atr.step_scale[5] = np.nextafter(atr.step_scale[5], np.float32(2))
    _, _, stra = run["runs"]["shards"]
    stra.pull_bytes[3] += 1
    with pytest.raises(AssertionError, match="pulled"):
        chip_smoke.check_threads(run, {})
    stra.pull_bytes[3] -= 1
    from repro_torch.kernels import split_scan

    decide = split_scan.split_gain_decide_plain
    calls = []

    def loses_a_count(*args, **kw):
        calls.append(1)
        if len(calls) == 7:
            split_scan.launches -= 1
        return decide(*args, **kw)

    monkeypatch.setattr(split_scan, "split_gain_decide_plain", loses_a_count)
    with pytest.raises(AssertionError, match="launches counted"):
        chip_smoke.check_threads_kernels(run, {})


@pytest.mark.parametrize("off,passes", [(0.5, True), (2.0, False)])
def test_histogram_case_holds_the_kernel_to_the_f64_sums(monkeypatch, off, passes):
    """The histogram check's reference is the plain version summed in f64
    (the f32 plain version's atomics stray further than the kernel on the
    card): a stand-in kernel ``off`` tolerances from the f64 sums at one
    cell passes at half a tolerance and fails at two."""
    monkeypatch.setattr(chip_smoke, "event_times", lambda fn, **kw: {"ms": 0.0})
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda *a, **kw: 0.0)
    monkeypatch.setattr(chip_smoke, "library_times", lambda seg, vals, cells, into: into)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    rng = np.random.default_rng(5)
    n, f, b = 2000, 5, 16
    bins = torch.from_numpy(rng.integers(0, b, (n, f)).astype(np.int32))
    node = torch.zeros(n, dtype=torch.int32)
    grad = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    hess = torch.full((n,), 0.3, dtype=torch.float32)
    exact = histogram.histogram_plain(bins, node, grad.double(), hess.double(), 1, b)
    assert exact.dtype == torch.float64
    tol = 1e-5 * float(exact.abs().max())

    def kernel(*args):
        out = exact.clone()
        out[1, 0, 2, 3] += off * tol
        return out.float()

    monkeypatch.setattr(histogram, "histogram", kernel)
    if passes:
        st = chip_smoke.histogram_case(bins, grad, hess, node, 1, None, b, "t", {})
        assert st["max_abs_err"] <= tol
    else:
        with pytest.raises(AssertionError, match="over tolerance"):
            chip_smoke.histogram_case(bins, grad, hess, node, 1, None, b, "t", {})


def test_mesh_phase_passes_and_fails_planted_faults_on_a_small_cpu_run(monkeypatch,
                                                                       tmp_path):
    """The mesh phase on the CPU at a small size: realsim's configuration on
    its dataset cut to 800 x 300, 3 rounds; the (1, 1) rank over gloo (no
    NCCL here), 4 gloo rank processes (each counting its kernels' plain
    calls as launches), one 2-rank CLI. Every gate passes; then a rank's
    forest one ulp off, a measured byte count off by one, a CLI without its
    lines, a first-tree departure that is no tie, a decisive-set threshold
    or leaf off and an unchecked one-rank all-reduce each fail their gate."""
    import copy
    import dataclasses

    from repro_torch.data import synthetic
    from repro_torch.kernels import histogram_sparse, split_scan
    from repro_torch.trees.binning import bin_dataset

    rounds = 3
    monkeypatch.setattr(chip_smoke, "ROUNDS", rounds)
    monkeypatch.setattr(chip_smoke, "MESH_DIR", tmp_path / "mesh")
    for mod, name in ((histogram, "histogram_plain"), (split_scan, "split_gain_decide_plain"),
                      (histogram_sparse, "histogram_sparse_plain")):
        plain = getattr(mod, name)

        def counted(*args, _plain=plain, _mod=mod, **kw):
            _mod.launches += 1
            return _plain(*args, **kw)

        monkeypatch.setattr(mod, name, counted)
    spec = dataclasses.replace(chip_smoke.gbdt_configs.EXPERIMENTS[chip_smoke.REALSIM].dataset,
                               n=800, dim=300)
    x, y, mult = synthetic.raw(spec)
    cpu = torch.device("cpu")
    data = bin_dataset(x, y, n_bins=64, multiplicity=mult, device=cpu)
    sparse = bin_dataset(x, y, n_bins=64, multiplicity=mult, device=cpu, sparse=True)
    realsim = {"data": data, "sparse": sparse,
               "runs": {"staged": chip_smoke.train(data), "sparse": chip_smoke.train(sparse)}}
    clis = {"2d 1x2 sparse": ["--arch", "gbdt", "--device", "cpu", "--steps", "2",
                              "--workers", "2", "--mesh", "2d", "--mesh-shape", "1x2",
                              "--sparse", "--mesh-backend", "gloo"]}
    run = chip_smoke.drive_mesh(cpu, realsim, spec=spec, rounds=rounds, clis=clis,
                                one_rank_backend="gloo")
    report = {}
    checked = chip_smoke.check_mesh(run, realsim, report)
    assert all(checked["launches"][k] > 0 for k in chip_smoke.MESH_LINE.values())
    assert all(len(v) == chip_smoke.MESH_RANKS for v in checked["by_rank"].values())
    info = report["mesh"]
    assert info["2d_1x4_sparse"]["bytes_per_round"] == {"pmax": 4 * 511, "pmin": 4 * 511}
    assert info["1d_x4_vs_unmeshed"]["nodes_compared"] > 0
    assert info["1d_x4_decisive_vs_unmeshed"]["leaf_max_abs_diff"] <= 1e-5
    assert run["nccl"]["all_reduce_checked"]

    def fails(match, mutate):
        bad = copy.deepcopy(run)
        mutate(bad)
        with pytest.raises(AssertionError, match=match):
            chip_smoke.check_mesh(bad, realsim, {})

    def ulp(bad):
        leaf = bad["ranks"][2]["2d_1x4"]["forest"][2]
        leaf[0, 0] = torch.nextafter(leaf[0, 0], torch.tensor(1.0))

    fails("rank 2 vs rank 0", ulp)
    fails("measured bytes", lambda bad: bad["ranks"][1]["2d_1x4_sparse"]["bytes"].update(
        realized_bytes=bad["ranks"][1]["2d_1x4_sparse"]["bytes"]["realized_bytes"] + 1))
    fails("mesh CLI", lambda bad: bad["clis"]["2d 1x2 sparse"].update(out=""))

    def departs(bad):
        for rk in bad["ranks"]:
            for tag in ("1d_x4", "1d_x4_again"):
                feature = rk[tag]["forest"][0]
                feature[0, 0] = (feature[0, 0] + 1) % data.n_features

    fails("without a tie", departs)

    def decisive_threshold(bad):
        for rk in bad["ranks"]:
            threshold = rk["1d_x4_decisive"]["forest"][1]
            threshold[0, 0] = (threshold[0, 0] + 1) % 64

    def decisive_leaf(bad):
        for rk in bad["ranks"]:
            rk["1d_x4_decisive"]["forest"][2][0, 0] += 2e-5

    fails("decisive vs the unmeshed run: threshold differs", decisive_threshold)
    fails("decisive vs the unmeshed run: leaves", decisive_leaf)
    fails("NCCL all_reduce was not checked",
          lambda bad: bad["nccl"].pop("all_reduce_checked"))


# ----------------------------------------------------------- hybrid phase
def _small_hybrid(dtype="bfloat16"):
    import dataclasses

    import repro_torch.configs as lm_configs
    from repro_torch.models import transformer as TT

    cfg = dataclasses.replace(lm_configs.get("zamba2-1.2b").reduced(), n_layers=5,
                              dtype=dtype, attn_impl="flash")
    return cfg, TT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")


def test_ssd_events_take_the_scan_forward_its_recompute_and_its_backward():
    """A profiled training forward and backward of a small hybrid model on
    the CPU: the ops inside the SSD ranges (forward and remat recompute) and
    the backward nodes of their forward ops are the SSD's; the projections
    and the shared block are not."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import transformer as TT
    from repro_torch.optim.optimizers import tree_leaves

    cfg, params = _small_hybrid("float32")
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    toks = torch.randint(0, cfg.vocab_size, (2, 33), generator=torch.Generator().manual_seed(1))
    with chip_smoke.op_ranges(), profile(activities=[ProfilerActivity.CPU]) as prof:
        loss, _ = TT.forward_train(params, cfg, {"tokens": toks[:, :-1],
                                                 "labels": toks[:, 1:]})
        torch.autograd.grad(loss, leaves)
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]
    ssd = chip_smoke.range_events(events, chip_smoke.SSD_RANGE)
    names = {e.name for e in events if id(e) in ssd}
    ranges = [e for e in events if e.name == chip_smoke.SSD_RANGE]
    assert len(ranges) == 2 * cfg.n_layers  # the forward and the recompute
    assert {"aten::cumsum", "aten::exp", "aten::bmm", "CumsumBackward0", "ExpBackward0",
            "BmmBackward0"} <= names
    others = {e.name for e in events if id(e) not in ssd}
    assert {"aten::mm", "MmBackward0", "aten::softmax"} & others
    assert not any(e.name == "SoftmaxBackward0" for e in events if id(e) in ssd)
    assert chip_smoke.lm_ssm.ssd_scan.__name__ == "ssd_scan"  # the ranges are taken away
    assert chip_smoke.lm_layers.moe_ffn.__name__ == "moe_ffn"


def test_hybrid_grad_picks_name_the_first_and_last_mamba2_layers():
    import repro_torch.configs as lm_configs

    cfg = lm_configs.get("zamba2-1.2b")
    picks = {name: (path, idx) for name, path, idx in chip_smoke.hybrid_grad_picks(cfg)}
    assert picks["shared.attn.wq"] == (("shared", "attn", "wq"), ())
    assert picks["mamba[0].in_proj"] == (("groups", "mamba", "in_proj"), (0, 0))
    assert picks["mamba[37].out_proj"] == (("tail", "out_proj"), (1,))
    assert len(picks) == 8
    small, _ = _small_hybrid()
    import dataclasses
    no_tail = dataclasses.replace(small, n_layers=4)
    picks = {name: (path, idx) for name, path, idx in chip_smoke.hybrid_grad_picks(no_tail)}
    assert picks["mamba[3].in_proj"] == (("groups", "mamba", "in_proj"), (1, 1))


@pytest.fixture(scope="module")
def drift_model():
    """A small bf16 hybrid model's greedy decode of 2 x 32-token prompts, 8
    new tokens, on the CPU, with the tokens it serves."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step

    cfg, params = _small_hybrid()
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    tok, _, cache = make_prefill_step(cfg, max_len=48)(params,
                                                       {"tokens": torch.from_numpy(prompts)})
    served = [tok]
    for _ in range(7):
        tok, cache = make_decode_step(cfg)(params, tok[:, None], cache)
        served.append(tok)
    return cfg, params, prompts, torch.stack(served, 1).numpy()


@pytest.fixture
def drift_run(drift_model, monkeypatch):
    monkeypatch.setattr(chip_smoke, "LM_MAX_LEN", 48)
    monkeypatch.setattr(chip_smoke, "LM_NEW", 8)
    return drift_model


def test_hybrid_decode_drift_passes_on_a_small_cpu_run(drift_run):
    cfg, params, prompts, served = drift_run
    out = chip_smoke.decode_drift(cfg, params, prompts, served, "cpu")
    assert out["steps"] == 8 and out["teacher_forced_ssm_chunk"] == 13  # 39 = 3 x 13
    assert len(out["decode_vs_f32"]) == 8 and out["worst_ratio"] <= 2


@pytest.mark.parametrize("fault", ["conv cache not advanced", "SSM state not written"])
def test_hybrid_decode_drift_fails_a_cache_that_is_not_updated(drift_run, monkeypatch, fault):
    """A Mamba2 decode that hands back its old conv rows, or its old SSM
    state: the gate rejects the drift that follows."""
    cfg, params, prompts, served = drift_run
    inner = chip_smoke.lm_ssm.mamba2_decode

    def faulty(p, x, state, conv, c):
        y, state2, conv2 = inner(p, x, state, conv, c)
        return (y, state2, conv) if fault.startswith("conv") else (y, state, conv2)
    monkeypatch.setattr(chip_smoke.lm_ssm, "mamba2_decode", faulty)
    with pytest.raises(AssertionError, match="drift|other tokens"):
        chip_smoke.decode_drift(cfg, params, prompts, served, "cpu")


def test_device_trace_takes_a_partial_trace_again(monkeypatch):
    """A trace whose launches of a kernel are no multiple of the calls (it
    lost some calls' kernels) is taken again; three such traces give none."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "_PROFILER", {})
    traces = iter([[("flash_fwd", 1.2, 12)], [("flash_fwd", 4.0, 20), ("memset", 0.1, 40)]])
    monkeypatch.setattr(chip_smoke, "device_rows", lambda prof: next(traces))
    assert chip_smoke.device_trace(lambda: None, 20) == [("flash_fwd", 4.0, 20),
                                                          ("memset", 0.1, 40)]
    assert chip_smoke._PROFILER["traces_taken_again"] == 1
    monkeypatch.setattr(chip_smoke, "device_rows", lambda prof: [("flash_fwd", 1.2, 12)])
    assert chip_smoke.device_trace(lambda: None, 20) == []
    assert chip_smoke._PROFILER["traces_taken_again"] == 4


# ------------------------------------------------- dots and packed training
@pytest.fixture
def lm_train_cpu(monkeypatch):
    """The LM training phase's helpers on the CPU at reduced granite-3-2b
    (2 layers, bf16, flash): the card's memory and sync calls stubbed, and
    the plain flash forward and backward counted as wgmma launches (the CPU
    launches no kernel)."""
    import dataclasses

    import repro_torch.configs as lm_configs
    from repro_torch.kernels import flash_attention, ops

    for name, value in (("synchronize", None), ("empty_cache", None),
                        ("reset_peak_memory_stats", None), ("max_memory_allocated", 0)):
        monkeypatch.setattr(torch.cuda, name, lambda *a, _v=value, **k: _v)
    chip_smoke.reset_counts()
    fwd, bwd = ops.flash_attention, flash_attention.flash_attention_bwd

    def fwd_counted(*args, **kw):
        flash_attention.launches += 1
        flash_attention.route_launches["wgmma"] += 1
        return fwd(*args, **kw)

    def bwd_counted(*args, **kw):
        flash_attention.bwd_launches += 1
        flash_attention.bwd_route_launches["wgmma"] += 1
        return bwd(*args, **kw)

    monkeypatch.setattr(ops, "flash_attention", fwd_counted)
    monkeypatch.setattr(flash_attention, "flash_attention_bwd", bwd_counted)
    cfg = dataclasses.replace(lm_configs.get("granite-3-2b").reduced(), dtype="bfloat16",
                              attn_impl="flash")
    yield cfg
    chip_smoke.reset_counts()


def test_dots_run_is_bitwise_full_and_its_gate_fails_a_changed_parameter(lm_train_cpu):
    """Run A's recipe at accum 2 under "full" and "dots": the gate passes
    (same losses, parameters, 2 x L forward and L backward flash launches a
    microbatch), then fails a parameter off by one ulp and a missing
    recompute launch."""
    import dataclasses

    from repro_torch.kernels import flash_attention

    cfg = lm_train_cpu
    batches = list(chip_smoke.synthetic_batches(cfg, 4, 32, 2, seed=0, device="cpu"))
    recipe = chip_smoke.adamw(chip_smoke.cosine_schedule(1e-3, 1, 2), weight_decay=0.01,
                              max_grad_norm=1.0)
    full, params, _, _, _ = chip_smoke.train_lm(cfg, recipe, batches, 2, 0.0, "cpu")
    copy = chip_smoke.param_copy(params)
    chip_smoke.reset_counts()
    dots, params, _, _, _ = chip_smoke.train_lm(
        dataclasses.replace(cfg, remat_policy="dots"), recipe, batches, 2, 0.0, "cpu")
    counts = {"flash_attention_fwd": flash_attention.launches,
              "flash_attention_bwd": flash_attention.bwd_launches,
              "fwd_routes": dict(flash_attention.route_launches),
              "bwd_routes": dict(flash_attention.bwd_route_launches)}
    assert dots["fwd_launches"] == [2 * 2 * cfg.n_layers] * 2
    chip_smoke.check_dots_run(dots, full, params, copy, counts, 2, cfg.n_layers)
    off = [c.clone() for c in copy]
    off[0].view(torch.int16).view(-1)[0] += 1  # one bf16 ulp
    with pytest.raises(AssertionError, match="parameter leaf 0 differs"):
        chip_smoke.check_dots_run(dots, full, params, off, counts, 2, cfg.n_layers)
    short = dict(dots, fwd_launches=[2 * cfg.n_layers] * 2)  # no recompute launches
    with pytest.raises(AssertionError, match="flash launches a step"):
        chip_smoke.check_dots_run(short, full, params, copy, counts, 2, cfg.n_layers)


def test_packed_phase_passes_on_a_small_cpu_run(lm_train_cpu):
    report = {}
    out = chip_smoke.drive_lm_packed(torch.device("cpu"), report, lm_train_cpu, seq=64,
                                     batch=4)
    assert out["launches"] == {"flash_attention_fwd": 0, "flash_attention_bwd": 0}
    assert out["data"]["rows"] == 4 * chip_smoke.PACKED_STEPS
    assert out["data"]["pad_tokens"] > 0 and out["data"]["split_documents"] > 0
    assert out["runs"][0]["loss"] == out["runs"][1]["loss"]
    assert set(out["isolation"]) == {"document 1", "document 2"}
    assert out["pad_microbatch"]["pad_tokens"] > 0


def test_packed_isolation_gate_fails_a_cross_document_leak(lm_train_cpu, monkeypatch):
    """A mask that ignores the segments lets document 2 attend to document
    1: the isolation gate fails (and passes with the mask in place)."""
    from repro_torch.models import layers
    from repro_torch.models import transformer as TT

    cfg = lm_train_cpu
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    docs = chip_smoke.markov_documents(cfg.vocab_size, (22, 42), np.random.default_rng(1))
    chip_smoke.check_packed_isolation(cfg, params, tuple(docs), "cpu")
    chunked = layers.chunked_attention
    monkeypatch.setattr(layers, "chunked_attention",
                        lambda *a, segments=None, **k: chunked(*a, **k))
    with pytest.raises(AssertionError, match="packed isolation, document 2"):
        chip_smoke.check_packed_isolation(cfg, params, tuple(docs), "cpu")


def test_packed_flash_gate_fails_when_a_packed_microbatch_launches_flash(lm_train_cpu,
                                                                        monkeypatch):
    """A route rule that sends packed rows to flash (dropping their mask)
    launches flash in every packed microbatch: the phase fails its gate."""
    from repro_torch.models import layers

    train = layers.self_attention_train

    def flash_anyway(p, x, cfg, window, return_kv=False, segments=None):
        return train(p, x, cfg, window, return_kv,
                     segments=None if cfg.attn_impl == "flash" else segments)

    monkeypatch.setattr(layers, "self_attention_train", flash_anyway)
    with pytest.raises(AssertionError, match="packed runs launched flash"):
        chip_smoke.drive_lm_packed(torch.device("cpu"), {}, lm_train_cpu, seq=64, batch=4)


# ------------------------------------------------------- device groups
class _Range:
    def __init__(self, start, end):
        self.start, self.end = start, end


class _Event:
    """A ``FunctionEvent`` as ``device_groups`` reads it: host ops, their
    kernel lists filled as the profiler fills them, and device activities."""

    def __init__(self, name, cuda=False, span=(0, 1), parent=None, kernels=(), ms=0.0,
                 annotation=False):
        self.name = self.key = name
        self.device_type = (torch.autograd.DeviceType.CUDA if cuda
                            else torch.autograd.DeviceType.CPU)
        self.time_range = _Range(*span)
        self.cpu_parent, self.cpu_children = parent, []
        if parent is not None:
            parent.cpu_children.append(self)
        self.kernels = list(kernels)
        self.self_device_time_total = 1e3 * ms
        self.is_async, self.is_user_annotation = False, annotation
        self.scope, self.sequence_nr, self.thread, self.fwd_thread = 0, -1, 1, 1
        self.count = 1


class _Trace:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events

    def key_averages(self):
        return [e for e in self._events if e.device_type == torch.autograd.DeviceType.CUDA]


def _kernel(name, ms):
    from types import SimpleNamespace

    return SimpleNamespace(name=name, duration=1e3 * ms)


def _nested_trace():
    """A cross-attention range holding a bmm (2.0 ms, its kernel listed by
    both the bmm and the einsum around it) and a projection mm (1.0 ms);
    the range op lists its own 80 ms span on the device as a kernel, as the
    profiler does; an SSD op's elementwise kernel (0.5 ms); a flash kernel
    (0.25 ms) and two launches of one copy kernel of equal time outside any
    range (0.125 ms each, one listed by no op)."""
    rng = _Event(chip_smoke.CHUNKED_RANGE, span=(0, 100),
                 kernels=[_kernel(chip_smoke.CHUNKED_RANGE, 80.0)])
    outer = _Event("aten::einsum", span=(10, 50), parent=rng, kernels=[_kernel("cutlass_bmm", 2.0)])
    bmm = _Event("aten::bmm", span=(20, 40), parent=outer, kernels=[_kernel("cutlass_bmm", 2.0)])
    mm = _Event("aten::mm", span=(60, 70), parent=rng, kernels=[_kernel("sm90_xmma_gemm", 1.0)])
    ssd = _Event(chip_smoke.SSD_RANGE, span=(200, 300))
    exp = _Event("aten::exp", span=(210, 220), parent=ssd,
                 kernels=[_kernel("elementwise_exp", 0.5)])
    flash = _Event("FlashAttention", span=(400, 410), kernels=[_kernel("flash_fwd_wgmma", 0.25)])
    copy = _Event("aten::copy_", span=(500, 510), kernels=[_kernel("copy_kernel", 0.125)])
    device = [_Event(name, cuda=True, ms=ms) for name, ms in (
        ("cutlass_bmm", 2.0), ("sm90_xmma_gemm", 1.0), ("elementwise_exp", 0.5),
        ("flash_fwd_wgmma", 0.25), ("copy_kernel", 0.125), ("copy_kernel", 0.125))]
    device.append(_Event(chip_smoke.CHUNKED_RANGE, cuda=True, ms=80.0, annotation=True))
    return _Trace([rng, outer, bmm, mm, ssd, exp, flash, copy] + device), bmm


def test_device_groups_count_a_kernel_under_two_nested_ops_once():
    """The bmm's kernel sits in two nested ops' lists and the range lists
    its own span: a sum over the host ops' lists reads 85.875 ms against a
    device total of 4.0; the groups count each kernel once, the bmm's under
    the inner bmm, a kernel no op lists by its name, and sum to the device
    total (the range's span excluded)."""
    trace, bmm = _nested_trace()
    total = sum(ms for _, ms, _ in chip_smoke.device_rows(trace))
    assert total == 4.0
    naive = sum(k.duration for e in trace.events() for k in e.kernels) / 1e3
    assert naive == 85.875
    filed = chip_smoke.device_kernels(trace)
    assert sum(ms for _, ms, _ in filed) == total
    assert [o for n, _, o in filed if n == "cutlass_bmm"] == [bmm]
    assert sorted(o is None for n, _, o in filed if n == "copy_kernel") == [False, True]
    groups = chip_smoke.device_groups(trace)
    assert groups == {chip_smoke.CHUNKED_GROUP: 2.0, "cuBLAS GEMMs": 1.0,
                      chip_smoke.SSD_GROUP: 0.5, "flash_fwd": 0.25,
                      chip_smoke.REST_GROUP: 0.25}
    assert chip_smoke.groups_cover("trace", groups, total) == 1.0
    with pytest.raises(AssertionError, match="groups sum"):
        chip_smoke.groups_cover("trace", {"x": naive}, total)


def test_chunked_range_takes_the_encoder_and_cross_attention():
    """A profiled whisper forward and backward on the CPU: the encoder's and
    the cross layers' attention run inside the chunked-attention ranges
    (forward and remat recompute) and the backward of their ops belongs to
    them; the decoder's self-attention does not."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    import repro_torch.configs as lm_configs
    from repro_torch.models import transformer as TT
    from repro_torch.optim.optimizers import tree_leaves

    cfg = dataclasses.replace(lm_configs.get("whisper-small").reduced(), n_layers=1,
                              encoder_layers=1)
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 17), generator=g)
    media = torch.randn((2, cfg.n_media_tokens, cfg.d_model), generator=g)
    with chip_smoke.op_ranges(), profile(activities=[ProfilerActivity.CPU]) as prof:
        loss, _ = TT.forward_train(params, cfg, {"tokens": toks[:, :-1], "labels": toks[:, 1:],
                                                 "media": media})
        torch.autograd.grad(loss, leaves)
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]
    chunked = chip_smoke.range_events(events, chip_smoke.CHUNKED_RANGE)
    ranges = [e for e in events if e.name == chip_smoke.CHUNKED_RANGE]
    assert len(ranges) == 2 * 2  # encoder and cross, forward and recompute
    names = {e.name for e in events if id(e) in chunked}
    assert {"aten::bmm", "aten::softmax", "SoftmaxBackward0", "BmmBackward0"} <= names
    softmax = [e for e in events if e.name == "aten::softmax"]
    assert len(softmax) == 6 and sum(id(e) in chunked for e in softmax) == 4  # not self's
    assert chip_smoke.lm_layers.cross_attention.__name__ == "cross_attention"
    assert chip_smoke.lm_layers.encoder_attention.__name__ == "encoder_attention"


# ------------------------------------------------------------------ xLSTM
def _small_xlstm():
    """Reduced xlstm-1.3b (2 groups of one mLSTM and one sLSTM layer, d
    256, 4 heads of 64, chunk 16) in bf16, seeded."""
    import dataclasses

    import repro_torch.configs as lm_configs
    from repro_torch.models import transformer as TT

    cfg = dataclasses.replace(lm_configs.get("xlstm-1.3b").reduced(), dtype="bfloat16")
    return cfg, TT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")


@pytest.fixture
def xlstm_phase_cpu(monkeypatch):
    """``drive_xlstm`` at the reduced model on the CPU: waves of 2 x 32 and
    2 x 16 prompts and 4 new tokens, 2 x 16 microbatches at lr 1e-2 (at
    1e-3 the small model's loss moves less than its batches differ), the
    card's memory and sync calls and the two profilers stubbed (they time
    with CUDA events)."""
    cfg, _ = _small_xlstm()
    for name, value in (("synchronize", None), ("empty_cache", None),
                        ("reset_peak_memory_stats", None), ("max_memory_allocated", 0)):
        monkeypatch.setattr(torch.cuda, name, lambda *a, _v=value, **k: _v)
    monkeypatch.setattr(chip_smoke.lm_configs, "get", lambda arch: cfg)
    for name, value in (("LM_SLOTS", 2), ("LM_PROMPTS", (32, 16)), ("LM_NEW", 4),
                        ("LM_MAX_LEN", 40), ("XLSTM_TRAIN", (4, 16)), ("XLSTM_TRAIN_STEPS", 3),
                        ("XLSTM_CHECK_PROMPT", 16), ("XLSTM_CHECK_LEN", 8),
                        ("XLSTM_PROFILE", {"prefill": 8, "train": (4, 8),
                                           "positions": (4, 8)}),
                        ("XLSTM_OTHER", {"ssm_chunk": 4}),
                        ("TRAIN_LR", 1e-2),
                        ("XLSTM_PARAMS", sum(t.numel() for t in chip_smoke.tree_leaves(
                            chip_smoke.TT.abstract_params(cfg))))):
        monkeypatch.setattr(chip_smoke, name, value)

    def profiled(*args, **kw):
        groups = {chip_smoke.SLSTM_GROUP: 1.0, chip_smoke.REST_GROUP: 3.0}
        return {"device_ms": 4.0, "device_ms_by": "profiler", "wall_ms_profiled": 8.0,
                "by_group_ms": groups, "range_host_ms": {chip_smoke.SLSTM_RANGE: 2.0},
                "device_busy_share": 0.5}
    monkeypatch.setattr(chip_smoke, "profile_lm",
                        lambda *a, **k: {"prefill": profiled(), "decode": profiled()})
    monkeypatch.setattr(chip_smoke, "profile_train_step", lambda *a, **k: profiled())
    chip_smoke.reset_counts()
    yield cfg
    chip_smoke.reset_counts()


def test_xlstm_phase_passes_on_a_small_cpu_run(xlstm_phase_cpu, capsys):
    report = {}
    chip_smoke.drive_xlstm(torch.device("cpu"), report)
    out = report["xlstm"]
    assert out["serve"]["cache"]["bytes"] == chip_smoke.xlstm_cache_bytes(xlstm_phase_cpu, 2)
    assert out["serve"]["decode_drift"]["worst_ratio"] <= 2
    assert out["train"]["runs"][0]["loss"] == out["train"]["runs"][1]["loss"]
    assert out["train"]["profile_one_group"]["unprofiled_wall_ms"] > 0
    assert len(out["train"]["against_other_chunk"]["leaves"]) == 10
    assert out["slstm_share"]["prefill"] == {"device": 0.25, "host": 0.25}
    assert 20 <= out["slstm_ops_per_position"]["inference"] <= 40
    assert "the xLSTM phase took" in capsys.readouterr().out


def test_xlstm_phase_fails_a_launched_kernel(xlstm_phase_cpu, monkeypatch):
    """A kernel launched anywhere in the phase (here a flash forward counted
    at the first decode step) fails it: the xLSTM path has none."""
    from repro_torch.kernels import flash_attention

    inner = chip_smoke.TT.decode_step

    def counted(*args, **kw):
        flash_attention.launches += 1
        return inner(*args, **kw)
    monkeypatch.setattr(chip_smoke.TT, "decode_step", counted)
    with pytest.raises(AssertionError, match="kernels launched on a path that has none"):
        chip_smoke.drive_xlstm(torch.device("cpu"), {})


def test_xlstm_phase_refuses_to_compare_a_path_with_itself(xlstm_phase_cpu, monkeypatch):
    """A compared path whose chunk is the served one's at a gate's length
    would hold the served path to itself: the phase refuses it."""
    monkeypatch.setattr(chip_smoke, "XLSTM_OTHER", {"ssm_chunk": 64})
    with pytest.raises(AssertionError, match="at 8 tokens the compared path's chunk"):
        chip_smoke.drive_xlstm(torch.device("cpu"), {})


def test_xlstm_cache_bytes_are_the_reckoning_at_full_width():
    """xlstm-1.3b at 4 rows: 0.35 GB, nearly all of it the 42 mLSTM layers'
    C (4 heads of 512 x 512, bf16)."""
    import repro_torch.configs as lm_configs

    cfg = lm_configs.get("xlstm-1.3b")
    c = 42 * 4 * 4 * 512 * 512 * 2
    assert chip_smoke.xlstm_cache_bytes(cfg, 4) == c + 42 * 4 * 4 * (512 * 2 + 4) + \
        6 * 4 * 4 * 512 * (3 * 2 + 4) + 4
    blank = chip_smoke.init_cache(cfg, 4, 2112, device="meta")
    assert chip_smoke.xlstm_cache_bytes(cfg, 4) == sum(
        t.numel() * t.element_size() for t in chip_smoke.tree_leaves(blank))
    picks = {name: (path, idx) for name, path, idx in chip_smoke.xlstm_grad_picks(cfg)}
    assert picks["mlstm[41].wq"] == (("groups", "mlstm", "wq"), (5, 6))
    assert picks["slstm[5].r_gates"] == (("groups", "slstm", "r_gates"), (5,))


@pytest.fixture(scope="module")
def xlstm_drift_model():
    """The reduced bf16 xLSTM's greedy decode of 2 x 32-token prompts, 8 new
    tokens, on the CPU, with the tokens it serves."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step

    cfg, params = _small_xlstm()
    prompts = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    tok, _, cache = make_prefill_step(cfg, max_len=48)(params,
                                                       {"tokens": torch.from_numpy(prompts)})
    served = [tok]
    for _ in range(7):
        tok, cache = make_decode_step(cfg)(params, tok[:, None], cache)
        served.append(tok)
    return cfg, params, prompts, torch.stack(served, 1).numpy()


def test_xlstm_decode_drift_passes_on_a_small_cpu_run(xlstm_drift_model, monkeypatch):
    monkeypatch.setattr(chip_smoke, "LM_MAX_LEN", 48)
    monkeypatch.setattr(chip_smoke, "LM_NEW", 8)
    cfg, params, prompts, served = xlstm_drift_model
    out = chip_smoke.decode_drift(cfg, params, prompts, served, "cpu")
    assert out["teacher_forced_ssm_chunk"] == 13 and out["worst_ratio"] <= 2  # 39 = 3 x 13


@pytest.mark.parametrize("fault", ["mLSTM memory not written", "sLSTM carry not written"])
def test_xlstm_decode_drift_fails_a_cache_that_is_not_updated(xlstm_drift_model, monkeypatch,
                                                             fault):
    """An mLSTM decode that hands back its old C, or an sLSTM decode its
    old (c, n, m, h): the gate rejects the drift that follows."""
    monkeypatch.setattr(chip_smoke, "LM_MAX_LEN", 48)
    monkeypatch.setattr(chip_smoke, "LM_NEW", 8)
    cfg, params, prompts, served = xlstm_drift_model
    if fault.startswith("mLSTM"):
        inner = chip_smoke.lm_xlstm.mlstm_decode

        def faulty(p, x, c, n, m, cfg_):
            y, _, n2, m2 = inner(p, x, c, n, m, cfg_)
            return y, c, n2, m2
        monkeypatch.setattr(chip_smoke.lm_xlstm, "mlstm_decode", faulty)
    else:
        inner = chip_smoke.lm_xlstm.slstm_decode

        def faulty(p, x, c, n, m, h, cfg_):
            return (inner(p, x, c, n, m, h, cfg_)[0], c, n, m, h)
        monkeypatch.setattr(chip_smoke.lm_xlstm, "slstm_decode", faulty)
    with pytest.raises(AssertionError, match="drift|other tokens"):
        chip_smoke.decode_drift(cfg, params, prompts, served, "cpu")


# --------------------------------------------------- the sharded LM phase
def test_model_axis_bytes_sort_by_what_they_carry():
    """Expert weights by their path, gradients, the MoE activations, the
    router's share, the dense weights and the rest."""
    by_tag = {("gather", "param:layers.moe.wg"): 7, ("gather", "param:layers.attn.wq"): 5,
              ("psum", "moe.out"): 11, ("psum", "moe.x.grad"): 13,
              ("psum", "moe.weights.grad"): 3, ("psum_scatter", "grad:layers.moe.wd"): 2,
              ("psum", "grad_norm"): 4, ("gather", "param:layers.moe.wr"): 1}
    assert chip_smoke.model_axis_bytes(by_tag) == {
        "expert weights": 7, "gradients": 2, "moe activations": 24, "router": 3,
        "dense weights": 6, "other": 4}


@pytest.mark.parametrize("fault", [None, "expert", "gradient", "activations"])
def test_model_axis_gate_passes_and_fails_planted_faults(fault):
    by_tag = {("gather", "param:layers.attn.wq"): 5, ("psum", "moe.out"): 8,
              ("psum", "moe.x.grad"): 8, ("psum", "moe.weights.grad"): 3}
    if fault == "expert":
        by_tag[("gather", "param:layers.moe.wu")] = 9
    elif fault == "gradient":
        by_tag[("psum", "grad:embed")] = 9
    elif fault == "activations":
        by_tag[("psum", "moe.out")] = 16  # a psum too many
    if fault is None:
        assert chip_smoke.check_model_axis("t", by_tag, 16)["moe activations"] == 16
    else:
        with pytest.raises(AssertionError, match="crossed 'model'|MoE activations"):
            chip_smoke.check_model_axis("t", by_tag, 16)


def test_gap_filtered_tokens_compare_up_to_each_rows_first_close_call():
    want = np.array([[1, 2, 3, 4], [5, 6, 7, 8]])
    gaps = np.array([[0.9, 0.9, 0.1, 0.9], [0.9, 0.9, 0.9, 0.9]])
    got = want.copy()
    got[0, 2:] = [9, 9]  # row 0 parts at its close call (gap 0.1): not compared
    out = chip_smoke.gap_filtered_tokens("t", got, want, gaps, 0.2)
    assert out == {"compared": 6, "tokens": 8, "err": 0.2}
    got[1, 3] = 0  # a clear pick that differs
    with pytest.raises(AssertionError, match="row 1 step 3"):
        chip_smoke.gap_filtered_tokens("t", got, want, gaps, 0.2)


def test_decode_logits_into_takes_the_engines_own_decode_logits():
    """Teacher-forced through ``ServingEngine(mesh=)``'s decode step (on the
    host mesh here), each step's logits are those of ``decode_step`` on the
    same cache, and the hook is gone after the block."""
    import dataclasses

    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serving import ServingEngine

    cfg = dataclasses.replace(chip_smoke.lm_configs.get("granite-3-2b").reduced(),
                              dtype="float32")
    params = chip_smoke.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    engine = ServingEngine(cfg, params, slots=2, max_len=24, device="cpu",
                           mesh=make_host_mesh(device="cpu"))
    prompts = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32))
    fed = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 3)).astype(np.int32))
    _, _, cache = engine._prefill(params, {"tokens": prompts})
    _, _, ref = chip_smoke.make_prefill_step(cfg, max_len=24)(params, {"tokens": prompts})
    orig = steps.decode_step
    with chip_smoke.decode_logits_into([]) as got:
        for t in range(3):
            _, cache = engine._decode(params, fed[:, t:t + 1], cache)
    assert steps.decode_step is orig and len(got) == 3
    for t in range(3):
        want, ref = chip_smoke.TT.decode_step(params, cfg, fed[:, t:t + 1], ref)
        torch.testing.assert_close(got[t], want.float(), rtol=0, atol=0)
