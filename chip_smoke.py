"""Chip smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's hand-written CUDA kernels from ``src/repro_torch/csrc``,
holds each one against its plain PyTorch version on the card at the main
path's shapes, then drives the main path of the GBDT serve entry point:
16 boosting rounds of the paper's ``efficiency-realsim`` configuration
(depth 9, 64 bins, feature fraction 0.8, R = 0.8, v = 0.01, histogram
subtraction, 400-slot forest; dataset realsim-like, N = 4000, F = 1500)
under four round-robin PS workers, then a ``ForestServer`` answering raw
float requests with that forest and with a seeded full 400-slot forest.

It prints the card's name and power limit, a ``kernels`` JSON line (per
kernel: launches on the main path, error against the plain version, time,
the plain version's time, the bound, a library call's time) and, last,
``{"ok": true, "device": {...}}``. Every failure raises: the exit code is
then non-zero and the last line is not printed. Details go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.convert import forest_from_numpy  # noqa: E402
from repro_torch.core.sgbdt import SGBDTConfig, init_state  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import _build, forest_traversal, histogram, split_scan  # noqa: E402
from repro_torch.ps.engine import Trainer  # noqa: E402
from repro_torch.serving.forest_server import ForestServer, PredictRequest  # noqa: E402
from repro_torch.trees.binning import apply_bins, bin_dataset  # noqa: E402
from repro_torch.trees.forest import forest_predict  # noqa: E402
from repro_torch.trees.learner import LearnerConfig, _smaller_children  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 ops/s
# outside the tensor cores; the kernels' integer and float work is scalar.
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
SEED = 0
ROUNDS = 16
WORKERS = 4
# configs/gbdt.py "efficiency-realsim" of the JAX package (paper VI.C).
CFG = SGBDTConfig(
    n_trees=400, step_length=0.01, sampling_rate=0.8, loss="logistic",
    learner=LearnerConfig(depth=9, n_bins=64, feature_fraction=0.8, hist_mode="subtract"),
)
KERNELS = {
    "histogram": (histogram, "src/repro_torch/csrc/histogram.cu",
                  "src/repro/kernels/histogram.py:80"),
    "split_gain": (split_scan, "src/repro_torch/csrc/split_scan.cu",
                   "src/repro/kernels/split_scan.py:50"),
    "forest_traverse": (forest_traversal, "src/repro_torch/csrc/forest_traversal.cu",
                        "src/repro/kernels/forest_traversal.py:107"),
}


def cuda_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def close(name: str, got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float) -> float:
    """Require |got - want| <= atol + rtol |want| on finite cells and the same
    -inf cells exactly; returns the max abs error of the finite cells."""
    inf_got, inf_want = torch.isneginf(got), torch.isneginf(want)
    if not torch.equal(inf_got, inf_want):
        raise AssertionError(f"{name}: -inf masks differ in {int((inf_got ^ inf_want).sum())} cells")
    g, w = got[~inf_got], want[~inf_want]
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: non-finite values")
    err = (g - w).abs()
    if bool((err > atol + rtol * w.abs()).any()):
        raise AssertionError(f"{name}: max abs error {float(err.max())} over tolerance")
    return float(err.max()) if err.numel() else 0.0


def seeded_forest(rng: np.random.Generator, n_feat: int, base: float, dev) -> object:
    """A full 400-slot depth-9 forest of valid random trees."""
    depth = CFG.learner.depth
    slots, n_int = CFG.n_trees, (1 << depth) - 1
    return forest_from_numpy(
        rng.integers(0, n_feat, (slots, n_int)),
        rng.integers(0, CFG.learner.n_bins, (slots, n_int)),
        0.01 * rng.standard_normal((slots, 1 << depth)),
        slots, base, device=dev,
    )


def touched_bins(bins: torch.Tensor, forest, live: int) -> int:
    """Distinct (sample, feature) bin cells read by the walks of the first
    ``live`` trees of ``forest``."""
    n, f = bins.shape
    seen = torch.zeros(n * f, dtype=torch.bool, device=bins.device)
    row = torch.arange(n, device=bins.device)[:, None] * f
    tree = torch.arange(live, device=bins.device)[None, :]
    feature, threshold = forest.feature[:live].long(), forest.threshold[:live]
    node = torch.zeros((n, live), dtype=torch.long, device=bins.device)
    for _ in range(forest.depth):
        fid = feature[tree, node]
        seen[(row + fid).reshape(-1)] = True
        node = 2 * node + 1 + (bins.gather(1, fid) > threshold[tree, node]).long()
    return int(seen.sum())


def check_kernels(data, rng, report: dict) -> dict:
    """Phase 2: each kernel against its plain version at the main path's
    shapes, with its time, its plain version's time, its bound and a
    library call's time."""
    dev = data.bins.device
    n, f = data.bins.shape
    b = CFG.learner.n_bins
    state = init_state(CFG, data)
    g0, h0 = CFG.obj.grad_hess(data.labels, state.f)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    m = torch.binomial(torch.ones(n, device=dev), torch.full((n,), 0.8, device=dev),
                       generator=gen) / 0.8
    g, h = (m * g0).contiguous(), m.contiguous()
    out = {}

    # Histogram: the full level 0, and the smaller-child subset at level 8.
    node0 = torch.zeros(n, dtype=torch.int32, device=dev)
    node8 = torch.randint(0, 256, (n,), generator=gen, device=dev, dtype=torch.int32)
    node8 = torch.where(h > 0, node8, torch.full_like(node8, -1))
    active = _smaller_children(node8, h, 256)
    shapes = {}
    for tag, node, n_nodes, act in (("level0", node0, 1, None), ("level8_subset", node8, 256, active)):
        def run(node=node, n_nodes=n_nodes, act=act):
            return histogram.histogram(data.bins, node, g, h, n_nodes, b, act)
        k1, k2 = run(), run()
        torch.cuda.synchronize()
        if not torch.equal(k1, k2):
            raise AssertionError(f"histogram {tag}: two launches differ")
        plain = histogram.histogram_plain(data.bins, node, g, h, n_nodes, b, act)
        scale = float(plain.abs().max())
        err = close(f"histogram {tag}", k1, plain, 1e-5, 1e-5 * scale)
        rows = 1 if act is None else act.shape[0]
        hit = int((node >= 0).sum()) if act is None else int(
            torch.isin(node, act).sum())
        # Bytes the function needs: every node id, the bin rows and grad/hess
        # of the samples on built nodes only, the row map and the output.
        nbytes = 4 * (n + hit * (f + 2) + rows + 2 * rows * f * b)
        bms, by = bound(nbytes, 2.0 * f * hit)
        report.setdefault("histogram_samples_hit", {})[tag] = hit
        # Library yardstick: one index_add_ over precomputed cells.
        row_of = torch.full((n_nodes,), -1, dtype=torch.int64, device=dev)
        row_of[(torch.arange(n_nodes, device=dev) if act is None else act.long())] = \
            torch.arange(rows, device=dev)
        r = torch.where(node >= 0, row_of[node.long().clamp(min=0)], -1)
        keep = r >= 0
        cell = ((r[:, None] * f + torch.arange(f, device=dev)) * b + data.bins.long())[keep]
        seg = torch.cat([cell.reshape(-1), (cell + rows * f * b).reshape(-1)])
        vals = torch.cat([g[keep][:, None].expand(-1, f).reshape(-1),
                          h[keep][:, None].expand(-1, f).reshape(-1)])
        flat = torch.zeros(2 * rows * f * b, device=dev)
        shapes[tag] = {
            "max_abs_err": err, "ms": cuda_ms(run),
            "plain_ms": cuda_ms(lambda node=node, n_nodes=n_nodes, act=act:
                                histogram.histogram_plain(data.bins, node, g, h, n_nodes, b, act),
                                reps=5),
            "bound_ms": bms, "bound_by": by,
            "library_ms": cuda_ms(lambda: flat.index_add_(0, seg, vals)),
        }
    out["histogram"] = dict(shapes["level8_subset"])
    out["histogram"]["max_abs_err"] = max(s["max_abs_err"] for s in shapes.values())
    report["histogram_shapes"] = shapes

    # Split gain at L = 256, on a real level-8 histogram.
    hist = histogram.histogram(data.bins, node8, g, h, 256, b)
    lam, min_h = CFG.learner.lam, CFG.learner.min_child_hess
    gain = split_scan.split_gain(hist, lam, min_h)
    plain = split_scan.split_gain_plain(hist, lam, min_h)
    finite = plain[torch.isfinite(plain)]
    scale = float(finite.abs().max()) if finite.numel() else 1.0
    cells = 256 * f * b
    bms, by = bound(4 * 3 * cells, 12 * cells)
    out["split_gain"] = {
        "max_abs_err": close("split_gain", gain, plain, 1e-5, 1e-5 * scale),
        "ms": cuda_ms(lambda: split_scan.split_gain(hist, lam, min_h)),
        "plain_ms": cuda_ms(lambda: split_scan.split_gain_plain(hist, lam, min_h), reps=5),
        "bound_ms": bms, "bound_by": by, "library_ms": None,
    }
    # The argmax stays in torch: its tie-break must be the first maximum.
    tie = torch.full((4, f * b), float("-inf"), device=dev)
    tie[:, [7, f * b // 2, f * b - 2]] = 3.5
    tie[1, 5] = 3.5
    if torch.argmax(tie, dim=-1).tolist() != [7, 5, 7, 7]:
        raise AssertionError("torch.argmax on the card does not pick the first maximum")

    # Traversal: 4000 rows x 400 slots, n_trees = 400 and 16.
    forest = seeded_forest(rng, f, 0.0, dev)
    depth = forest.depth
    shapes = {}
    for live in (400, 16):
        nt = torch.tensor(live, dtype=torch.int32, device=dev)

        def run(nt=nt):
            return forest_traversal.forest_traverse(
                data.bins, forest.feature, forest.threshold, forest.leaf_value, nt, depth)
        got = run()
        want = forest_traversal.forest_traverse_plain(
            data.bins, forest.feature, forest.threshold, forest.leaf_value, nt, depth)
        err = close(f"forest_traverse n_trees={live}", got, want, 1e-6, 1e-6)
        # Bytes the function needs: the bin cells the walks read, the live
        # trees' arrays, n_trees and the output.
        cells = touched_bins(data.bins, forest, live)
        nbytes = 4 * (cells + live * (3 * (1 << depth) - 2) + 1 + n)
        bms, by = bound(nbytes, n * live * (3 * depth + 1))
        shapes[f"n_trees={live}"] = {
            "max_abs_err": err, "ms": cuda_ms(run),
            "plain_ms": cuda_ms(lambda nt=nt: forest_traversal.forest_traverse_plain(
                data.bins, forest.feature, forest.threshold, forest.leaf_value, nt, depth),
                reps=2, warmup=1),
            "bound_ms": bms, "bound_by": by, "library_ms": None,
        }
        report.setdefault("forest_traverse_bin_cells_read", {})[f"n_trees={live}"] = cells
    out["forest_traverse"] = dict(shapes["n_trees=400"])
    out["forest_traverse"]["max_abs_err"] = max(s["max_abs_err"] for s in shapes.values())
    report["forest_traverse_shapes"] = shapes
    return out


def train(data, round_s: list | None = None):
    """Phase 3: 16 rounds of efficiency-realsim under round-robin W = 4."""
    def tick(state, j):
        torch.cuda.synchronize()
        round_s.append(time.perf_counter())

    if round_s is not None:
        torch.cuda.synchronize()
        round_s.append(time.perf_counter())
    return Trainer(CFG, device=data.bins.device).train(
        data, ("round_robin", WORKERS), seed=SEED, rounds=ROUNDS,
        eval_every=1 if round_s is not None else 0, eval_fn=tick,
    )


def serve(forest, x: np.ndarray, edges, rng) -> tuple:
    """Phase 4: 8 raw-float requests of 1..600 rows, one of them oversized;
    returns (server, requests, results)."""
    server = ForestServer(forest, edges, max_rows=256, objective="logistic",
                          device=edges.device)
    sizes = [600] + [int(s) for s in rng.integers(1, 257, 7)]
    reqs = []
    for uid, size in enumerate(sizes):
        lo = int(rng.integers(0, x.shape[0] - size + 1))
        reqs.append(PredictRequest(uid, x[lo:lo + size]))
    return server, reqs, server.run(reqs)


def check_served(tag: str, server, reqs, results) -> dict:
    """Every request answered, each answer equal to link(forest_predict),
    with the forest sum taken by the traversal's plain version."""
    if [r.uid for r in results] != list(range(len(reqs))):
        raise AssertionError(f"{tag}: not every request was answered")
    err = 0.0
    fo = server.forest
    for req, res in zip(reqs, results):
        bins = apply_bins(torch.from_numpy(req.x).to(server.device), server.bin_edges)
        raw = fo.base_score + forest_traversal.forest_traverse_plain(
            bins, fo.feature, fo.threshold, fo.leaf_value, fo.n_trees, fo.depth)
        want = CFG.obj.link(raw).cpu().numpy()
        if res.scores.shape != want.shape or not np.isfinite(res.scores).all():
            raise AssertionError(f"{tag}: request {req.uid} came back malformed")
        np.testing.assert_allclose(res.scores, want, rtol=1e-6, atol=1e-7)
        err = max(err, float(np.abs(res.scores - want).max()))
    lat = np.array([r.latency_s for r in results]) * 1e3
    return {"requests": len(results), "rows": [len(r.x) for r in reqs],
            "waves": server.waves_served,
            "latency_p50_ms": float(np.percentile(lat, 50)),
            "latency_p99_ms": float(np.percentile(lat, 99)), "max_abs_err": err}


def profile_rounds(data, rounds: int = 2) -> dict:
    """Where a training round's device time goes: ``torch.profiler`` over a
    short run (after a warm-up round), device time by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    trainer = Trainer(CFG, device=data.bins.device)
    trainer.train(data, ("round_robin", WORKERS), seed=SEED, rounds=1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train(data, ("round_robin", WORKERS), seed=SEED, rounds=rounds)
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    return {"rounds": rounds, "device_ms_per_round": sum(r[1] for r in rows) / rounds,
            "top": [{"name": k[:80], "device_ms_per_round": ms / rounds, "calls": c}
                    for k, ms, c in rows[:12]]}


def drive(dev: torch.device, report: dict) -> list:
    """Phases 2 to 5 on ``dev``; returns the ``kernels`` line's entries."""
    spec = synthetic.PAPER_DATASETS["realsim-like"]
    x, y, mult = synthetic.raw(spec)
    data = bin_dataset(x, y, n_bins=64, multiplicity=mult, device=dev)
    rng = np.random.default_rng(SEED)

    # Phase 2: every kernel against its plain version.
    kstats = check_kernels(data, rng, report)
    print("kernel checks: " + json.dumps(
        {k: {"max_abs_err": v["max_abs_err"], "ms": v["ms"]} for k, v in kstats.items()}),
        flush=True)

    # Phases 3 and 4 are the main path; only their launches are counted.
    for mod, _, _ in KERNELS.values():
        mod.launches = 0
    torch.cuda.reset_peak_memory_stats()
    stamps: list = []
    state = train(data, stamps)
    again = train(data)
    served = serve(state.forest, x, data.bin_edges, rng)
    seeded = seeded_forest(rng, data.n_features, float(state.forest.base_score), dev)
    full = serve(seeded, x, data.bin_edges, rng)
    torch.cuda.synchronize()
    counts = {name: mod.launches for name, (mod, _, _) in KERNELS.items()}

    # The checks of phases 3 and 4 (their launches are not counted).
    round_ms = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
    print("round ms: " + " ".join(f"{t:.1f}" for t in round_ms), flush=True)
    loss0 = float(CFG.obj.loss(data.labels, init_state(CFG, data).f, data.multiplicity))
    loss = float(CFG.obj.loss(data.labels, state.f, data.multiplicity))
    print(f"train loss {loss0:.6f} -> {loss:.6f} after {ROUNDS} rounds", flush=True)
    if not (np.isfinite(loss) and loss < loss0):
        raise AssertionError("training loss did not fall")
    for name in ("feature", "threshold", "leaf_value", "n_trees"):
        if not torch.equal(getattr(state.forest, name), getattr(again.forest, name)):
            raise AssertionError(f"second run differs in forest.{name}")
    if not torch.equal(state.f, again.f):
        raise AssertionError("second run differs in f")
    torch.testing.assert_close(forest_predict(state.forest, data.bins), state.f,
                               rtol=1e-5, atol=1e-6)
    served = check_served("trained forest", *served)
    full = check_served("seeded 400-slot forest", *full)
    for label, s in (("trained", served), ("seeded 400-slot", full)):
        print(f"serve {label}: {s['requests']} requests over {s['waves']} waves, latency "
              f"p50 {s['latency_p50_ms']:.3f} ms p99 {s['latency_p99_ms']:.3f} ms", flush=True)
    report.update(round_ms=round_ms, loss=[loss0, loss], serve_trained=served,
                  serve_seeded=full, launches=counts,
                  peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30, kernels=kstats)
    if dev.type == "cuda":
        report["profile"] = prof = profile_rounds(data)
        # Busy share: profiled device time per round over the median wall
        # time of an unprofiled round (the first round is warm-up).
        prof["device_busy_share"] = prof["device_ms_per_round"] / float(
            np.median(round_ms[1:]))
        print(f"profile: device {prof['device_ms_per_round']:.2f} ms per round, busy "
              f"{100 * prof['device_busy_share']:.0f}% of a round's wall time", flush=True)

    # Phase 5: the kernels line; every kernel of the path must have run.
    line = []
    for name, (_, source, replaces) in KERNELS.items():
        if counts[name] <= 0:
            raise AssertionError(f"{name}: no launch on the main path")
        line.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": counts[name], **kstats[name]})
    return line


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    report: dict = {"nvidia_smi": smi, "torch": torch.__version__,
                    "cuda": torch.version.cuda}

    # Phase 1: build.
    t0 = time.perf_counter()
    libs = _build.build_all()
    report["build_s"] = time.perf_counter() - t0
    print(f"build: {len(libs)} kernel libraries in {report['build_s']:.1f} s", flush=True)
    for name, lib in libs.items():
        log = (lib.parent / f"{name}.log").read_text()
        report[f"ptxas_{name}"] = [ln for ln in log.splitlines() if "registers" in ln
                                   or "spill" in ln]
    line = drive(torch.device("cuda"), report)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
