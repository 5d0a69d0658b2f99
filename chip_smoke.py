"""Chip smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's hand-written CUDA kernels from ``src/repro_torch/csrc``,
holds each one against its plain PyTorch version on the card at the main
path's shapes, then drives the main path of the GBDT train and serve entry
points: 16 boosting rounds of the paper's ``efficiency-realsim``
configuration (depth 9, 64 bins, feature fraction 0.8, R = 0.8, v = 0.01,
histogram subtraction, 400-slot forest; dataset realsim-like, N = 4000,
F = 1500) under four round-robin PS workers, three ways: staged (twice),
with the fused level (``backend="fused"``: levels 0-4 as one fused level
each, 5-8 staged; its forest must be the staged one bit for bit) and on
the sparse layout (``bin_dataset(..., sparse=True)``, twice); then a
``ForestServer`` answering raw float requests with the staged forest and
with a seeded full 400-slot forest.

Then the LM zoo's serving path: the flash-attention kernel against its
plain version at the serving prefill's shape and at ragged shapes, and
granite-3-2b at full width (40 layers, d_model 2048, bf16, seeded random
weights, ``attn_impl="flash"``) served through ``ServingEngine`` in two
waves of four requests (2048- and 1024-token prompts, 32 new tokens
each), twice; the flash prefill's logits are held against the chunked
path's.

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

import dataclasses  # noqa: E402

import repro_torch.configs as lm_configs  # noqa: E402
from repro_torch.convert import forest_from_numpy  # noqa: E402
from repro_torch.core.sgbdt import SGBDTConfig, init_state  # noqa: E402
from repro_torch.data.sampling import bernoulli_weights  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    _build,
    flash_attention,
    forest_traversal,
    histogram,
    histogram_sparse,
    level_build,
    ref,
    split_scan,
)
from repro_torch.launch.steps import make_decode_step, make_prefill_step  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.ps.engine import Trainer  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402
from repro_torch.serving.forest_server import ForestServer, PredictRequest  # noqa: E402
from repro_torch.trees.binning import apply_bins, bin_dataset, gather_feature_bins  # noqa: E402
from repro_torch.trees.forest import forest_predict  # noqa: E402
from repro_torch.trees.learner import (  # noqa: E402
    LearnerConfig,
    _smaller_children,
    _staged_level,
    build_tree,
)

# Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 ops/s
# outside the tensor cores; the kernels' integer and float work is scalar.
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
PEAK_BF16_S = 989e12  # dense bf16 tensor-core rate
SEED = 0
ROUNDS = 16
WORKERS = 4
# configs/gbdt.py "efficiency-realsim" of the JAX package (paper VI.C).
CFG = SGBDTConfig(
    n_trees=400, step_length=0.01, sampling_rate=0.8, loss="logistic",
    learner=LearnerConfig(depth=9, n_bins=64, feature_fraction=0.8, hist_mode="subtract"),
)
CFG_FUSED = CFG._replace(learner=CFG.learner._replace(backend="fused"))
KERNELS = {
    "histogram": (histogram, "src/repro_torch/csrc/histogram.cu",
                  "src/repro/kernels/histogram.py:80"),
    "split_gain": (split_scan, "src/repro_torch/csrc/split_scan.cu",
                   "src/repro/kernels/split_scan.py:50"),
    "forest_traverse": (forest_traversal, "src/repro_torch/csrc/forest_traversal.cu",
                        "src/repro/kernels/forest_traversal.py:107"),
    "level_build": (level_build, "src/repro_torch/csrc/level_build.cu",
                    "src/repro/kernels/level_build.py:199"),
    "histogram_sparse": (histogram_sparse, "src/repro_torch/csrc/histogram_sparse.cu",
                         "src/repro/kernels/histogram_sparse.py:87"),
}

# The LM zoo's serving path: granite-3-2b at full width through the flash
# kernel; its prompts are the prefill shape the kernel is checked at.
LM_ARCH = "granite-3-2b"
LM_SLOTS, LM_MAX_LEN, LM_NEW = 4, 2112, 32
LM_PROMPTS = (2048, 1024)  # one wave of LM_SLOTS requests each
LM_KERNELS = {
    "flash_attention": (flash_attention, "src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:105"),
}
# (b, sq, sk, h, kv, d, causal, dtype): the ragged edges of the kernel.
FLASH_RAGGED = [
    (1, 100, 100, 4, 2, 32, True, torch.bfloat16),
    (1, 96, 96, 2, 2, 128, False, torch.bfloat16),
    (2, 64, 192, 4, 4, 64, False, torch.bfloat16),
    (1, 100, 100, 4, 2, 80, True, torch.float32),
]


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


def bound(nbytes: float, ops: float, peak_ops: float = PEAK_OPS_S) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / peak_ops * 1e3
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


def fused_levels(n: int, n_feat: int) -> list:
    """The levels of an efficiency-realsim tree that run as a fused level."""
    lc = CFG.learner
    return [lv for lv in range(lc.depth) if level_build.fused_level_fits(
        n, 1 << lv, max(1, (1 << lv) // 2), n_feat, lc.n_bins)]


def check_level_build(data, g, h, gen, report: dict) -> dict:
    """The fused level at realsim level 0 (full) and at the deepest level
    that fuses (subtract mode): against its plain version (integer outputs
    exact; histogram and best gain within 1e-5 x max|cell|), bitwise against
    the learner's staged level on the same inputs, two launches bitwise."""
    dev = data.bins.device
    n, f = data.bins.shape
    b, lc = CFG.learner.n_bins, CFG.learner
    mask = torch.rand(f, generator=gen, device=dev) < lc.feature_fraction
    mask_i = mask.to(torch.int32)
    deep = fused_levels(n, f)[-1]
    shapes = {}
    for level in (0, deep):
        n_nodes = 1 << level
        derive = level > 0
        node = torch.randint(0, n_nodes, (n,), generator=gen, device=dev, dtype=torch.int32)
        parent, active = None, torch.zeros(1, dtype=torch.int32, device=dev)
        if derive:
            parent = histogram.histogram(data.bins, node >> 1, g, h, n_nodes // 2, b)
            active = _smaller_children(node, h, n_nodes)
        args = (data.bins, node, g, h, active, parent, mask_i, lc.lam, lc.min_child_hess,
                n_nodes, b, derive)

        def run(args=args):
            return level_build.level_build(*args)
        k1, k2 = run(), run()
        torch.cuda.synchronize()
        tag = f"level{level}"
        for a, c in zip(k1, k2):
            if not torch.equal(a, c):
                raise AssertionError(f"level_build {tag}: two launches differ")
        staged = _staged_level(lc, data.bins, node, g, h, mask, level, parent)
        for name, a, c in zip(("hist", "feat", "thr", "new_node"),
                              (k1[0], k1[1], k1[2], k1[4]), staged):
            if not torch.equal(a, c):
                raise AssertionError(
                    f"level_build {tag}: {name} differs from the staged level")
        plain = level_build.level_build_plain(*args)
        scale = float(plain[0].abs().max())
        err = max(close(f"level_build {tag} hist", k1[0], plain[0], 1e-5, 1e-5 * scale),
                  close(f"level_build {tag} best_gain", k1[3], plain[3], 1e-5, 1e-5 * scale))
        # Integer outputs exact, up to ties: at realsim the first tree's
        # gradients take two values (one per label) and most features hold a
        # few stored entries, so many (feature, threshold) pairs tie in exact
        # arithmetic. The plain version's atomics round the tied gains
        # differently and may pick another of them. Where the two pick
        # different splits, the kernel's must tie the plain best within the
        # gain tolerance under the plain version's own gains; the samples of
        # every node where they agree must be routed alike.
        differ = (k1[1] != plain[1]) | (k1[2] != plain[2])
        if bool(differ.any()):
            gain = split_scan.split_gain_plain(plain[0], lc.lam, lc.min_child_hess)
            flat = gain.masked_fill(~mask[None, :, None], float("-inf")).reshape(n_nodes, -1)
            picked = flat.gather(1, (k1[1].long() * b + k1[2].long())[:, None])[:, 0]
            tie = (picked - plain[3]).abs() <= 1e-5 * plain[3].abs()
            if not bool(tie[differ].all()):
                raise AssertionError(f"level_build {tag}: feat/thr differ from the plain "
                                     "version at a node without a tie")
        agree = ~differ[node.long()]
        if not torch.equal(k1[4][agree], plain[4][agree]):
            raise AssertionError(f"level_build {tag}: new_node differs from the plain version")
        report.setdefault("level_build_tied_nodes", {})[tag] = int(differ.sum())
        n_sub = active.shape[0]
        hit = int(torch.isin(node, active).sum())
        routed = int((node >= 0).sum())
        cells = n_nodes * f * b
        # Bytes the level needs: node ids, the bin rows and grad/hess of the
        # samples on built nodes, the active list, the parent cache, the
        # level histogram written, the split vectors, one bin per routed
        # sample and the new node ids. Operations: two adds a built cell,
        # about a dozen a scanned cell (unmasked features).
        nbytes = 4 * (n + hit * (f + 2) + n_sub + (2 * n_sub * f * b if derive else 0)
                      + 2 * cells + 3 * n_nodes + routed + n)
        ops = 2.0 * f * hit + 12.0 * n_nodes * int(mask.sum()) * b
        bms, by = bound(nbytes, ops)
        shapes[tag] = {
            "max_abs_err": err, "ms": cuda_ms(run),
            "plain_ms": cuda_ms(lambda args=args: level_build.level_build_plain(*args),
                                reps=5),
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "staged_ms": cuda_ms(lambda node=node, parent=parent, level=level: _staged_level(
                lc, data.bins, node, g, h, mask, level, parent)),
            "samples_hit": hit,
        }
    report["level_build_shapes"] = shapes
    report["level_build_bitwise_vs_staged"] = True
    out = dict(shapes[f"level{deep}"])
    out["max_abs_err"] = max(s["max_abs_err"] for s in shapes.values())
    for key in ("staged_ms", "samples_hit"):
        out.pop(key)
    return out


def check_histogram_sparse(sp, node8, active, g, h, report: dict) -> dict:
    """The stored-entry sparse histogram at level 0 and at the level-8
    smaller-child subset: within 1e-5 x max|cell| of its plain version, two
    launches bitwise."""
    dev = sp.feat_rows.device
    f, c = sp.feat_rows.shape
    b = CFG.learner.n_bins
    node0 = torch.zeros(sp.n_samples, dtype=torch.int32, device=dev)
    valid = sp.feat_rows >= 0
    safe = torch.where(valid, sp.feat_rows, 0).long()
    shapes = {}
    for tag, node, n_nodes, act in (("level0", node0, 1, None),
                                    ("level8_subset", node8, 256, active)):
        args = (sp.feat_rows, sp.feat_codes, node, g, h, n_nodes, b, act)

        def run(args=args):
            return histogram_sparse.histogram_sparse(*args)
        k1, k2 = run(), run()
        torch.cuda.synchronize()
        if not torch.equal(k1, k2):
            raise AssertionError(f"histogram_sparse {tag}: two launches differ")
        plain = histogram_sparse.histogram_sparse_plain(*args)
        scale = float(plain.abs().max())
        err = close(f"histogram_sparse {tag}", k1, plain, 1e-5, 1e-5 * scale)
        rows = k1.shape[1]
        # Library yardstick: one index_add_ over the precomputed cells of the
        # stored entries that land on a built row.
        e_row = ref.node_rows(torch.where(valid, node[safe], -1), act, n_nodes)
        keep = e_row >= 0
        cell = ((e_row * f + torch.arange(f, device=dev)[:, None]) * b
                + sp.feat_codes.long())[keep]
        seg = torch.cat([cell, cell + rows * f * b])
        vals = torch.cat([g[safe][keep], h[safe][keep]])
        flat = torch.zeros(2 * rows * f * b, device=dev)
        nnz = int(valid.sum())
        # Bytes the function needs: the (F, C) store, the node/grad/hess of
        # the stored entries, the row list and the (2, R, F, B) output.
        bms, by = bound(4 * (2 * f * c + 3 * nnz + rows + 2 * rows * f * b),
                        2.0 * int(keep.sum()))
        shapes[tag] = {
            "max_abs_err": err, "ms": cuda_ms(run),
            "plain_ms": cuda_ms(
                lambda args=args: histogram_sparse.histogram_sparse_plain(*args), reps=5),
            "bound_ms": bms, "bound_by": by,
            "library_ms": cuda_ms(lambda: flat.index_add_(0, seg, vals)),
            "entries_hit": int(keep.sum()),
        }
    report["histogram_sparse_shapes"] = shapes
    report["sparse_store"] = {"F": f, "C": c, "E": sp.indices.shape[1], "nnz": nnz}
    out = dict(shapes["level8_subset"])
    out["max_abs_err"] = max(s["max_abs_err"] for s in shapes.values())
    out.pop("entries_hit")
    return out


def check_kernels(data, sp, rng, report: dict) -> dict:
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

    out["level_build"] = check_level_build(data, g, h, gen, report)
    out["histogram_sparse"] = check_histogram_sparse(sp, node8, active, g, h, report)
    return out


def train(data, cfg=CFG, round_s: list | None = None, fused_per_round: list | None = None):
    """Phase 3: 16 rounds of efficiency-realsim (``cfg``: staged or fused)
    under round-robin W = 4. ``round_s`` collects a host time stamp after
    each round (and one before the first); ``fused_per_round`` the fused
    levels each round's tree ran."""
    marks = [level_build.launches]

    def tick(state, j):
        torch.cuda.synchronize()
        round_s.append(time.perf_counter())
        marks.append(level_build.launches)

    if round_s is not None:
        torch.cuda.synchronize()
        round_s.append(time.perf_counter())
    state = Trainer(cfg, device=data.bins.device).train(
        data, ("round_robin", WORKERS), seed=SEED, rounds=ROUNDS,
        eval_every=1 if round_s is not None else 0, eval_fn=tick,
    )
    if fused_per_round is not None:
        fused_per_round.extend(b - a for a, b in zip(marks, marks[1:]))
    return state


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


def profile_rounds(data, cfg, rounds: int = 2) -> dict:
    """Where a training round's device time goes: ``torch.profiler`` over a
    short run (after a warm-up round), device time by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    trainer = Trainer(cfg, device=data.bins.device)
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


def first_tree_ties(data, dense, sparse) -> int:
    """The heap nodes of the first tree's levels 0-2 where the sparse run's
    split differs from the dense run's, below agreeing ancestors. Each must
    be a tie: under the dense histogram of the node's samples the two splits'
    gains agree within 1e-5 (relative). At realsim the first tree's
    gradients take two values, so distinct splits that move the same counts
    of each label tie in exact arithmetic, and the two layouts' sums round
    them differently."""
    dev, b, lc = data.bins.device, CFG.learner.n_bins, CFG.learner
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)  # round 0's draws, as ``propose_tree`` takes them
    m, _ = bernoulli_weights(gen, CFG.sampling_rate, data.multiplicity)
    mask = torch.rand(data.n_features, generator=gen, device=dev) < lc.feature_fraction
    g0, _ = CFG.obj.grad_hess(data.labels, init_state(CFG, data).f)
    tree = build_tree(lc, data.bins, m * g0, m, mask)
    fd, td = dense.forest.feature[0], dense.forest.threshold[0]
    if not (torch.equal(tree.feature, fd) and torch.equal(tree.threshold, td)):
        raise AssertionError("round 0's draws do not rebuild the first tree")
    fs, ts = sparse.forest.feature[0], sparse.forest.threshold[0]
    heap = torch.zeros(data.n_samples, dtype=torch.int64, device=dev)
    ties, agree = 0, {0}
    for i in range(7):
        if i in (1, 3):  # the next level: route every sample one step down
            right = gather_feature_bins(data.bins, fd.long()[heap]) > td[heap]
            heap = 2 * heap + 1 + right.long()
        if i not in agree:
            continue
        if (fd[i], td[i]) == (fs[i], ts[i]):
            agree |= {2 * i + 1, 2 * i + 2}
            continue
        on = torch.where(heap == i, 0, -1).to(torch.int32)
        hist = histogram.histogram_plain(data.bins, on, m * g0, m, 1, b)
        gain = split_scan.split_gain_plain(hist, lc.lam, lc.min_child_hess)
        gain = gain.masked_fill(~mask[None, :, None], float("-inf")).reshape(-1)
        gd, gs = gain[fd[i] * b + td[i]], gain[fs[i] * b + ts[i]]
        if not bool((gd - gs).abs() <= 1e-5 * gd.abs()):
            raise AssertionError(f"sparse run: first tree's node {i} splits differently "
                                 f"without a tie (gains {float(gd)} vs {float(gs)})")
        ties += 1
    return ties


def same_forest(tag: str, a, b) -> None:
    """Require two training states to be bitwise equal."""
    for name in ("feature", "threshold", "leaf_value", "n_trees"):
        if not torch.equal(getattr(a.forest, name), getattr(b.forest, name)):
            raise AssertionError(f"{tag}: forest.{name} differs")
    if not torch.equal(a.f, b.f):
        raise AssertionError(f"{tag}: f differs")


def drive(dev: torch.device, report: dict) -> list:
    """Phases 2 to 5 on ``dev``; returns the ``kernels`` line's entries."""
    spec = synthetic.PAPER_DATASETS["realsim-like"]
    x, y, mult = synthetic.raw(spec)
    data = bin_dataset(x, y, n_bins=64, multiplicity=mult, device=dev)
    sparse = bin_dataset(x, y, n_bins=64, multiplicity=mult, device=dev, sparse=True)
    rng = np.random.default_rng(SEED)

    # Phase 2: every kernel against its plain version.
    kstats = check_kernels(data, sparse.bins, rng, report)
    print("kernel checks: " + json.dumps(
        {k: {"max_abs_err": v["max_abs_err"], "ms": v["ms"]} for k, v in kstats.items()}),
        flush=True)
    print("level_build bitwise equal to the staged level at levels "
          + ", ".join(report["level_build_shapes"]), flush=True)

    # Phases 3 and 4 are the main path; only their launches are counted.
    for mod, _, _ in KERNELS.values():
        mod.launches = 0
    torch.cuda.reset_peak_memory_stats()
    stamps: dict = {"staged": [], "fused": [], "sparse": []}
    fused_per_round: list = []
    state = train(data, CFG, stamps["staged"])
    again = train(data, CFG)
    fused = train(data, CFG_FUSED, stamps["fused"], fused_per_round)
    sp1 = train(sparse, CFG, stamps["sparse"])
    sp2 = train(sparse, CFG)
    served = serve(state.forest, x, data.bin_edges, rng)
    seeded = seeded_forest(rng, data.n_features, float(state.forest.base_score), dev)
    full = serve(seeded, x, data.bin_edges, rng)
    torch.cuda.synchronize()
    counts = {name: mod.launches for name, (mod, _, _) in KERNELS.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    # The checks of phases 3 and 4 (their launches are not counted).
    round_ms = {k: [1e3 * (b - a) for a, b in zip(v, v[1:])] for k, v in stamps.items()}
    median_ms = {k: float(np.median(v[1:])) for k, v in round_ms.items()}
    for k, v in round_ms.items():
        print(f"round ms ({k}): " + " ".join(f"{t:.1f}" for t in v), flush=True)
    print("median round ms (rounds 2-16): "
          + ", ".join(f"{k} {v:.2f}" for k, v in median_ms.items())
          + f"; peak device memory {peak_gb:.2f} GB", flush=True)
    loss0 = float(CFG.obj.loss(data.labels, init_state(CFG, data).f, data.multiplicity))
    loss = float(CFG.obj.loss(data.labels, state.f, data.multiplicity))
    loss_sp = float(CFG.obj.loss(data.labels, sp1.f, data.multiplicity))
    print(f"train loss {loss0:.6f} -> {loss:.6f} after {ROUNDS} rounds (sparse layout "
          f"{loss_sp:.6f})", flush=True)
    if not (np.isfinite(loss) and loss < loss0):
        raise AssertionError("training loss did not fall")
    same_forest("second staged run", state, again)
    torch.testing.assert_close(forest_predict(state.forest, data.bins), state.f,
                               rtol=1e-5, atol=1e-6)

    # (i) The fused run: the staged forest bit for bit.
    want = fused_levels(data.n_samples, data.n_features)
    if fused_per_round != [len(want)] * ROUNDS:
        raise AssertionError(f"fused levels per tree {fused_per_round}, expected {len(want)}")
    same_forest("fused run vs staged run", fused, state)
    print(f"fused run: levels {want} fused in each of the {ROUNDS} trees, levels "
          f"{[lv for lv in range(CFG.learner.depth) if lv not in want]} staged; forest and f "
          "bitwise equal to the staged run", flush=True)

    # (ii) The sparse layout: deterministic, the loss falls to within 1e-3 of
    # the dense run's, the first tree's levels 0-2 are the dense run's.
    same_forest("second sparse run", sp1, sp2)
    if not (np.isfinite(loss_sp) and loss_sp < loss0 and abs(loss_sp - loss) <= 1e-3):
        raise AssertionError(f"sparse loss {loss_sp} vs dense {loss} (start {loss0})")
    ties = first_tree_ties(data, state, sp1)
    torch.testing.assert_close(forest_predict(sp1.forest, data.bins), sp1.f,
                               rtol=1e-5, atol=1e-6)
    print(f"sparse run: two runs bitwise equal; loss {loss_sp:.6f} vs dense {loss:.6f} "
          f"(|diff| {abs(loss_sp - loss):.2e}); first tree's levels 0-2 equal to the dense "
          f"run's up to {ties} tied node(s)", flush=True)

    served = check_served("trained forest", *served)
    full = check_served("seeded 400-slot forest", *full)
    for label, s in (("trained", served), ("seeded 400-slot", full)):
        print(f"serve {label}: {s['requests']} requests over {s['waves']} waves, latency "
              f"p50 {s['latency_p50_ms']:.3f} ms p99 {s['latency_p99_ms']:.3f} ms", flush=True)
    report.update(round_ms=round_ms, median_round_ms=median_ms, fused_levels=want,
                  sparse_first_tree_ties=ties,
                  loss={"start": loss0, "staged": loss, "sparse": loss_sp},
                  serve_trained=served, serve_seeded=full, launches=counts,
                  peak_mem_gb=peak_gb, kernels=kstats)
    if dev.type == "cuda":
        report["profile"] = {}
        for tag, d, cfg in (("staged", data, CFG), ("fused", data, CFG_FUSED),
                            ("sparse", sparse, CFG)):
            prof = report["profile"][tag] = profile_rounds(d, cfg)
            # Busy share: profiled device time per round over the median wall
            # time of an unprofiled round (the first round is warm-up).
            prof["device_busy_share"] = prof["device_ms_per_round"] / median_ms[tag]
            print(f"profile ({tag}): device {prof['device_ms_per_round']:.2f} ms per round, "
                  f"busy {100 * prof['device_busy_share']:.0f}% of a round's wall time",
                  flush=True)

    # Phase 5: the kernels line; every kernel of the path must have run.
    line = []
    for name, (_, source, replaces) in KERNELS.items():
        if counts[name] <= 0:
            raise AssertionError(f"{name}: no launch on the main path")
        line.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": counts[name], **kstats[name]})
    return line


def check_flash(dev, report: dict) -> dict:
    """The flash kernel against its plain version (the f32 softmax) at the
    serving prefill's shape and at the ragged shapes, two launches bitwise.
    Tolerances: bf16 out atol/rtol 2e-2 (the kernel rounds p to bf16 before
    p . v, as the TPU kernel does; the plain version keeps p in f32) and
    lse 1e-3; f32 1e-4 for both. Times at the prefill's shape, beside
    ``scaled_dot_product_attention`` on the same inputs (contiguous)."""
    cfg = lm_configs.get(LM_ARCH)
    b, s = LM_SLOTS, LM_PROMPTS[0]
    cases = [(b, s, s, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, True, torch.bfloat16)]
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    shapes, out = {}, None
    for bq, sq, sk, h, kv, d, causal, dtype in cases + FLASH_RAGGED:
        # Model layout (B, S, H, d), read by the kernel in place.
        q, k, v = (torch.randn(shape, generator=gen).to(dev, dtype).transpose(1, 2)
                   for shape in ((bq, sq, h, d), (bq, sk, kv, d), (bq, sk, kv, d)))

        def run(q=q, k=k, v=v, causal=causal):
            return flash_attention.flash_attention(q, k, v, causal)
        (o1, l1), (o2, l2) = run(), run()
        torch.cuda.synchronize()
        tag = f"{bq}x{sq}x{sk} h{h}/{kv} d{d} {'causal' if causal else 'full'} " + \
            str(dtype).split(".")[-1]
        if not (torch.equal(o1, o2) and torch.equal(l1, l2)):
            raise AssertionError(f"flash_attention {tag}: two launches differ")
        want, want_lse = flash_attention.flash_attention_plain(q, k, v, causal)
        bf16 = dtype == torch.bfloat16
        err = close(f"flash_attention {tag} out", o1.float(), want.float(),
                    2e-2 if bf16 else 1e-4, 2e-2 if bf16 else 1e-4)
        err_lse = close(f"flash_attention {tag} lse", l1, want_lse,
                        1e-3 if bf16 else 1e-4, 1e-3 if bf16 else 1e-4)
        shapes[tag] = {"max_abs_err": err, "max_abs_err_lse": err_lse}
        if out is None:  # the prefill's shape: times and bound
            el = q.element_size()
            # Bytes: q, k, v read once, out written once, lse; operations:
            # two products of 2d flops for every (query, key) pair the mask
            # keeps (causal: key <= query), in the bf16 tensor cores.
            pairs = bq * h * (sq * (sq + 1) // 2 if causal else sq * sk)
            nbytes = el * (2 * bq * h * sq * d + 2 * bq * kv * sk * d) + 4 * bq * h * sq
            bms, by = bound(nbytes, 4.0 * d * pairs, PEAK_BF16_S)
            qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
            out = {
                "max_abs_err": err, "ms": cuda_ms(run),
                "plain_ms": cuda_ms(lambda q=q, k=k, v=v: flash_attention.flash_attention_plain(
                    q, k, v, True), reps=5),
                "bound_ms": bms, "bound_by": by,
                "library_ms": cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                    qc, kc, vc, is_causal=True, enable_gqa=True)),
            }
            shapes[tag].update(out, bytes=nbytes, flops=4.0 * d * pairs)
    report["flash_attention_shapes"] = shapes
    out["max_abs_err"] = max(v["max_abs_err"] for v in shapes.values())
    return out


def to_f32(tree: dict) -> dict:
    return {k: to_f32(v) if isinstance(v, dict) else v.float() for k, v in tree.items()}


def count_params(tree: dict) -> int:
    return sum(count_params(v) if isinstance(v, dict) else v.numel() for v in tree.values())


def lm_requests(cfg, rng) -> list:
    """LM_SLOTS seeded requests for each prompt length of LM_PROMPTS."""
    return [Request(uid=i * LM_SLOTS + j,
                    prompt=rng.integers(0, cfg.vocab_size, plen).astype(np.int32),
                    max_new_tokens=LM_NEW)
            for i, plen in enumerate(LM_PROMPTS) for j in range(LM_SLOTS)]


def serve_lm(engine, requests) -> tuple:
    """One wave a ``run`` call (LM_SLOTS same-length requests fill the
    slots); returns (completions, flash launches of each wave)."""
    outs, per_wave = [], []
    for i in range(0, len(requests), LM_SLOTS):
        before = flash_attention.launches
        outs += engine.run(requests[i:i + LM_SLOTS])
        per_wave.append(flash_attention.launches - before)
    return outs, per_wave


def profile_lm(engine, requests, steps: int = 8) -> dict:
    """Where a wave's device time goes: ``torch.profiler`` over one prefill
    of the longest prompts and ``steps`` decode steps, by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    cfg, dev = engine.cfg, engine.device
    batch = {"tokens": torch.as_tensor(np.stack([r.prompt for r in requests[:LM_SLOTS]]),
                                       device=dev)}
    prefill_step = make_prefill_step(cfg, LM_MAX_LEN)
    decode = make_decode_step(cfg)
    res = {}
    for phase in ("prefill", "decode"):
        tok, _, cache = prefill_step(engine.params, batch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if phase == "prefill":
                tok, _, cache = prefill_step(engine.params, batch)
            else:
                for _ in range(steps):
                    tok, cache = decode(engine.params, tok[:, None], cache)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
        n = 1 if phase == "prefill" else steps
        rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        rows.sort(key=lambda r: -r[1])
        dev_ms = sum(r[1] for r in rows) / n
        res[phase] = {"calls": n, "device_ms": dev_ms, "wall_ms_profiled": wall / n,
                      "device_busy_share": dev_ms / (wall / n),
                      "top": [{"name": k[:80], "device_ms": ms / n, "calls": c}
                              for k, ms, c in rows[:12]]}
    return res


def drive_lm(dev: torch.device, report: dict) -> dict:
    """The LM zoo's serving path; returns its kernel's ``kernels`` entry."""
    kstats = check_flash(dev, report)
    print("flash_attention check: " + json.dumps(
        {k: v["max_abs_err"] for k, v in report["flash_attention_shapes"].items()}), flush=True)
    cfg = dataclasses.replace(lm_configs.get(LM_ARCH), attn_impl="flash")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_params(cfg, gen, device=dev)
    n_params = count_params(params)
    # ModelConfig.param_count counts the weight matrices, not the norm scales.
    if n_params != cfg.param_count() + (2 * cfg.n_layers + 1) * cfg.d_model:
        raise AssertionError(f"{n_params} parameters, the config counts {cfg.param_count()}")
    engine = ServingEngine(cfg, params, slots=LM_SLOTS, max_len=LM_MAX_LEN, device=dev)
    requests = lm_requests(cfg, np.random.default_rng(SEED))

    # The main path: two waves, twice; only these launches are counted.
    for mod, _, _ in list(KERNELS.values()) + list(LM_KERNELS.values()):
        mod.launches = 0
    torch.cuda.reset_peak_memory_stats()
    runs = [serve_lm(engine, requests) for _ in range(2)]
    torch.cuda.synchronize()
    counts = {name: mod.launches for name, (mod, _, _) in LM_KERNELS.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    for outs, per_wave in runs:
        if per_wave != [cfg.n_layers] * len(LM_PROMPTS):
            raise AssertionError(f"flash launches per wave {per_wave}, expected "
                                 f"{cfg.n_layers} (one a layer)")
        if [c.uid for c in outs] != [r.uid for r in requests]:
            raise AssertionError("not every LM request was answered")
        for c in outs:
            if c.tokens.shape != (LM_NEW,):
                raise AssertionError(f"request {c.uid}: {c.tokens.shape[0]} tokens")
            if not ((c.tokens >= 0) & (c.tokens < cfg.vocab_size)).all():
                raise AssertionError(f"request {c.uid}: a token id outside the vocab")
    for a, b in zip(*(outs for outs, _ in runs)):
        if not np.array_equal(a.tokens, b.tokens):
            raise AssertionError(f"request {a.uid}: the second run served other tokens")

    # Flash against chunked on the 2048-token wave: last-position prefill
    # logits, same weights. Tolerance: twice what bf16 costs the chunked
    # path itself, measured against the chunked path in f32 (the same
    # weights upcast; no TF32): if the flash path is as accurate, the two
    # bf16 paths differ by at most that.
    batch = {"tokens": torch.as_tensor(np.stack([r.prompt for r in requests[:LM_SLOTS]]),
                                       device=dev)}
    flash_step = make_prefill_step(cfg, LM_MAX_LEN)
    tok_f, lf, _ = flash_step(params, batch)
    _, lf2, _ = flash_step(params, batch)
    chunked = dataclasses.replace(cfg, attn_impl="chunked")
    tok_c, lc, _ = make_prefill_step(chunked, LM_MAX_LEN)(params, batch)
    params32 = to_f32(params)
    _, lr, _ = make_prefill_step(dataclasses.replace(chunked, dtype="float32"), LM_MAX_LEN)(
        params32, batch)
    del params32
    vocab = slice(0, cfg.vocab_size)
    lf, lf2, lc, lr = (x[:, vocab].float() for x in (lf, lf2, lc, lr))
    if not all(torch.isfinite(x).all() for x in (lf, lc, lr)):
        raise AssertionError("non-finite prefill logits")
    err_c, err_f = float((lc - lr).abs().max()), float((lf - lr).abs().max())
    tol = 2 * err_c
    diff = float((lf - lc).abs().max())
    if diff > tol:
        raise AssertionError(f"flash vs chunked prefill logits: max |diff| {diff} > {tol}")
    top2 = lf.topk(2, dim=-1).values
    decisive = (top2[:, 0] - top2[:, 1]) > tol
    if not torch.equal(tok_f[decisive], tok_c[decisive]):
        raise AssertionError("flash and chunked pick other first tokens where the top-2 "
                             "margin exceeds the tolerance")
    scale = float(lr.abs().max())
    prefill_ms = [1e3 * outs[i * LM_SLOTS].prefill_s for outs, _ in runs
                  for i in range(len(LM_PROMPTS))]
    decode_ms_tok = [1e3 * outs[i * LM_SLOTS].decode_s / (LM_NEW - 1) for outs, _ in runs
                     for i in range(len(LM_PROMPTS))]
    tok_s = [LM_SLOTS * LM_NEW / (outs[i * LM_SLOTS].prefill_s + outs[i * LM_SLOTS].decode_s)
             for outs, _ in runs for i in range(len(LM_PROMPTS))]
    lm = {
        "config": {"arch": LM_ARCH, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
                   "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
                   "head_dim": cfg.head_dim, "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
                   "dtype": cfg.dtype, "attn_impl": cfg.attn_impl, "params": n_params},
        "waves": [f"{LM_SLOTS} x {p}" for p in LM_PROMPTS], "new_tokens": LM_NEW,
        "prefill_ms_per_wave": prefill_ms, "decode_ms_per_token": decode_ms_tok,
        "tokens_per_s_per_wave": tok_s, "peak_mem_gb": peak_gb, "launches": counts,
        "flash_launches_per_wave": [w for _, pw in runs for w in pw],
        "flash_vs_chunked": {"max_abs_diff": diff, "tolerance": tol, "logit_scale": scale,
                             "chunked_vs_f32": err_c, "flash_vs_f32": err_f,
                             "decisive_rows": int(decisive.sum()),
                             "first_tokens_equal": bool(torch.equal(tok_f, tok_c))},
        "prefill_logits_bitwise_across_runs": bool(torch.equal(lf, lf2)),
        "tokens_equal_across_runs": True,
    }
    lm["profile"] = profile_lm(engine, requests)
    report["lm_serving"] = lm
    card = report.get("nvidia_smi", "card not queried")
    for i, p in enumerate(LM_PROMPTS):
        print(f"serve {LM_ARCH} ({cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.dtype}, "
              f"{cfg.attn_impl}) wave {LM_SLOTS} x {p}: prefill "
              + " / ".join(f"{prefill_ms[r * len(LM_PROMPTS) + i]:.1f}" for r in range(2))
              + " ms, decode " + " / ".join(
                  f"{decode_ms_tok[r * len(LM_PROMPTS) + i]:.2f}" for r in range(2))
              + " ms a token, " + " / ".join(
                  f"{tok_s[r * len(LM_PROMPTS) + i]:.1f}" for r in range(2))
              + f" generated tokens/s (two runs) [{card}]", flush=True)
    print(f"serve {LM_ARCH}: tokens equal across two runs; prefill logits bitwise equal "
          f"across runs: {lm['prefill_logits_bitwise_across_runs']}; flash vs chunked max "
          f"|diff| {diff:.4g} (tolerance {tol:.4g}; against f32: chunked {err_c:.4g}, flash "
          f"{err_f:.4g}; logit scale {scale:.4g}); peak device "
          f"memory {peak_gb:.2f} GB [{card}]", flush=True)
    for phase, prof in lm["profile"].items():
        print(f"profile ({LM_ARCH} {phase}): device {prof['device_ms']:.2f} ms a "
              f"{'wave' if phase == 'prefill' else 'step'}, busy "
              f"{100 * prof['device_busy_share']:.0f}% [{card}]", flush=True)

    name, (_, source, replaces) = next(iter(LM_KERNELS.items()))
    if counts[name] <= 0:
        raise AssertionError(f"{name}: no launch on the LM serving path")
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts[name], **kstats}


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    # f32 products in full f32 (the smoke's f32 reference), never TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report: dict = {"nvidia_smi": smi, "torch": torch.__version__,
                    "cuda": torch.version.cuda,
                    "l2_bytes": torch.cuda.get_device_properties(0).L2_cache_size}

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
    line.append(drive_lm(torch.device("cuda"), report))
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
