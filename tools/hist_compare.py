"""Time the kernels of one checkout of the PyTorch/CUDA port.

    python3 tools/hist_compare.py --src SRC_DIR --tag NAME \
        [--kernels histogram|level_build|split_gain|traversal|flash|flash_bwd]

Imports ``repro_torch`` from ``SRC_DIR`` (this repository's ``src``, or the
``src`` of another commit unpacked with ``git archive``) and the
``chip_smoke.py`` beside it, builds its kernels into that checkout's
``build/``, and runs that ``chip_smoke.py``'s measurements at
efficiency-realsim width, each against its plain version:

- ``histogram`` (the default): the dense histogram (level 0 and the
  level-8 subset), the fused level (level 0 and the deepest fused level),
  the sparse histogram (both shapes) and the nine-level sweep;
- ``level_build``: one tree's levels on the staged learner's nodes
  (subtract mode, round 0's gradients and draws): the fused level at
  realsim levels 0-5 (levels 0-4 fuse on the main path; level 5 is timed
  beside them) and at multiclass levels 0-5 (N 4000, F 60), each bitwise
  against the staged level and within tolerance of its plain version, and
  the staged histogram at multiclass levels 0-5 beside ``index_add_``;
  each call's kernel launches by the profiler's count;
- ``split_gain``: the staged level (``learner._staged_level``, the same
  signature in every commit: its histogram, split gain and decision,
  partition) at realsim levels 0-8 and multiclass levels 0-5 of
  ``level_walk``, with its device time by kernel name and its launches a
  call; and the split gain alone at the smoke's L = 256 (level-8 nodes,
  F 1500, B 64): the surface, and the decision as the commit's staged level
  takes it (``split_gain_decide`` where the commit has it, else the
  surface followed by ``masked_fill``, ``argmax`` and ``gather``);
- ``traversal``: every traversal form, bitwise against its plain version,
  through the entry point every commit has: f32, int8 and fp16 with one
  output on the realsim-like bins (4000 x 1500, 64 bins) and a seeded full
  400-slot forest of depth 9, and K = 5 in each on the multiclass bins
  (4000 x 60) and a seeded full 2000-slot forest of depth 6, each at its
  4000 rows and at the serving wave's 256;
- ``flash``: the flash-attention forward at granite-3-2b's prefill shape
  (4 x 2048, 32 q and 8 kv heads, d 64, bf16, causal, the model's (B, S,
  H, d) layout) through ``flash_attention.flash_attention``, the entry
  point every commit has, against its plain version and beside SDPA on
  the same inputs made contiguous;
- ``flash_bwd``: the flash-attention backward at granite-3-2b's training
  shape (4 x 2048, and the step's 2 x 2048 microbatch; 32 q and 8 kv heads,
  d 64, bf16, causal, the model layout) through
  ``flash_attention.flash_attention_bwd``, the entry point every commit
  has, held to the smoke test's ``bwd_close`` against its plain version,
  beside the backward alone of SDPA on the same inputs made contiguous; the
  device time is also split by kernel name.

Each time is a CUDA-event mean of 20 back-to-back calls and the device time
alone of another 20 by ``torch.profiler``. Writes
``chiprun_out/hist_compare_<NAME>.json`` and prints one summary line. To
compare two commits on one card, run it in turns in one session: parent,
change, change, parent. Needs one GPU.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]


# The traversal's shapes: each forest at its main path's rows and at the
# serving wave's 256 rows (``ForestServer(max_rows=256)`` pads every wave
# to 256 rows), all slots live.
TRAVERSAL_ROWS = (None, 256)


def traversal_forests(cs, dev) -> dict:
    """The realsim-like bins (4000 x 1500, 64 bins) with a seeded full
    400-slot depth-9 forest and the multiclass bins (4000 x 60, 64 bins)
    with a seeded full 2000-slot depth-6 K-5 forest, as ``chip_smoke.py``
    seeds them."""
    from repro_torch.data import synthetic
    from repro_torch.trees.binning import bin_dataset

    x, y, mult = synthetic.raw(synthetic.PAPER_DATASETS["realsim-like"])
    realsim = bin_dataset(x, y, n_bins=64, multiplicity=mult, device=dev).bins
    xm, ym = synthetic.multiclass_xy(*cs.MC_SHAPE, seed=0)
    multi = bin_dataset(xm, ym, n_bins=64, device=dev).bins
    rng = np.random.default_rng(0)
    return {"realsim": (realsim, cs.seeded_forest(rng, realsim.shape[1], 0.0, dev)),
            "multiclass": (multi, cs.seeded_multiclass_forest(rng, dev))}


def traversal(cs, report: dict) -> None:
    """Every traversal form (f32, int8, fp16; one output on the realsim
    forest, K = 5 on the multiclass one) at its main path's rows and at the
    256-row serving wave, bitwise against its plain version, through the
    entry point every commit has."""
    import torch

    from repro_torch.kernels import forest_traversal

    shapes = report["forest_traverse_shapes"] = {}
    for which, (bins, f32) in traversal_forests(cs, torch.device("cuda")).items():
        for mode in (None, "int8", "fp16"):
            fo = f32.quantize(mode) if mode else f32
            slots = fo.feature.shape[0]
            args = (fo.feature, fo.threshold, fo.leaf_value, fo.n_trees, fo.depth,
                    fo.n_outputs, getattr(fo, "leaf_scale", None))
            form = ("k5_" if fo.n_outputs > 1 else "") + (mode or "f32")
            for rows in TRAVERSAL_ROWS:
                b = bins[:rows].contiguous()
                got = forest_traversal.forest_traverse(b, *args)
                if not torch.equal(got, forest_traversal.forest_traverse_plain(b, *args)):
                    raise AssertionError(f"forest_traverse {form} {b.shape[0]} rows: differs "
                                         "from the plain version")
                tag = f"{form} {b.shape[0]}x{slots}"
                shapes[tag] = cs.event_times(
                    lambda b=b, args=args: forest_traversal.forest_traverse(b, *args))
                shapes[tag]["bound_ms"] = cs.traversal_bound(b, fo, slots)[0]
    cs.fill_device_times()


def level_walk(cs, dev, realsim_levels: int = 6):
    """The levels ``--kernels level_build`` times, one tree each on the
    staged learner's nodes (subtract mode): yields (config, level, bins, g,
    h, node, feature mask, parent cache, learner config) at realsim levels
    0 .. realsim_levels - 1 (round 0's gradients under R = 0.8,
    ``kernel_inputs``) and multiclass levels 0-5 (class 0's round-0
    gradient under a seeded Bernoulli draw)."""
    import torch

    from repro_torch.data import synthetic
    from repro_torch.trees.binning import bin_dataset
    from repro_torch.trees.learner import _staged_level

    x, y, mult = synthetic.raw(synthetic.PAPER_DATASETS["realsim-like"])
    realsim = bin_dataset(x, y, n_bins=64, multiplicity=mult, device=dev)
    g, h, _, _, gen = cs.kernel_inputs(realsim)
    xm, ym = synthetic.multiclass_xy(*cs.MC_SHAPE, seed=0)
    multi = bin_dataset(xm, ym, n_bins=64, device=dev)
    g0, _ = cs.MC_CFG.obj.grad_hess(multi.labels, cs.init_state(cs.MC_CFG, multi).f)
    m = torch.binomial(torch.ones(multi.n_samples, device=dev),
                       torch.full((multi.n_samples,), 0.8, device=dev), generator=gen) / 0.8
    gm, hm = (m * g0[:, 0]).contiguous(), m.contiguous()
    for which, data, g, h, lc in (("realsim", realsim, g, h, cs.CFG.learner),
                                  ("multiclass", multi, gm, hm, cs.MC_CFG.learner)):
        mask = torch.rand(data.n_features, generator=gen, device=dev) < lc.feature_fraction
        node = torch.zeros(data.n_samples, dtype=torch.int32, device=dev)
        parent = None
        for level in range(realsim_levels if which == "realsim" else 6):
            yield which, level, data.bins, g, h, node, mask, parent, lc
            parent, _, _, node = _staged_level(lc, data.bins, node, g, h, mask, level, parent)


def launches_a_call(fn) -> float:
    """Kernel launches one call of ``fn`` makes, by the profiler's count
    (the mean over five calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 5


def level_build(cs, report: dict, dev=None) -> None:
    """The fused level at realsim and multiclass levels 0-5 and the staged
    histogram at multiclass levels 0-5 (``level_walk``), each through the
    entry point every commit has and the checks of that commit's
    ``chip_smoke.py`` (``level_build_case``, ``histogram_case``)."""
    import torch

    from repro_torch.kernels import histogram
    from repro_torch.kernels import level_build as lb
    from repro_torch.trees.learner import _smaller_children

    dev = dev or torch.device("cuda")
    fused = report["level_build_shapes"] = {}
    staged = report["histogram_shapes"] = {}
    calls = {}
    for which, level, bins, g, h, node, mask, parent, lc in level_walk(cs, dev):
        tag = f"{which} level{level}"
        fused[tag] = cs.level_build_case(lc, bins, node, g, h, mask, level, parent, tag, report)
        n_nodes = 1 << level
        act = None if level == 0 else _smaller_children(node, h, n_nodes)
        active = (act if level else torch.zeros(1, dtype=torch.int32, device=dev))
        args = (bins, node, g, h, active, parent, mask.to(torch.int32), lc.lam,
                lc.min_child_hess, n_nodes, lc.n_bins, level > 0)
        calls[f"level_build {tag}"] = lambda args=args: lb.level_build(*args)
        if which == "multiclass":
            staged[tag] = cs.histogram_case(bins, g, h, node, n_nodes, act, lc.n_bins, tag,
                                            report)
            calls[f"histogram {tag}"] = lambda a=(bins, node, g, h, n_nodes, lc.n_bins, act): \
                histogram.histogram(*a)
    cs.fill_device_times()
    report["launches_a_call"] = {k: launches_a_call(fn) for k, fn in calls.items()}
    for kern, shapes in (("level_build", fused), ("histogram", staged)):
        for tag, st in shapes.items():
            st["launches"] = report["launches_a_call"][f"{kern} {tag}"]


def split_gain(cs, report: dict, dev=None) -> None:
    """The staged level at realsim levels 0-8 and multiclass levels 0-5,
    and the split gain with its decision alone at L = 256, each as this
    commit runs it."""
    import torch

    from repro_torch.data import synthetic
    from repro_torch.kernels import histogram, split_scan
    from repro_torch.trees.binning import bin_dataset
    from repro_torch.trees.learner import _staged_level

    dev = dev or torch.device("cuda")
    decide = hasattr(split_scan, "split_gain_decide")
    shapes = report["split_gain_shapes"] = {}
    calls = {}
    for which, level, bins, g, h, node, mask, parent, lc in level_walk(cs, dev, 9):
        # The mask in the form the commit's build_tree hands the level.
        args = (lc, bins, node, g, h, mask.to(torch.int32) if decide else mask, level, parent)
        tag = f"staged_level {which} level{level}"
        calls[tag] = lambda args=args: _staged_level(*args)
        shapes[tag] = cs.event_times(calls[tag])
    x, y, mult = synthetic.raw(synthetic.PAPER_DATASETS["realsim-like"])
    data = bin_dataset(x, y, n_bins=64, multiplicity=mult, device=dev)
    g, h, node8, _, _ = cs.kernel_inputs(data)
    lc = cs.CFG.learner
    hist = histogram.histogram(data.bins, node8, g, h, 256, lc.n_bins)
    mgen = torch.Generator(device=dev)
    mgen.manual_seed(cs.SEED + 1)
    mask = torch.rand(data.n_features, generator=mgen, device=dev) < lc.feature_fraction
    mask_i32 = mask.to(torch.int32)

    def chain():
        gain = split_scan.split_gain(hist, lc.lam, lc.min_child_hess)
        flat = gain.masked_fill(~mask[None, :, None], float("-inf")).reshape(256, -1)
        idx = torch.argmax(flat, dim=-1)
        return gain, flat.gather(1, idx[:, None])[:, 0], idx

    def decision():
        return split_scan.split_gain_decide(hist, lc.lam, lc.min_child_hess, mask_i32)
    run = decision if decide else chain
    got, want = run(), chain()
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("split gain L=256: the decision differs from the chain")
    calls["decision L=256"] = run
    calls["surface L=256"] = lambda: split_scan.split_gain(hist, lc.lam, lc.min_child_hess)
    bms, _ = cs.bound(4 * 3 * hist[0].numel() + 4 * data.n_features + 12 * 256,
                      12 * hist[0].numel())
    for tag in ("decision L=256", "surface L=256"):
        shapes[tag] = cs.event_times(calls[tag])
        shapes[tag]["bound_ms"] = bms
    cs.fill_device_times()
    for tag, fn in calls.items():
        shapes[tag]["launches"] = launches_a_call(fn)


def flash(cs, report: dict) -> None:
    """The flash forward at the prefill shape, beside SDPA."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    b, s, h, kv = 4, 2048, 32, 8
    g = torch.Generator(device="cpu").manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g).to(dev, torch.bfloat16).transpose(1, 2)
               for shape in ((b, s, h, 64), (b, s, kv, 64), (b, s, kv, 64)))
    want = fa.flash_attention_plain(q, k, v, True)[0]
    cs.close("flash_attention prefill", fa.flash_attention(q, k, v, True)[0].float(),
             want.float(), 2e-2, 2e-2)
    del want
    shapes = report["flash_attention_shapes"] = {}
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    pairs = b * h * s * (s + 1) // 2
    bms, by = cs.bound(2 * (2 * b * h * s * 64 + 2 * b * kv * s * 64) + 4 * b * h * s,
                       4.0 * 64 * pairs, cs.PEAK_BF16_S)
    shapes["prefill"] = cs.event_times(lambda: fa.flash_attention(q, k, v, True))
    shapes["prefill"].update(bound_ms=bms, bound_by=by)
    cs.event_times(lambda: torch.nn.functional.scaled_dot_product_attention(
        qc, kc, vc, is_causal=True, enable_gqa=True), into=shapes["prefill"], key="library_")
    cs.fill_device_times()


def flash_bwd(cs, report: dict) -> None:
    """The flash backward at the training shape and its microbatch, beside
    SDPA's backward."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    s, h, kv, d = 2048, 32, 8, 64
    g = torch.Generator(device="cpu").manual_seed(0)
    shapes = report["flash_attention_bwd_shapes"] = {}
    for b in (4, 2):
        q, k, v, do = (torch.randn(shape, generator=g).to(dev, torch.bfloat16).transpose(1, 2)
                       for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d), (b, s, h, d)))
        out, lse = fa.flash_attention(q, k, v, True)
        args = (q, k, v, out, lse, do, True, None)
        tag = f"{b}x{s}"
        errs = cs.bwd_close(tag, fa.flash_attention_bwd(*args),
                            fa.flash_attention_bwd_plain(*args),
                            fa.flash_attention_bwd_magnitudes(*args), torch.bfloat16)
        pairs = b * h * s * (s + 1) // 2
        bms, by = cs.bound(2 * (4 * b * h * s * d + 4 * b * kv * s * d) + 4 * b * h * s,
                           5 * 2.0 * d * pairs, cs.PEAK_BF16_S)
        shapes[tag] = cs.event_times(lambda args=args: fa.flash_attention_bwd(*args))
        shapes[tag].update(bound_ms=bms, bound_by=by,
                           rel_l2_err={n: e["rel_l2_err"] for n, e in errs.items()})
        qc, kc, vc = (t.detach().contiguous().requires_grad_() for t in (q, k, v))
        lib_out = torch.nn.functional.scaled_dot_product_attention(
            qc, kc, vc, is_causal=True, enable_gqa=True)
        doc = do.contiguous()
        def sdpa_bwd(lib_out=lib_out, qc=qc, kc=kc, vc=vc, doc=doc):
            return torch.autograd.grad(lib_out, (qc, kc, vc), doc, retain_graph=True)
        cs.event_times(sdpa_bwd, into=shapes[tag], key="library_")
    cs.fill_device_times()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True, help="the src directory of a checkout")
    ap.add_argument("--tag", required=True)
    ap.add_argument("--kernels", default="histogram",
                    choices=("histogram", "level_build", "split_gain", "traversal", "flash",
                             "flash_bwd"))
    args = ap.parse_args()
    src = pathlib.Path(args.src).resolve()
    # The package comes from --src and the measurements from the
    # chip_smoke.py of the same checkout, whose imports then resolve there.
    sys.path.insert(0, str(src))
    sys.path.insert(0, str(src.parent))
    import torch

    if not torch.cuda.is_available():
        sys.exit("hist_compare: no CUDA device")
    import chip_smoke as cs
    import repro_torch

    if pathlib.Path(repro_torch.__file__).resolve().parents[1] != src:
        sys.exit(f"hist_compare: repro_torch came from {repro_torch.__file__}, not {src}")
    from repro_torch.data import synthetic
    from repro_torch.trees.binning import bin_dataset

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    report: dict = {"src": str(src), "nvidia_smi": smi}
    dev = torch.device("cuda")
    if args.kernels == "histogram":
        x, y, mult = synthetic.raw(synthetic.PAPER_DATASETS["realsim-like"])
        data = bin_dataset(x, y, n_bins=64, multiplicity=mult, device=dev)
    if args.kernels == "flash":
        flash(cs, report)
        kernels = ("flash_attention",)
    elif args.kernels == "flash_bwd":
        flash_bwd(cs, report)
        kernels = ("flash_attention_bwd",)
    elif args.kernels == "traversal":
        traversal(cs, report)
        kernels = ("forest_traverse",)
    elif args.kernels == "split_gain":
        split_gain(cs, report)
        kernels = ("split_gain",)
    elif args.kernels == "level_build":
        level_build(cs, report)
        kernels = ("level_build", "histogram")
    else:
        sparse = bin_dataset(x, y, n_bins=64, multiplicity=mult, device=dev, sparse=True).bins
        g, h, node8, active, gen = cs.kernel_inputs(data)
        cs.check_histogram(data, g, h, node8, active, report)
        cs.check_level_build(data, g, h, gen, report)
        cs.check_histogram_sparse(sparse, node8, active, g, h, report)
        cs.sweep_levels(data, sparse, g, h, gen, report)
        kernels = ("histogram", "level_build", "histogram_sparse")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"hist_compare_{args.tag}.json").write_text(json.dumps(report, indent=1))
    keys = ("ms", "device_ms", "library_ms", "library_device_ms", "bound_ms", "launches")
    summary = {f"{kern} {tag}": {k: round(v[k], 5) for k in keys if v.get(k) is not None}
               for kern in kernels for tag, v in report[f"{kern}_shapes"].items()}
    print(f"{args.tag} [{smi}]: " + json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
