"""Time the forest traversal under launch plans around the one it picks,
and scratch builds of its kernel with one change each.

    python3 tools/traversal_variants.py [--forms f32 ...]
    python3 tools/traversal_variants.py --source NAME [NAME ...]

Builds this checkout's kernels and, at ``hist_compare.py``'s traversal
shapes (each form at its main path's 4000 rows and at the serving wave's
256: f32, int8 and fp16 on the seeded realsim forest, K = 5 in each on the
seeded multiclass forest), times the plan ``traversal_plan.plan`` picks
and the plans around it: every sample tile that fits, 256 or 512 threads,
the tree split halved and doubled. Every plan's output is held bitwise to
the plain version. Each time is a CUDA-event mean of 20 calls and the
device time of another 20 by ``torch.profiler``. Prints one line a shape,
fastest plan first, and writes ``chiprun_out/traversal_variants.json``.

``--source`` builds each named variant (``SOURCES``) of
``csrc/forest_traversal.cu`` into ``build/traversal_variants/<NAME>/``
(one ``nvcc`` each, all at once) and times it beside the built kernel
under the plan each picks, at the same shapes (``--forms``): ``stage16``
stages twice the nodes and leaves a thread a chunk; the cut-outs (their
outputs wrong by construction, not checked) walk no step (``cut_walk``),
stage only the first chunks (``cut_stage``), both (``cut_walk_stage``),
or take only the first chunks of a group (``cut_chunks``). Each line also
gives the walk kernel's device time. Needs one GPU and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import torch  # noqa: E402

FORMS = ("f32", "int8", "fp16", "k5_f32", "k5_int8", "k5_fp16")
OUT = ROOT / "build" / "traversal_variants"
SRC = ROOT / "src" / "repro_torch" / "csrc" / "forest_traversal.cu"
# name -> (source substitutions, plan constants): one change each.
SOURCES = {
    "built": ([], {}),
    "stage16": ([("return ahead == 2 ? 8 : 6;", "return ahead == 2 ? 16 : 12;")], {"STAGE": {1: 12, 2: 16}}),
    "cut_walk": ([("  for (int d = 0; d < depth; ++d) {\n    const uint32_t w",
                   "  for (int d = 0; d < 0; ++d) {\n    const uint32_t w")], {}),
    "cut_stage": ([("      if (next < t_end)\n        pf[a].load(", "      if (false)\n        pf[a].load(")],
                  {}),
    "cut_walk_stage": ([("  for (int d = 0; d < depth; ++d) {\n    const uint32_t w",
                         "  for (int d = 0; d < 0; ++d) {\n    const uint32_t w"),
                        ("      if (next < t_end)\n        pf[a].load(", "      if (false)\n        pf[a].load(")],
                       {}),
    "cut_chunks": ([("  for (int tc0 = t_begin; tc0 < t_end; tc0 += kAhead * chunk) {",
                     "  for (int tc0 = t_begin; tc0 < t_begin + 1; tc0 += kAhead * chunk) {")], {}),
}


def build(name: str) -> subprocess.Popen:
    """nvcc of variant ``name`` into ``OUT/name/lib.so``."""
    from repro_torch.kernels import _build

    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    text = SRC.read_text()
    for old, new in SOURCES[name][0]:
        assert old in text, (name, old)
        text = text.replace(old, new)
    (d / SRC.name).write_text(text)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / SRC.name)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def variants(n: int, n_feat: int, slots: int, depth: int, leaf_bytes: int, sms: int) -> list:
    """The picked plan first, then the same read from device memory, then
    every (sample tile, threads, groups) around it that fits."""
    from repro_torch.kernels import traversal_plan as tp

    picked = tp.plan(n, n_feat, slots, depth, leaf_bytes, sms)
    unstaged = picked._replace(row_bytes=0, ahead=1)  # rows and trees through L1
    out, seen = [picked, unstaged], {picked, unstaged}
    for s in tp.SAMPLE_TILES:
        if s > tp.SAMPLE_TILES[0] and s // 2 >= n:
            continue
        for threads in sorted({max(tp.MIN_THREADS, s), tp.MAX_THREADS}):
            one = tp.shaped(n, n_feat, slots, depth, leaf_bytes, s, threads, 1)
            if not one.chunk:
                continue
            tiles = -(-n // s)
            wave = sms * tp.blocks_per_sm(threads, one.smem_bytes(depth, leaf_bytes))
            g0 = max(1, min(wave // tiles, -(-slots // one.lanes)))
            for groups in sorted({max(1, g0 // 2), g0, 2 * g0}):
                p = tp.shaped(n, n_feat, slots, depth, leaf_bytes, s, threads, groups)
                if p not in seen:
                    seen.add(p)
                    out.append(p)
    return out


def shapes(cs, hist_compare, forms, dev):
    """(tag, form, bins, forest) at each traversal shape asked for."""
    out = []
    for which, (bins, f32) in hist_compare.traversal_forests(cs, dev).items():
        for mode in (None, "int8", "fp16"):
            fo = f32.quantize(mode) if mode else f32
            form = ("k5_" if fo.n_outputs > 1 else "") + (mode or "f32")
            if form in forms:
                for rows in hist_compare.TRAVERSAL_ROWS:
                    b = bins[:rows].contiguous()
                    out.append((f"{form} {b.shape[0]}x{fo.feature.shape[0]}", b, fo))
    return out


def walk_ms(by_kernel: dict) -> float:
    """The walk kernel's share of a traversal's device time."""
    return sum(ms for name, ms in by_kernel.items() if "walk_" in name)


def runner(p, b, fo, dev):
    """One traversal of ``b`` through forest ``fo`` under plan ``p``."""
    from repro_torch.kernels import forest_traversal

    k = fo.n_outputs
    shape = (b.shape[0],) if k == 1 else (b.shape[0], k)

    def run():
        out = torch.empty(shape, dtype=torch.float32, device=dev)
        forest_traversal.launch(p, b, fo.feature, fo.threshold, fo.leaf_value, fo.n_trees,
                                fo.depth, k, getattr(fo, "leaf_scale", None), out)
        return out
    return run


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--forms", nargs="*", default=FORMS, choices=FORMS)
    ap.add_argument("--source", nargs="*", choices=list(SOURCES), default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("traversal_variants: no CUDA device")
    import chip_smoke as cs
    import hist_compare
    from repro_torch.kernels import _build, forest_traversal
    from repro_torch.kernels import traversal_plan as tp

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    _build.build_all()
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    report: dict = {"nvidia_smi": smi, "shapes": {}}
    cases = shapes(cs, hist_compare, args.forms, dev)
    if args.source:
        procs = {n: build(n) for n in args.source}
        for n, proc in procs.items():
            log, _ = proc.communicate()
            if proc.returncode:
                sys.exit(f"{n}: nvcc failed\n{log}")
            report.setdefault("ptxas", {})[n] = [ln for ln in log.splitlines()
                                                 if "Used" in ln or "spill" in ln]
        built = {"STAGE": tp.STAGE}
        for n in args.source:
            _build._LIBS["forest_traversal"] = ctypes.CDLL(str(OUT / n / "lib.so"))
            _build._FUNCTIONS.clear()
            for k, v in {**built, **SOURCES[n][1]}.items():
                setattr(tp, k, v)
            tp.plan.cache_clear()
            for tag, b, fo in cases:
                p = tp.plan(b.shape[0], b.shape[1], fo.feature.shape[0], fo.depth,
                            fo.leaf_value.element_size(), sms)
                run = runner(p, b, fo, dev)
                if not n.startswith("cut_") and not torch.equal(
                        run(), forest_traversal.forest_traverse_plain(
                            b, fo.feature, fo.threshold, fo.leaf_value, fo.n_trees, fo.depth,
                            fo.n_outputs, getattr(fo, "leaf_scale", None))):
                    raise AssertionError(f"{n} {tag}: differs from the plain version")
                report["shapes"].setdefault(tag, []).append(
                    {"source": n, **p._asdict(), "times": cs.event_times(run)})
            cs.fill_device_times()  # before the library changes
        for rows in report["shapes"].values():
            for r in rows:
                t = r.pop("times")
                r.update(ms=t["ms"], device_ms=t["device_ms"], device_kernels=t["device_kernels"])
        for tag, rows in report["shapes"].items():
            print(f"{tag} [{smi}]: " + "; ".join(
                f"{r['source']} S{r['samples']} t{r['threads']} c{r['chunk']} "
                f"{r['device_ms']:.4f} (walk {walk_ms(r['device_kernels']):.4f})"
                for r in rows), flush=True)
    else:
        for tag, b, fo in cases:
            want = forest_traversal.forest_traverse_plain(
                b, fo.feature, fo.threshold, fo.leaf_value, fo.n_trees, fo.depth, fo.n_outputs,
                getattr(fo, "leaf_scale", None))
            timed = []
            for p in variants(b.shape[0], b.shape[1], fo.feature.shape[0], fo.depth,
                              fo.leaf_value.element_size(), sms):
                run = runner(p, b, fo, dev)
                if not torch.equal(run(), want):
                    raise AssertionError(f"{tag}, plan {p}: differs from the plain version")
                timed.append((p, cs.event_times(run)))
            report["shapes"][tag] = timed
        cs.fill_device_times()
        for tag, timed in report["shapes"].items():
            rows = [{**p._asdict(), "picked": i == 0, "ms": t["ms"], "device_ms": t["device_ms"],
                     "device_kernels": t["device_kernels"]} for i, (p, t) in enumerate(timed)]
            report["shapes"][tag] = rows
            best = sorted(rows, key=lambda r: r["device_ms"])
            print(f"{tag} [{smi}]: " + "; ".join(
                f"{'*' if r['picked'] else ''}S{r['samples']} t{r['threads']} g{r['group']} "
                f"c{r['chunk']}{'' if r['row_bytes'] else ' unstaged'} {r['device_ms']:.4f}"
                for r in best[:8]), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    name = "traversal_sources.json" if args.source else "traversal_variants.json"
    (out / name).write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
