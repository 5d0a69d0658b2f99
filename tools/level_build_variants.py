"""Time the fused level under launch plans around the one it picks, and
cut-out builds of its kernel that run only some of its phases.

    python3 tools/level_build_variants.py [--plans]
    python3 tools/level_build_variants.py --source NAME [NAME ...]

Builds this checkout's kernels and walks one tree's levels as
``hist_compare.py --kernels level_build`` does (``hist_compare.level_walk``:
realsim and multiclass levels 0-5 on the staged learner's nodes).

``--plans`` (the default) times the plan ``hist_plan.plan`` picks and the
plans around it (the feature tile; the warps a block and the blocks a row
under the picked tile): the fused level at every level, each plan's output
held bitwise to the staged level under the same plan, and the staged
histogram at the multiclass levels. Prints one line a level, fastest plan
first, and writes ``chiprun_out/level_build_variants.json``.

``--source`` builds each named variant (``SOURCES``) of
``csrc/level_build.cu`` (the kernel, or its shared code in
``csrc/level_common.cuh``, changed) into ``build/level_build_variants/<NAME>/`` (one ``nvcc`` each,
all at once) and times it beside the built kernel at every level, so the
phases that share the one launch can be timed apart: ``list`` runs phase 0
alone (the row-sorted list and its barriers), ``a_only`` phases 0 and 1
without the decide step, ``ab`` phases 0 and 1 with it (no last barrier,
no route), ``no_route`` all but the route loop (the last barrier kept),
``no_scan`` all but the decide step's scans, ``no_sibling`` all but its
sibling tiles (the scans read the built tile twice), ``rows4`` / ``rows8``
four or eight rows a warp scan instead of two (at B <= 64, the shapes
timed here), ``no_div`` the gains with
their divisions made products (the division's cost); ``empty`` returns at
once and ``sync1`` / ``sync3`` after one or three grid barriers (the
launch's and the barriers' own cost). The cut-outs'
outputs are wrong by construction and not checked; ``built`` is
held bitwise to the staged level. Writes
``chiprun_out/level_build_sources.json``. Each time is a CUDA-event mean
of 20 calls and the device time of another 20 by ``torch.profiler``.
Needs one GPU and ``nvcc``.
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

OUT = ROOT / "build" / "level_build_variants"
CSRC = ROOT / "src" / "repro_torch" / "csrc"
_PLACE = "place_row(a, r, w, s32);\n  grid.sync();\n"
_DECIDE = ("    if (build_tile<true>(a, t, r, k, tiles, w, smem, M, s_mask))\n"
           "      decide_tile(a, t, r, tiles, w, M, smem, s_mask);\n")
_LAST = "  grid.sync();\n  route(a, tiles, w, reinterpret_cast<int*>(smem));\n"
_ROUTE = "  route(a, tiles, w, reinterpret_cast<int*>(smem));\n"
_START = "  const Work w = work_of(a, true);\n\n  if (a.splits > 1) {"
# name -> substitutions in level_build.cu or level_common.cuh: one cut each.
SOURCES = {
    "built": [],
    "list": [(_PLACE, _PLACE + "  return;\n")],
    "a_only": [(_DECIDE, "    build_tile<true>(a, t, r, k, tiles, w, smem, M, s_mask);\n"),
               (_LAST, "")],
    "ab": [(_LAST, "")],
    "no_route": [(_ROUTE, "")],
    "empty": [(_START, "  const Work w = work_of(a, true);\n  return;\n  if (a.splits > 1) {")],
    "sync1": [(_START, "  const Work w = work_of(a, true);\n  grid.sync();\n  return;\n"
                       "  if (a.splits > 1) {")],
    "sync3": [(_START, "  const Work w = work_of(a, true);\n  grid.sync();\n  grid.sync();\n"
                       "  grid.sync();\n  return;\n  if (a.splits > 1) {")],
    "no_scan": [("  for (int i = warp; i * per_scan < nf; i += warps) {",
                 "  for (int i = warp; i < 0; i += warps) {")],
    "no_sibling": [("  if (a.derive) {\n    const float* pg", "  if (false) {\n    const float* pg")],
    "rows4": [("scan_tile<2, kMaxPer>(", "scan_tile<4, 2>(")],  # B <= 64 only
    "rows8": [("scan_tile<2, kMaxPer>(", "scan_tile<8, 2>(")],  # B <= 64 only
    "no_div": [("const float q = __uint_as_float(bits) / d;",
                "const float q = __uint_as_float(bits) * d;")],
}


def build(name: str) -> subprocess.Popen:
    """nvcc of variant ``name`` into ``OUT/name/lib.so``."""
    from repro_torch.kernels import _build

    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    texts = {p.name: p.read_text() for p in CSRC.glob("*.cu*")}
    for old, new in SOURCES[name]:
        where = [f for f in ("level_build.cu", "level_common.cuh") if old in texts[f]]
        assert len(where) == 1, (name, old)
        texts[where[0]] = texts[where[0]].replace(old, new)
    for fname, text in texts.items():
        (d / fname).write_text(text)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / "level_build.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def level_cases(cs, hist_compare, dev) -> list:
    """(tag, fused-level args or None, staged-histogram args or None, learner
    config, feature mask) at each level of the walk: the fused level at
    realsim levels 0-5 and multiclass levels 0-5, the staged histogram at
    the multiclass levels and realsim levels 6-8."""
    from repro_torch.trees.learner import _smaller_children

    out = []
    for which, level, bins, g, h, node, mask, parent, lc in hist_compare.level_walk(cs, dev, 9):
        n_nodes = 1 << level
        act = None if level == 0 else _smaller_children(node, h, n_nodes)
        active = act if level else torch.zeros(1, dtype=torch.int32, device=dev)
        args = (bins, node, g, h, active, parent, mask.to(torch.int32), lc.lam,
                lc.min_child_hess, n_nodes, lc.n_bins, level > 0)
        hist_args = ((bins, node, g, h, n_nodes, lc.n_bins, act)
                     if which == "multiclass" or level >= 6 else None)
        out.append((f"{which} level{level}", args if level < 6 else None, hist_args, lc, mask))
    return out


def plans_around(p, n: int, n_feat: int, n_bins: int, rows: int) -> list:
    """The picked plan first, then each feature tile under the picked warps
    (1, 2, 4 or 8 blocks a row), half and twice the samples a chunk, then
    every (warps, splits) under the picked tile that fits."""
    from repro_torch.kernels import hist_plan as hp

    out, seen = [p], {p}

    def add(tile, warps, splits, per_column=p.min_per_column):
        smem = warps * hp.warp_bytes(n_bins) + hp.tile_bytes(tile, n_bins)
        if smem > hp.SMEM_LIMIT:
            return
        q = hp.HistPlan(tile, warps, splits, (-(-n_feat // tile), rows, splits), smem,
                        per_column)
        if q not in seen:
            seen.add(q)
            out.append(q)
    for tile in hp.FEAT_TILES:
        for splits in (1, 2, 4, 8):
            add(tile, p.warps, splits)
    for per_column in (p.min_per_column // 2, 2 * p.min_per_column):
        add(p.feat_tile, p.warps, p.splits, per_column)
        add(p.feat_tile, p.warps, 2 * p.splits, per_column)
    for warps in (1, 2, 4, 6, 8):
        for splits in (1, 2, 4, 8, 16, 32):
            add(p.feat_tile, warps, splits)
    return out


def with_plan(q, fn):
    """``fn`` run under launch plan ``q`` (both wrappers' ``launch_plan``
    patched for the call, so a timing taken later still runs ``q``)."""
    from repro_torch.kernels import histogram, level_build

    def run():
        saved = level_build.launch_plan, histogram.launch_plan
        level_build.launch_plan = histogram.launch_plan = lambda *_: q
        try:
            return fn()
        finally:
            level_build.launch_plan, histogram.launch_plan = saved
    return run


def staged_ok(args, lc, mask, got) -> None:
    """Require the fused level ``got`` to be bitwise the staged level."""
    from repro_torch.trees.learner import _staged_level

    bins, node, g, h, _, parent = args[:6]
    level = args[9].bit_length() - 1
    staged = _staged_level(lc, bins, node, g, h, mask, level, parent)
    for name, a, b in zip(("hist", "feat", "thr", "new_node"), (got[0], got[1], got[2], got[4]),
                          staged):
        if not torch.equal(a, b):
            raise AssertionError(f"level {level}: fused {name} differs from the staged level")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--plans", action="store_true", help="the default")
    ap.add_argument("--source", nargs="*", choices=list(SOURCES), default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("level_build_variants: no CUDA device")
    import chip_smoke as cs
    import hist_compare
    from repro_torch.kernels import _build, hist_plan, histogram, level_build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    _build.build_all()
    dev = torch.device("cuda")
    report: dict = {"nvidia_smi": smi, "shapes": {}}
    cases = level_cases(cs, hist_compare, dev)
    if args.source:
        procs = {n: build(n) for n in args.source}
        for n, proc in procs.items():
            log, _ = proc.communicate()
            if proc.returncode:
                sys.exit(f"{n}: nvcc failed\n{log}")
            report.setdefault("ptxas", {})[n] = [ln for ln in log.splitlines()
                                                 if "Used" in ln or "spill" in ln]
        for n in args.source:
            _build._LIBS["level_build"] = ctypes.CDLL(str(OUT / n / "lib.so"))
            _build._FUNCTIONS.clear()
            for tag, a, _, lc, mask in cases:
                if a is None:
                    continue
                if n == "built":
                    staged_ok(a, lc, mask, level_build.level_build(*a))
                report["shapes"].setdefault(tag, []).append(
                    {"source": n, "times": cs.event_times(lambda a=a: level_build.level_build(*a))})
            cs.fill_device_times()  # before the library changes
        for tag, rows in report["shapes"].items():
            for r in rows:
                t = r.pop("times")
                r.update(ms=t["ms"], device_ms=t["device_ms"])
            print(f"{tag} [{smi}]: " + "; ".join(
                f"{r['source']} {r['device_ms']:.4f}" for r in rows), flush=True)
        name = "level_build_sources.json"
    else:
        for tag, a, hist_args, lc, mask in cases:
            bins, rows = (a or hist_args)[0], hist_args[4] if a is None else a[4].shape[0]
            if a is None and hist_args[6] is not None:
                rows = hist_args[6].shape[0]
            p = hist_plan.plan(bins.shape[0], bins.shape[1], lc.n_bins, rows)
            timed = []
            for q in plans_around(p, bins.shape[0], bins.shape[1], lc.n_bins, rows):
                row = {"plan": q}
                if a is not None:
                    fused = with_plan(q, lambda a=a: level_build.level_build(*a))
                    with_plan(q, lambda a=a, fused=fused: staged_ok(a, lc, mask, fused()))()
                    row["fused"] = cs.event_times(fused)
                if hist_args is not None:
                    row["staged"] = cs.event_times(
                        with_plan(q, lambda h=hist_args: histogram.histogram(*h)))
                timed.append(row)
            report["shapes"][tag] = timed
        cs.fill_device_times()
        for tag, timed in report["shapes"].items():
            rows = [{**r["plan"]._asdict(), "picked": i == 0,
                     **({"fused_device_ms": r["fused"]["device_ms"], "fused_ms": r["fused"]["ms"]}
                        if "fused" in r else {}),
                     **({"histogram_device_ms": r["staged"]["device_ms"]}
                        if "staged" in r else {})} for i, r in enumerate(timed)]
            report["shapes"][tag] = rows
            key = "fused_device_ms" if "fused_device_ms" in rows[0] else "histogram_device_ms"
            best = sorted(rows, key=lambda r: r[key])
            print(f"{tag} [{smi}]: " + "; ".join(
                f"{'*' if r['picked'] else ''}t{r['feat_tile']} w{r['warps']} s{r['splits']} "
                f"m{r['min_per_column']} "
                + " / ".join(f"{r[k]:.4f}" for k in ("fused_device_ms", "histogram_device_ms")
                             if k in r)
                for r in best[:10]), flush=True)
        name = "level_build_variants.json"
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / name).write_text(json.dumps(report, indent=1, default=str))


if __name__ == "__main__":
    main()
