"""Time the split-gain kernel under other plans and cut-out builds.

    python3 tools/split_gain_variants.py NAME [NAME ...]

Builds each named variant (``SOURCES``) of ``csrc/split_scan.cu`` (the
kernel, or the scan it shares in ``csrc/level_common.cuh``, changed) into
``build/split_gain_variants/<NAME>/`` (one ``nvcc`` each, all at once) and
times ``split_scan.split_gain_decide`` and ``split_scan.split_gain`` (the
surface alone) under each, in turn, on the shapes of the main path: the
smoke's L = 256 (level-8 nodes, F 1500, B 64), the whole histogram of
each of one realsim tree's nine levels and of one multiclass tree's six
(``hist_compare.level_walk``'s staged nodes). Plans: ``rows1`` /
``rows4`` one or four rows a warp scan (``built``: two), ``warps4`` /
``warps16`` warps a block (8), ``blocks4`` / ``blocks5`` registers capped
for four or five blocks an SM, ``scalar`` one float a load and a store (no
float2 / float4), ``ldg`` / ``stcs`` other cache hints on the loads and
stores, ``store_direct`` each gain stored as the scan makes it (fewer
registers, no float2 stores), ``no_zero_guard`` every quotient through
the IEEE division (``level_common::div_rn`` without its zero-dividend
path). Cut-outs (outputs wrong by construction, not checked): ``no_div``
the gains with their divisions made products (the divisions' share),
``no_shfl`` the scan without its shuffle steps, ``copy`` no scan at all
(g + h stored: the loads' and stores' own time), ``no_fold`` the
decision's per-cell compare left out (bin 0 only). Every other variant's
outputs are held bitwise to the built kernel's. Prints one line a shape
(device ms by variant, decision / surface) and each build's registers by
instance and any spill; writes ``chiprun_out/split_gain_variants.json``.
Each time is a CUDA-event mean of 20 calls and the device time of another
20 by ``torch.profiler``. Needs one GPU and ``nvcc``.
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

OUT = ROOT / "build" / "split_gain_variants"
CSRC = ROOT / "src" / "repro_torch" / "csrc"
# name -> substitutions in split_scan.cu or level_common.cuh: one change each.
SOURCES = {
    "built": [],
    "rows1": [("constexpr int kRows = 2;", "constexpr int kRows = 1;")],
    "rows4": [("constexpr int kRows = 2;", "constexpr int kRows = 4;")],
    "warps4": [("constexpr int kWarps = 8;", "constexpr int kWarps = 4;")],
    "warps16": [("constexpr int kWarps = 8;", "constexpr int kWarps = 16;")],
    "blocks5": [("__launch_bounds__(32 * kWarps) split_kernel",
                 "__launch_bounds__(32 * kWarps, 5) split_kernel")],
    "scalar": [("a.vec = (per == 1", "a.vec = false && (per == 1")],
    "ldg": [("__ldcs(", "__ldg(")],
    "stcs": [("reinterpret_cast<float2*>(p + b0)[0] = make_float2(v[0], v[1]);",
              "__stcs(reinterpret_cast<float2*>(p + b0), make_float2(v[0], v[1]));"),
             ("          reinterpret_cast<float4*>(p + b0)[j] =\n"
              "              make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);",
              "          __stcs(reinterpret_cast<float4*>(p + b0) + j,\n"
              "              make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]));")],
    "no_div": [("const float q = __uint_as_float(bits) / d;",
                "const float q = __uint_as_float(bits) * d;")],
    "no_zero_guard": [("const bool zero = n == 0.f && d == d && d != 0.f;",
                       "const bool zero = false;")],
    "no_fold": [("if (kDecide && on[q] && better(v, best[q])) {",
                 "if (kDecide && on[q] && b == 0) {")],
    "copy": [("    level_common::scan_rows<kRows, PER>(\n",
              "    for (int q = 0; q < kRows; ++q)\n      for (int k = 0; k < PER; ++k) "
              "out[q][k] = g[q][k] + h[q][k];\n"
              "    if (false) level_common::scan_rows<kRows, PER>(\n")],
    "no_shfl": [("  for (int o = 1; o < 32; o <<= 1) {", "  for (int o = 32; o < 32; o <<= 1) {")],
    "store_direct": [("          out[q][k] = v;\n",
                      "          if (grp * kRows + q < a.rows) a.gain[(size_t)(grp * kRows + q) * "
                      "a.n_bins + b] = v;\n"),
                     ("      if (row < a.rows) store_bins<PER>(",
                      "      if (false) store_bins<PER>(")],
    "blocks4": [("__launch_bounds__(32 * kWarps) split_kernel",
                 "__launch_bounds__(32 * kWarps, 4) split_kernel")],
}
EXACT = ("built", "rows1", "rows4", "warps4", "warps16", "blocks4", "blocks5", "scalar",
         "ldg", "stcs", "no_zero_guard", "store_direct")


def build(name: str) -> subprocess.Popen:
    """nvcc of variant ``name`` into ``OUT/name/lib.so``."""
    from repro_torch.kernels import _build

    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    texts = {p.name: p.read_text() for p in CSRC.glob("*.cu*")}
    for old, new in SOURCES[name]:
        where = [f for f in ("split_scan.cu", "level_common.cuh") if old in texts[f]]
        assert len(where) == 1, (name, old)
        texts[where[0]] = texts[where[0]].replace(old, new)
    for fname, text in texts.items():
        (d / fname).write_text(text)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / "split_scan.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def cases(cs, hist_compare, dev) -> list:
    """(tag, hist, lam, min_h, int32 mask): L = 256, then each level's whole
    histogram on the walk's staged nodes."""
    from repro_torch.data import synthetic
    from repro_torch.kernels import histogram
    from repro_torch.trees.binning import bin_dataset
    from repro_torch.trees.learner import _staged_level

    x, y, mult = synthetic.raw(synthetic.PAPER_DATASETS["realsim-like"])
    data = bin_dataset(x, y, n_bins=64, multiplicity=mult, device=dev)
    g, h, node8, _, gen = cs.kernel_inputs(data)
    lc = cs.CFG.learner
    mask = (torch.rand(data.n_features, generator=gen, device=dev) < lc.feature_fraction)
    out = [("L=256", histogram.histogram(data.bins, node8, g, h, 256, lc.n_bins), lc.lam,
            lc.min_child_hess, mask.to(torch.int32))]
    for which, level, bins, g, h, node, mask, parent, lc in hist_compare.level_walk(cs, dev, 9):
        hist = _staged_level(lc, bins, node, g, h, mask, level, parent)[0]
        out.append((f"{which} level{level}", hist, lc.lam, lc.min_child_hess,
                    mask.to(torch.int32)))
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("names", nargs="+", choices=list(SOURCES))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("split_gain_variants: no CUDA device")
    import chip_smoke as cs
    import hist_compare
    from repro_torch.kernels import _build, split_scan

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    _build.build_all()
    dev = torch.device("cuda")
    report: dict = {"nvidia_smi": smi, "ptxas": {}, "shapes": {}}
    shapes = cases(cs, hist_compare, dev)
    procs = {n: build(n) for n in args.names}
    for n, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"{n}: nvcc failed\n{log}")
        report["ptxas"][n] = [ln.strip() for ln in log.splitlines()
                              if "Used" in ln or "spill" in ln or "Function properties" in ln]
    built = {tag: split_scan.split_gain_decide(*a) for tag, *a in shapes}
    for n in args.names:
        _build._LIBS["split_scan"] = ctypes.CDLL(str(OUT / n / "lib.so"))
        _build._FUNCTIONS.clear()
        for tag, *a in shapes:
            if n in EXACT:
                got = split_scan.split_gain_decide(*a)
                if not all(torch.equal(x, y) for x, y in zip(got, built[tag])):
                    raise AssertionError(f"{n} {tag}: differs from the built kernel")
            report["shapes"].setdefault(tag, []).append({
                "source": n,
                "decide": cs.event_times(lambda a=a: split_scan.split_gain_decide(*a)),
                "surface": cs.event_times(lambda a=a: split_scan.split_gain(*a[:3]))})
        cs.fill_device_times()  # before the library changes
    for tag, rows in report["shapes"].items():
        for r in rows:
            for form in ("decide", "surface"):
                t = r.pop(form)
                r.update({f"{form}_ms": t["ms"], f"{form}_device_ms": t["device_ms"]})
        print(f"{tag}, device ms decision / surface [{smi}]: " + "; ".join(
            f"{r['source']} {r['decide_device_ms']:.4f} / {r['surface_device_ms']:.4f}"
            for r in rows), flush=True)
    for n, lines in report["ptxas"].items():
        ks = cs.ptxas_kernels(lines)
        print(f"ptxas {n}: " + ", ".join(
            f"{cs.split_label(k['function'])[len('split_kernel'):]} {k['registers']}"
            + (f" spills {k['spill_stores']}/{k['spill_loads']}" if k["spill_stores"]
               or k["spill_loads"] else "") for k in ks), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "split_gain_variants.json").write_text(json.dumps(report, indent=1, default=str))


if __name__ == "__main__":
    main()
