"""Time the histogram kernels of one checkout of the PyTorch/CUDA port.

    python3 tools/hist_compare.py --src SRC_DIR --tag NAME

Imports ``repro_torch`` from ``SRC_DIR`` (this repository's ``src``, or the
``src`` of another commit unpacked with ``git archive``), builds its
kernels into that checkout's ``build/``, and runs ``chip_smoke.py``'s
measurements of the dense histogram (level 0 and the level-8 subset), the
fused level (level 0 and the deepest fused level), the sparse histogram
(both shapes) and the nine-level sweep at efficiency-realsim width, each
against its plain version. Writes ``chiprun_out/hist_compare_<NAME>.json``
and prints one summary line. To compare two commits on one card, run it in
turns in one session: parent, change, change, parent. Needs one GPU.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True, help="the src directory of a checkout")
    ap.add_argument("--tag", required=True)
    args = ap.parse_args()
    src = pathlib.Path(args.src).resolve()
    # The package comes from --src: it is imported before chip_smoke, whose
    # own imports then find it loaded.
    sys.path.insert(0, str(src))
    import repro_torch.kernels.ops  # noqa: F401
    import torch

    if not torch.cuda.is_available():
        sys.exit("hist_compare: no CUDA device")
    sys.path.insert(0, str(ROOT))
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
    x, y, mult = synthetic.raw(synthetic.PAPER_DATASETS["realsim-like"])
    data = bin_dataset(x, y, n_bins=64, multiplicity=mult, device=dev)
    sparse = bin_dataset(x, y, n_bins=64, multiplicity=mult, device=dev, sparse=True).bins
    g, h, node8, active, gen = cs.kernel_inputs(data)
    cs.check_histogram(data, g, h, node8, active, report)
    cs.check_level_build(data, g, h, gen, report)
    cs.check_histogram_sparse(sparse, node8, active, g, h, report)
    cs.sweep_levels(data, sparse, g, h, gen, report)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"hist_compare_{args.tag}.json").write_text(json.dumps(report, indent=1))
    keys = ("ms", "device_ms", "library_ms", "library_device_ms", "bound_ms")
    summary = {f"{kern} {tag}": {k: round(v[k], 5) for k in keys if v.get(k) is not None}
               for kern in ("histogram", "level_build", "histogram_sparse")
               for tag, v in report[f"{kern}_shapes"].items()}
    print(f"{args.tag} [{smi}]: " + json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
