"""The sharded LM phase of ``chip_smoke.py`` alone on the card, after one
probe of what a ``torch.profiler`` session does to later launches.

    python3 tools/lm_mesh_probe.py

First times a launch of a tiny in-place add (the mean of 4000 a run,
three runs) before any profiler session, after one and after two
(``chip_smoke.device_trace``); then builds the kernels and runs
``chip_smoke.drive_lm_mesh`` (the single-device results, the four gloo
ranks on the (2, 2) mesh, every gate), printing its lines; writes its
summary to ``chiprun_out/lm_mesh_probe.json``. About 2.5 minutes of chip
time with the build.
"""
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke as c  # noqa: E402


def launch_us(x: torch.Tensor, n: int = 4000) -> float:
    """Host µs a launch of ``x.add_(1)``, over ``n`` launches."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        x.add_(1)
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - t0) / n


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("lm_mesh_probe: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    x = torch.zeros(16, device="cuda")
    runs = {"before": [launch_us(x) for _ in range(3)]}
    for tag in ("after one session", "after two"):
        c.device_trace(lambda: [x.add_(1) for _ in range(200)], 1)
        runs[tag] = [launch_us(x) for _ in range(3)]
    print("probe, µs a launch: " + json.dumps(runs), flush=True)
    t0 = time.perf_counter()
    c._build.build_all()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {"nvidia_smi": smi}
    c.drive_lm_mesh(torch.device("cuda"), report)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "lm_mesh_probe.json").write_text(json.dumps(
        {"launch_us": runs, **report["lm_mesh"]}, default=str, indent=1))


if __name__ == "__main__":
    main()
