"""Time variants of the flash backward's wgmma kernels on the card.

    python3 tools/flash_bwd_variants.py [NAME ...]

Each variant is a scratch copy of ``src/repro_torch/csrc`` built into
``build/flash_bwd_variants/<NAME>/`` with one change to
``csrc/flash_attention_bwd.cu``, then loaded in place of the built library
(the plan's tiling patched to match). Two kinds:

- tilings (``tile_*``): the d-64 instances' q rows, keys and stages, and
  the consumer warpgroups without ping-pong (their turns cut); each is
  held to the smoke test's ``bwd_close`` against the plain version;
- cut-outs (``cut_*``): a part of the work removed (the ``ex2``, the whole
  softmax, the s/dp products, every product: the softmax then feeds
  nothing and the compiler drops it too), to see where the time goes;
  their outputs are wrong by construction and are not checked.

Times are CUDA-event means of 50 back-to-back launches of the dq and the
dk/dv kernel alone at granite-3-2b's training shape (4 x 2048, h 32/8, d
64, bf16, causal), in three rounds of alternating order. Writes
``chiprun_out/flash_bwd_variants.json`` and prints one line a run. Needs
one GPU and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import re
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

OUT = ROOT / "build" / "flash_bwd_variants"
SRC = ROOT / "src" / "repro_torch" / "csrc"


def tiling(dq_bk, dq_stages, dkv_bq, dkv_stages, cut=()):
    """The d-64 tiling of both kernels (d 128 keeps the built one): the C
    struct bodies and the plan's ``BWD_TILING``."""
    from repro_torch.kernels import flash_plan

    dq = (f"  static constexpr int kBQ = 128, kBK = D == 64 ? {dq_bk} : 64, "
          f"kStages = D == 64 ? {dq_stages} : 3;\n")
    dkv = (f"  static constexpr int kBQ = D == 64 ? {dkv_bq} : 64, kBK = 128, "
           f"kStages = D == 64 ? {dkv_stages} : 3;\n")
    plan = dict(flash_plan.BWD_TILING)
    plan["dq", 64] = flash_plan.BwdTiling(128, dq_bk, dq_stages)
    plan["dkv", 64] = flash_plan.BwdTiling(dkv_bq, 128, dkv_stages)
    return {"structs": (dq, dkv), "plan": plan, "cut": list(cut)}


SS = ["issue_ss<D, BK, T::kBQ>(s, qd, kdesc(r + j));",
      "issue_ss<D, BK, T::kBQ>(dp, dod, vdesc(r + j));",
      "issue_ss<D, BQ, T::kBK>(s, kd, qdesc(r + i));",
      "issue_ss<D, BQ, T::kBK>(dp, vd, dodesc(r + i));"]
RS = ["issue_rs<D, BK>(acc, ds, ktdesc(r + j));",
      "issue_rs<D, BQ>(dv, pa, dotdesc(r + i));",
      "issue_rs<D, BQ>(dk, da, qtdesc(r + i));"]
SOFTMAX = ["dq_terms<BK, true>(s, dp, nl, dl, a, last);",
           "dq_terms<BK, false>(s, dp, nl, dl, a, none);",
           "dkv_terms<BQ, true>(s, dp, rows(r + i), a, t4, lo, hi);",
           "dkv_terms<BQ, false>(s, dp, rows(r + i), a, t4, none, none);"]
TURNS = ["named_barrier(3 + cw, 256);", "named_barrier_arrive(4 - cw, 256);",
         "named_barrier(3, 256);"]
VARIANTS = {
    "tile_built": tiling(128, 3, 128, 2),
    "tile_stages2": tiling(128, 2, 128, 2),
    "tile_stages4": tiling(128, 4, 128, 4),
    "tile_dkv_stages3": tiling(128, 3, 128, 3),
    "tile_dkv_bq64": tiling(128, 3, 64, 3),
    "tile_dkv_bq64_stages4": tiling(128, 3, 64, 4),
    "tile_dq_bk64": tiling(64, 4, 128, 2),
    "tile_no_pingpong": tiling(128, 3, 128, 2, cut=[(c, ";") for c in TURNS]),
    "cut_ex2": {"cut": [("float p = ex2(__fmaf_rn(", "float p = (__fmaf_rn(")]},
    "cut_softmax": {"cut": [(c, "") for c in SOFTMAX]},
    "cut_ss": {"cut": [(c, "") for c in SS]},
    "cut_products": {"cut": [(c, "") for c in SS + RS]},
}


def build(name: str, spec: dict) -> subprocess.Popen:
    from repro_torch.kernels import _build

    d = OUT / name
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(SRC, d)
    src = d / "flash_attention_bwd.cu"
    s = src.read_text()
    if "structs" in spec:
        for struct, body in zip(("DqTiling", "DkvTiling"), spec["structs"]):
            s, n = re.subn(rf"(struct {struct} {{\n)(.*?)(}};)",
                           lambda m, body=body: m.group(1) + body + m.group(3), s, flags=re.S)
            assert n == 1, struct
    for old, new in spec.get("cut", []):
        assert old in s, (name, old)
        s = s.replace(old, new)
    src.write_text(s)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("flash_bwd_variants: no CUDA device")
    import chip_smoke as cs
    from repro_torch.kernels import _build, flash_plan
    from repro_torch.kernels import flash_attention as fa

    names = sys.argv[1:] or list(VARIANTS)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    _build.build_all()  # the forward, which makes lse
    procs = {n: build(n, VARIANTS[n]) for n in names}
    ptxas = {}
    for n, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"{n}: nvcc failed\n{log}")
        ptxas[n] = [ln for ln in log.splitlines() if "serialized" in ln
                    or ("spill" in ln and " 0 bytes spill stores" not in ln)]

    dev = torch.device("cuda")
    b, s, h, kv, d = 4, 2048, 32, 8, 64
    g = torch.Generator(device="cpu").manual_seed(0)
    q, k, v, do = (torch.randn(shape, generator=g).to(dev, torch.bfloat16).transpose(1, 2)
                   for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d), (b, s, h, d)))
    o, lse = fa.flash_attention(q, k, v, True)
    args = (q, k, v, o, lse, do, True, None)
    want = fa.flash_attention_bwd_plain(*args)
    mag = fa.flash_attention_bwd_magnitudes(*args)
    built = dict(flash_plan.BWD_TILING)
    times: dict = {n: [] for n in names}
    for rnd in range(3):
        for n in names if rnd % 2 == 0 else names[::-1]:
            _build._LIBS["flash_attention_bwd"] = ctypes.CDLL(str(OUT / n / "lib.so"))
            _build._FUNCTIONS.clear()
            flash_plan.BWD_TILING.clear()
            flash_plan.BWD_TILING.update(VARIANTS[n].get("plan", built))
            if n.startswith("tile_") and rnd == 0:
                cs.bwd_close(n, fa.flash_attention_bwd(*args), want, mag, torch.bfloat16)
            ops = fa._bwd_operands(*args[:6], True, None)
            t = {kern: cs.cuda_ms(lambda kern=kern: fa._launch_bwd(kern, ops), reps=50)
                 for kern in ("dq", "dkv")}
            times[n].append(t)
            print(f"{n} round {rnd}: dq {t['dq']:.4f} ms, dkv {t['dkv']:.4f} ms [{smi}]",
                  flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "flash_bwd_variants.json").write_text(json.dumps(
        {"nvidia_smi": smi, "times": times, "ptxas_notices": ptxas}, indent=1))


if __name__ == "__main__":
    main()
