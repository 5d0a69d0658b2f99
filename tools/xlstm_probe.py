"""The xLSTM family's first card probe: what the sLSTM's loop over positions
costs at xlstm-1.3b's full width, to size the smoke's xLSTM phase.

    python3 tools/xlstm_probe.py [--device cpu --tiny]

Counts the aten ops a position of ``models.xlstm.slstm_scan`` dispatches
(``chip_smoke.slstm_ops_per_position``: in inference, and forward plus
backward), times the sLSTM scan alone, a
prefill of 4 x 2048 and 4 x 1024 tokens, decode steps, and AdamW steps
(accum 2) at microbatches of 4 x 256 and 4 x 512 tokens, each by wall
clock and CUDA events; writes ``chiprun_out/probe_xlstm.json``. ``--tiny``
runs the reduced config at small shapes (a rehearsal on the CPU).
"""
import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
import repro_torch.configs as configs  # noqa: E402
from repro_torch.launch.steps import make_decode_step, make_prefill_step  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.launch.train import synthetic_batches  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models import xlstm as X  # noqa: E402
from repro_torch.optim import adamw, cosine_schedule  # noqa: E402

ARCH = "xlstm-1.3b"


def timed(fn, dev, reps: int = 1) -> dict:
    """Wall and (on the card) event ms of ``fn``, the mean over ``reps``
    calls after one warm-up call."""
    fn()
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    if cuda:
        stop.record()
        torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0) / reps
    return {"wall_ms": wall, "event_ms": start.elapsed_time(stop) / reps if cuda else None}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args()
    dev = torch.device(args.device)
    cfg = configs.get(ARCH)
    out: dict = {}
    if dev.type == "cuda":
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip()
        torch.backends.cuda.matmul.allow_tf32 = False
    b, prompts, mbs, new = 4, (2048, 1024), (256, 512), 8
    if args.tiny:
        cfg, prompts, mbs, new = cfg.reduced(), (64, 32), (16, 32), 4
    print(out.get("card"), cfg.name, flush=True)

    # Ops a position: the scan over 64 positions, at the model's width.
    out["ops_per_position"] = c.slstm_ops_per_position(cfg, dev, batch=b)
    print("ops a position", json.dumps(out["ops_per_position"]), flush=True)
    h, hd = cfg.n_heads, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(0)
    r = (torch.randn((h, 4, hd, hd), generator=gen, device=dev) / hd ** 0.5).to(torch.bfloat16)

    # The scan alone at the prefill's length.
    pre = torch.randn((b, prompts[0], 4, h, hd), generator=gen, device=dev).to(torch.bfloat16)
    with torch.inference_mode():
        out["slstm_scan_ms"] = timed(lambda: X.slstm_scan(pre, r), dev)
    print("slstm scan", prompts[0], out["slstm_scan_ms"], flush=True)
    del pre

    params = init_params(cfg, gen, device=dev)
    for plen in prompts:
        toks = torch.randint(0, cfg.vocab_size, (b, plen), generator=gen, device=dev,
                             dtype=torch.int32)
        step = make_prefill_step(cfg, max_len=plen + new)
        res = {"prefill": timed(lambda: step(params, {"tokens": toks}), dev)}
        tok, _, cache = step(params, {"tokens": toks})
        decode = make_decode_step(cfg)
        state = {"tok": tok, "cache": cache}

        def one():
            state["tok"], state["cache"] = decode(params, state["tok"][:, None],
                                                  state["cache"])
        res["decode_token"] = timed(one, dev, reps=new)
        out[f"serve_{b}x{plen}"] = res
        print("serve", plen, json.dumps(res), flush=True)
        del cache, state
    recipe = adamw(cosine_schedule(1e-3, 1, 6), weight_decay=0.01, max_grad_norm=1.0)
    for s in mbs:
        opt_state = recipe.init(params)
        train_step = make_train_step(cfg, recipe, accum=2)
        batches = list(synthetic_batches(cfg, 2 * b, s, 3, seed=0, device=dev))
        it = iter(batches)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        res = timed(lambda: train_step(params, opt_state, next(it), gen), dev, reps=2)
        if dev.type == "cuda":
            res["peak_gb"] = torch.cuda.max_memory_allocated() / 2**30
        out[f"train_step_{2 * b}x{s}_accum2"] = res
        print("train", s, json.dumps(res), flush=True)
        del opt_state
    path = ROOT / "chiprun_out" / "probe_xlstm.json"
    path.parent.mkdir(exist_ok=True)
    path.write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
