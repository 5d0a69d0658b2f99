"""The media families' first card probe: the flash kernels at their shapes,
the VLM group's plain-SGD step size on fresh and on cycled batches, and
whisper's run A.

    python3 tools/media_probe.py

Checks the flash forward and backward (``chip_smoke.check_flash`` and
``check_flash_bwd``) at llama-3.2-vision-90b's 4 x 2048 (64 q heads on 8
kv heads of 128) and whisper-small's 8 x 448 (12 on 12 of 64, with its
8 x 64 and 8 x 320 serving prompts), trains one VLM group (5 layers at
full width, gates 0.5 and -0.3) 4 steps with ``optim.sgd`` at lr 0.01,
0.1, 1 and 10 on four fresh batches and on two batches each seen twice,
and whisper-small 6 steps with run A's AdamW recipe; writes
``chiprun_out/probe_media.json``.
"""
import dataclasses
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.optim import adamw, cosine_schedule, sgd  # noqa: E402

VLM, AUDIO = "llama-3.2-vision-90b", "whisper-small"
AUDIO_SERVE = [(8, p, p, 12, 12, 64, True, torch.bfloat16, None) for p in (64, 320)]


def flash_checks(dev) -> dict:
    """Each check's kernels-line stats, or its error."""
    rep, out = {}, {}
    for name, fn in (("vlm_fwd", lambda: c.check_flash(dev, rep, VLM, [], "_vlm")),
                     ("vlm_bwd", lambda: c.check_flash_bwd(dev, rep, VLM, [], "_vlm")),
                     ("wh_fwd", lambda: c.check_flash(dev, rep, AUDIO, AUDIO_SERVE, "_wh",
                                                      (8, 448))),
                     ("wh_bwd", lambda: c.check_flash_bwd(dev, rep, AUDIO, [], "_wh",
                                                          (8, 448)))):
        try:
            out[name] = fn()
            c.fill_device_times()
        except Exception as e:  # report every check, then go on
            out[name] = repr(e)
        print(name, json.dumps(out[name], default=str)[:800], flush=True)
    out["shapes"] = {k: v for k, v in rep.items() if "shapes" in k}
    return out


def run(cfg, opt, batches: list, accum: int, dev) -> dict:
    """Seeded weights (a VLM's gates at 0.5 and -0.3), one
    ``make_train_step`` step a batch: losses, step ms, peak memory."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = c.init_params(cfg, gen, device=dev)
    if cfg.family == "vlm":
        params["groups"]["cross"]["gate_attn"].fill_(0.5)
        params["groups"]["cross"]["gate_mlp"].fill_(-0.3)
    state = opt.init(params)
    step = c.make_train_step(cfg, opt, accum=accum)
    losses, ms = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, b, gen)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(m["loss"]))
    return {"loss": losses, "ms": ms, "peak_gb": torch.cuda.max_memory_allocated() / 2**30}


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    t = time.perf_counter()
    _build.build_all()
    out = {"build_s": time.perf_counter() - t, **flash_checks(dev)}
    cfg = dataclasses.replace(c.lm_configs.get(VLM), n_layers=5, attn_impl="flash")
    bs = list(c.synthetic_batches(cfg, 2, 2048, 4, seed=0, device=dev))
    for lr in (0.01, 0.1, 1.0, 10.0):
        for kind, stream in (("fresh", bs), ("cycled", [bs[0], bs[1], bs[0], bs[1]])):
            out[f"vlm_sgd_{lr}_{kind}"] = run(cfg, sgd(lr), stream, 2, dev)
            print("vlm sgd", lr, kind, out[f"vlm_sgd_{lr}_{kind}"], flush=True)
    cfg = dataclasses.replace(c.lm_configs.get(AUDIO), attn_impl="flash")
    bs = list(c.synthetic_batches(cfg, 16, 448, 6, seed=0, device=dev))
    recipe = adamw(cosine_schedule(1e-3, 1, 6), weight_decay=0.01, max_grad_norm=1.0)
    out["whisper_adamw"] = run(cfg, recipe, bs, 2, dev)
    print("whisper", out["whisper_adamw"], flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "probe_media.json").write_text(
        json.dumps(out, indent=1, default=str))


if __name__ == "__main__":
    main()
