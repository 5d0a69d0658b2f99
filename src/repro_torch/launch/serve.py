"""Serving driver (twin of ``repro.launch.serve``), on the card unless
``--device cpu``. The LM zoo: seeded weights, a batch of seeded prompts
prefilled once, then greedy decode against the cache, through the mesh
forms of the steps on the host mesh (``launch.mesh.make_host_mesh``, 1 x
1), as the reference's CLI runs them:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi3.5-moe-42b \
        [--full] [--batch 4] [--prompt-len 64] [--gen 32] [--seed 0]

Configs are reduced unless ``--full``; the VLM and audio families also
get seeded media (B, M, D), normals x 0.02 in ``cfg.dtype``. The recurrent
families (zamba2, xLSTM) need a prompt that divides into chunks of
``min(ssm_chunk, prompt)``, else ``ValueError``.

``--arch gbdt`` serves the paper's own model: train an asynch-SGBDT forest
on the PS engine, checkpoint it mid-run and at the end, then answer
batched raw-float prediction requests through the ``ForestServer``
(serve-time binning + traversal kernel), hot-swapping to the newest
checkpoint between waves:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gbdt \\
        --trees 60 --requests 12 [--rows 64] [--workers 8] \\
        [--objective logistic|mse|quantile:0.9|huber|multiclass:3|lambdarank] \
        [--quantize none|int8|fp16]

``--engine continuous`` serves the same traffic through the
continuous-batching ``ForestEngine``: the mid-training and final
checkpoints load as two named versions, traffic A/B-splits between them by
uid hash, and p50/p99 queue, compute and end-to-end latency is reported
against ``--slo-ms``.
"""
from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch import resolve_device


def run_lm(args) -> np.ndarray:
    """Prefill ``--batch`` seeded prompts of ``--prompt-len`` tokens, then
    decode greedily to ``--gen`` tokens each; prints the times and a
    sample, checks every token is in the vocab and returns them (B, gen)."""
    import repro_torch.configs as configs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import init_params
    from repro_torch.models.cache import require_ported, torch_dtype
    from repro_torch.sharding import batch_axes

    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    require_ported(cfg)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(cfg, gen, device=dev)
    mesh = make_host_mesh(device=dev)
    baxes = batch_axes(mesh)
    prefill_fn = make_prefill_step(cfg, mesh, baxes, max_len=args.prompt_len + args.gen)
    decode_fn = make_decode_step(cfg, mesh, baxes)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len), generator=gen,
                            device=dev, dtype=torch.int32)
    batch = {"tokens": prompts}
    if cfg.family in ("vlm", "audio"):
        batch["media"] = (torch.randn((args.batch, cfg.n_media_tokens, cfg.d_model),
                                      generator=gen, device=dev) * 0.02).to(torch_dtype(cfg))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sync()
    t0 = time.time()
    tok, _, cache = prefill_fn(params, batch)
    sync()
    t1 = time.time()
    out = [tok]
    for _ in range(args.gen - 1):
        tok, cache = decode_fn(params, tok[:, None], cache)
        out.append(tok)
    sync()
    t2 = time.time()
    tokens = torch.stack(out, dim=1).cpu().numpy()
    print(f"{cfg.name}: prefill {args.batch}x{args.prompt_len} in {t1 - t0:.2f}s; "
          f"decoded {args.gen} tokens in {t2 - t1:.2f}s "
          f"({args.batch * args.gen / (t2 - t1):,.1f} tok/s)")
    print("sample:", tokens[0, :16].tolist())
    if not (tokens.min() >= 0 and tokens.max() < cfg.vocab_size):
        raise RuntimeError("a served token lies outside the vocab")
    return tokens


def run_gbdt(args) -> list:
    """Train -> checkpoint -> serve handoff with a live hot swap; returns
    the served results (sorted by uid within each half of the traffic).

    The server applies ``--objective``'s link, so multiclass serves (rows,
    K) softmax rows, logistic serves p(y = 1), and the regression and
    ranking objectives serve the raw margin (the identity link).
    """
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.sgbdt import SGBDTConfig
    from repro_torch.launch.train import gbdt_dataset_for
    from repro_torch.objectives import get_objective
    from repro_torch.ps import Trainer
    from repro_torch.serving import (
        ForestEngine,
        ForestServer,
        PredictRequest,
        load_forest_checkpoint,
        percentile_latencies,
    )
    from repro_torch.trees.binning import bin_dataset
    from repro_torch.trees.learner import LearnerConfig

    dev = resolve_device(args.device)
    obj = get_objective(args.objective)
    rng = np.random.default_rng(args.seed)
    n, dim = 2_000, 40
    if obj.n_outputs > 1 or obj.name == "lambdarank":
        # Structured targets (class ids, query groups): the shared objective
        # -> workload dispatch.
        _, data = gbdt_dataset_for(args.objective, args.seed, n=n, device=dev)
        dim = data.n_features
    else:
        # Scalar targets (logistic, mse, quantile, huber): the demo's light
        # dense set, as the reference draws it.
        x = rng.standard_normal((n, dim)).astype(np.float32)
        w = rng.standard_normal(dim).astype(np.float32)
        y = (x @ w + 0.1 * rng.standard_normal(n) > 0).astype(np.float32)
        data = bin_dataset(x, y, n_bins=64, device=dev)

    cfg = SGBDTConfig(
        n_trees=args.trees,
        step_length=0.15,
        sampling_rate=0.8,
        objective=args.objective,
        learner=LearnerConfig(depth=5, n_bins=64, feature_fraction=0.8),
    )
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="gbdt_serve_")
    ckpt = CheckpointManager(ckpt_dir, save_every=1, keep=4)
    half = max(args.trees // 2, 1)
    print(f"gbdt: training {args.trees} trees ({args.workers} PS workers) on {dev}, "
          f"checkpointing steps {half} and {args.trees} -> {ckpt_dir}")
    state = Trainer(cfg, device=dev).train(
        data, ("round_robin", args.workers), seed=args.seed,
        eval_every=half, eval_fn=lambda st, j: ckpt.maybe_save(j, st),
    )
    ckpt.maybe_save(args.trees, state)  # idempotent when half divides trees

    quantize = None if args.quantize == "none" else args.quantize
    reqs = [
        PredictRequest(uid=i, x=rng.standard_normal(
            (int(rng.integers(1, args.rows // 2 + 1)), dim)).astype(np.float32))
        for i in range(args.requests)
    ]

    if args.engine == "continuous":
        # Two checkpoints, two live versions: traffic A/B-splits by uid
        # hash, each result labelled with its version and that version's step.
        eng = ForestEngine(data.bin_edges, max_rows=args.rows, slo_s=args.slo_ms / 1e3,
                           device=dev)
        eng.add_version("half", load_forest_checkpoint(ckpt_dir, half, device=dev),
                        model_step=half, objective=obj, quantize=quantize)
        t0 = time.time()
        first = eng.run(reqs[: args.requests // 2])
        eng.add_version("full", load_forest_checkpoint(ckpt_dir, args.trees, device=dev),
                        model_step=args.trees, objective=obj, quantize=quantize,
                        weight=3.0)  # ramp the new version to 75% of the split
        second = eng.run(reqs[args.requests // 2:])
        dt = time.time() - t0
        outs = first + second
        rows = sum(len(r.scores) for r in outs)
        split: dict[str, int] = {}
        for r in second:
            split[r.version] = split.get(r.version, 0) + 1
        stats = percentile_latencies(outs)
        print(f"continuous engine: served {len(outs)} requests / {rows} rows in {dt:.2f}s "
              f"(quantize={quantize or 'off'}); post-ramp A/B split {split}")
        print(f"  latency p50/p99: queue {stats['queue_p50_ms']:.2f}/"
              f"{stats['queue_p99_ms']:.2f} ms, compute {stats['compute_p50_ms']:.2f}/"
              f"{stats['compute_p99_ms']:.2f} ms, end-to-end {stats['latency_p50_ms']:.2f}/"
              f"{stats['latency_p99_ms']:.2f} ms (SLO {args.slo_ms:.0f} ms)")
        for r in outs[:3]:
            print(f"  req {r.uid}: {len(r.scores)} rows, version={r.version}, "
                  f"model_step={r.model_step}, "
                  f"scores[:4]={np.round(r.scores[:4], 4).tolist()}")
        if {r.model_step for r in first} != {half}:
            raise RuntimeError("a request before the ramp was not served at step "
                               f"{half}")
        if not all(r.model_step == (half if r.version == "half" else args.trees)
                   for r in second):
            raise RuntimeError("a result is labelled with another version's step")
        if not all(np.isfinite(r.scores).all() for r in outs):
            raise RuntimeError("non-finite scores")
        return outs

    # Serve from the mid-training checkpoint first; the checkpoint root is
    # attached after the first half, so both forests answer live traffic.
    server = ForestServer(
        load_forest_checkpoint(ckpt_dir, half, device=dev), data.bin_edges,
        max_rows=args.rows, model_step=half, objective=obj, quantize=quantize, device=dev,
    )
    t0 = time.time()
    first = server.run(reqs[: args.requests // 2])
    server.ckpt_root = ckpt_dir
    swapped = server.maybe_reload()
    second = server.run(reqs[args.requests // 2:])
    dt = time.time() - t0
    outs = first + second
    rows = sum(len(r.scores) for r in outs)
    print(f"served {len(outs)} requests / {rows} rows in {dt:.2f}s ({rows / dt:,.0f} rows/s) "
          f"over {server.waves_served} waves (quantize={quantize or 'off'})")
    step_before = first[-1].model_step if first else half
    print(f"hot swap: step {step_before} -> {server.model_step} (reloaded={swapped})")
    for r in outs[:3]:
        print(f"  req {r.uid}: {len(r.scores)} rows, model_step={r.model_step}, "
              f"scores[:4]={np.round(r.scores[:4], 4).tolist()}")
    if not (swapped and server.model_step == args.trees):
        raise RuntimeError(f"no hot swap to step {args.trees}")
    if not all(np.isfinite(r.scores).all() for r in outs):
        raise RuntimeError("non-finite scores")
    return outs


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trees", type=int, default=60,
                    help="forest size to train then serve (--arch gbdt)")
    ap.add_argument("--workers", type=int, default=8,
                    help="PS worker count for the training phase (--arch gbdt)")
    ap.add_argument("--requests", type=int, default=12,
                    help="prediction requests to serve (--arch gbdt)")
    ap.add_argument("--rows", type=int, default=64, help="wave capacity in rows (--arch gbdt)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a fresh temporary one)")
    ap.add_argument("--objective", default="logistic",
                    help="GBDT objective spec; served outputs go through its link "
                         "(multiclass:3 -> softmax rows; mse, quantile, huber and "
                         "lambdarank -> raw margins)")
    ap.add_argument("--engine", default="wave", choices=["wave", "continuous"],
                    help="wave: the drain-the-queue ForestServer; continuous: the "
                         "multi-version, SLO-cutting ForestEngine")
    ap.add_argument("--quantize", default="none", choices=["none", "int8", "fp16"],
                    help="serve a quantized forest payload (scores within "
                         "quantization_atol of the f32 forest's)")
    ap.add_argument("--slo-ms", type=float, default=50.0,
                    help="latency SLO for the continuous engine's wave cutting")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    if args.arch == "gbdt":
        return run_gbdt(args)
    return run_lm(args)


if __name__ == "__main__":
    main()
