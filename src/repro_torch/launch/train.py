"""Training driver (twin of ``repro.launch.train``), on the card unless
``--device cpu``. The LM zoo:

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
        --steps 200 --batch 8 --seq 128 [--full] [--delay 4] [--sample 0.8]

``--delay`` wraps the optimizer in the paper's DelayedGradient staleness
mechanism with Proposition 1's step scale; ``--sample`` draws Bernoulli
importance weights per microbatch: the two halves of asynch-SGBDT applied
to NN training. Configs are reduced unless ``--full``. Each logged step
prints the loss, its cross-entropy part and the router aux loss (the MoE
family's load-balance term, summed over the layers; 0 for the others).

``--arch gbdt`` drives the paper's own model through the parameter-server
engine (``repro_torch.ps``):

    PYTHONPATH=src python -m repro_torch.launch.train --arch gbdt \
        --steps 200 --workers 16 [--sample 0.8] [--sparse] \
        [--backend staged|fused] [--objective logistic|mse|quantile:0.9|huber|
                                  multiclass:5|lambdarank]

``--scan`` runs the trainer's explicit-schedule form and prints the
per-round loss. ``--runtime threads`` runs the real host-async runtime
(``repro_torch.ps.runtime``: W worker threads, each on a CUDA stream of
its own on the card, race the server's fold loop, and the realized k(j) is
recorded), with ``--trace-out``, ``--verify-replay``, faults
(``--crash-ticket``, ``--leave-ticket``, ``--join W:J``),
``--shard-pulls``, ``--adaptive-step`` and crash-resume
(``--checkpoint-dir``, ``--checkpoint-every``, ``--halt-at-fold``,
``--resume-from``, ``--verify-resume``):

    PYTHONPATH=src python -m repro_torch.launch.train --arch gbdt \
        --runtime threads --steps 32 --workers 4 --verify-replay [--device cpu]

``--mesh 1d|2d`` shards the tree build (``repro_torch.ps.sharded``): one
command starts the ``P_d x P_f`` ranks itself (``--mesh-shape``, e.g.
``4`` or ``1x4``), or joins them when started under ``torchrun``; rank 0
prints the mesh and the collective bytes of a round:

    PYTHONPATH=src python -m repro_torch.launch.train --arch gbdt --device cpu \
        --steps 6 --workers 2 --mesh 2d --mesh-shape 1x2 --sparse

``--mesh-backend`` picks the process-group backend (default: NCCL on the
card, gloo on the CPU; ranks sharing one card need gloo).
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

import repro_torch.configs as configs
from repro_torch import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import init_params
from repro_torch.models.cache import require_ported, torch_dtype
from repro_torch.optim import adamw, cosine_schedule, delayed_gradient, staleness_step_scale
from repro_torch.optim.optimizers import tree_leaves


def synthetic_batches(cfg, batch: int, seq: int, steps: int, seed: int = 0,
                      device: str | torch.device | None = None):
    """Markov-chain token stream with learnable (non-uniform) bigram
    structure: the reference's numpy stream bit for bit, as int32 tensors
    on ``device``. The VLM and audio families also get ``media`` (B, M, D):
    standard normals x 0.02 from the same generator, drawn after each
    step's tokens (so they shift every later step's tokens, as in the
    reference), cast f64 -> f32 -> ``cfg.dtype`` as the reference's 32-bit
    JAX casts them."""
    require_ported(cfg)
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    v = cfg.vocab_size
    # sparse row-stochastic transition matrix with strong modes
    nxt = rng.integers(0, v, size=(v, 4))
    for _ in range(steps):
        toks = np.empty((batch, seq + 1), np.int64)
        toks[:, 0] = rng.integers(0, v, size=batch)
        choice = rng.integers(0, 4, size=(batch, seq))
        mix = rng.random((batch, seq)) < 0.1  # 10% noise
        noise = rng.integers(0, v, size=(batch, seq))
        for t in range(seq):
            step_tok = nxt[toks[:, t], choice[:, t]]
            toks[:, t + 1] = np.where(mix[:, t], noise[:, t], step_tok)
        out = {
            "tokens": torch.as_tensor(toks[:, :-1].astype(np.int32), device=dev),
            "labels": torch.as_tensor(toks[:, 1:].astype(np.int32), device=dev),
        }
        if cfg.family in ("vlm", "audio"):
            media = rng.standard_normal((batch, cfg.n_media_tokens, cfg.d_model)) * 0.02
            out["media"] = torch.as_tensor(media.astype(np.float32), device=dev).to(
                torch_dtype(cfg))
        yield out


def gbdt_dataset_for(objective, seed: int, n: int = 4_000,
                     device: str | torch.device | None = None):
    """The objective's matched synthetic workload on ``device`` (the card
    unless one is given) -> (objective, data), as the reference dispatches:
    query groups of 16 documents over 40 features for ``lambdarank``,
    K-class blobs over 60 features for ``multiclass:K``, sparse regression
    (1000 features, 20 nonzeros a row) for mse, quantile and huber, sparse
    classification (the same widths) for logistic."""
    from repro_torch.data import synthetic as D
    from repro_torch.objectives import get_objective

    obj = get_objective(objective)
    if obj.name == "lambdarank":
        return obj, D.make_ranking(max(n // 16, 16), 16, 40, seed=seed, device=device)
    if obj.n_outputs > 1:
        return obj, D.make_multiclass_classification(n, 60, obj.n_outputs, seed=seed,
                                                     device=device)
    if obj.name in ("mse", "quantile", "huber"):
        return obj, D.make_sparse_regression(n, 1_000, 20, seed=seed, device=device)
    return obj, D.make_sparse_classification(n, 1_000, 20, seed=seed, device=device)


def gbdt_config(objective: str, n_trees: int, sample: float = 0.8,
                hist_mode: str = "subtract", backend: str = "staged"):
    """The driver's GBDT configuration: depth 6, 64 bins, feature fraction
    0.8, v = 0.15, Bernoulli rate ``sample``."""
    from repro_torch.core.sgbdt import SGBDTConfig
    from repro_torch.trees.learner import LearnerConfig

    return SGBDTConfig(
        n_trees=n_trees, step_length=0.15, sampling_rate=sample, objective=objective,
        learner=LearnerConfig(depth=6, n_bins=64, feature_fraction=0.8,
                              hist_mode=hist_mode, backend=backend),
    )


def run_gbdt(args):
    """Asynch-SGBDT on the PS engine under round-robin W workers (the loop
    form, or ``--scan``); returns the final ``TrainState``. ``--runtime
    threads`` goes to ``run_gbdt_threads``. ``--objective`` picks the
    objective and its matched workload (``gbdt_dataset_for``); the final
    metrics are the objective's (rmse, coverage, accuracy, pairwise
    accuracy), query ids included."""
    from repro_torch.core.sgbdt import train_loss, train_metrics
    from repro_torch.ps import Trainer
    from repro_torch.trees import binning

    if args.mesh != "none":
        if args.runtime == "threads":
            raise SystemExit(
                "--mesh applies to the simulated PS engine; the threaded "
                "runtime builds on the local device"
            )
        return run_gbdt_mesh(args)
    dev = resolve_device(args.device)
    obj, data = gbdt_dataset_for(args.objective, args.seed, device=dev)
    if args.sparse:
        data = data._replace(bins=binning.to_sparse(data.bins))
        print(f"sparse bins: {data.bins.indices.shape[1]} nnz/row ELL "
              "(dense round-trip exact)")
    cfg = gbdt_config(args.objective, args.steps, args.sample or 0.8, args.hist_mode,
                      args.backend)
    if args.runtime == "threads":
        return run_gbdt_threads(args, cfg, data, obj)
    schedule = ("round_robin", args.workers)
    print(f"gbdt[{obj.name}, K={obj.n_outputs}]: {args.steps} rounds, {args.workers} PS "
          f"workers ({'scan' if args.scan else 'loop'} form, {args.backend} levels), "
          f"device={dev}")
    t0 = time.time()
    trainer = Trainer(cfg, device=dev)
    if args.scan:
        state, losses = trainer.train_scan(data, schedule, seed=args.seed)
        print(f"loss {float(losses[0]):.4f} -> {float(losses[-1]):.4f}")
    else:
        def on_eval(st, j):
            print(f"  round {j:4d}: train loss {float(train_loss(cfg, data, st)):.4f}")

        state = trainer.train(
            data, schedule, seed=args.seed,
            eval_every=max(args.log_every, 1) * 5, eval_fn=on_eval,
        )
        metrics = {k: f"{float(v):.4f}" for k, v in train_metrics(cfg, data, state).items()}
        print(f"final {metrics}")
    print(f"trained in {time.time() - t0:.1f}s")
    if not np.isfinite(float(train_loss(cfg, data, state))):
        raise RuntimeError("training diverged")
    return state


def mesh_shape(args) -> tuple[int, int]:
    """(P_d, P_f) of ``--mesh`` / ``--mesh-shape`` (the reference's
    defaults: 2 data shards for 1d, 1x2 for 2d)."""
    shape = args.mesh_shape or ("2" if args.mesh == "1d" else "1x2")
    pd, _, pf = shape.partition("x")
    if args.mesh == "1d":
        if pf:
            raise SystemExit(f"--mesh 1d takes one shard count, got --mesh-shape {shape}")
        return int(pd), 1
    return int(pd), int(pf or 1)


def run_gbdt_mesh(args):
    """``--mesh``: start the P_d x P_f ranks (``launch.mesh.spawn``), or
    join them under ``torchrun``, and train on each (``_gbdt_mesh_rank``).
    Returns rank 0's final ``TrainState`` in this process when it is a rank
    (``torchrun``), else None."""
    from repro_torch.launch import mesh as launch_mesh

    pd, pf = mesh_shape(args)
    dev = resolve_device(args.device)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank, world, rank_dev = launch_mesh.init_from_env(dev, args.mesh_backend)
        try:
            return _gbdt_mesh_rank(rank, rank_dev, args, pd, pf)
        finally:
            torch.distributed.destroy_process_group()
    backend = args.mesh_backend or launch_mesh.default_backend(dev)
    print(f"starting {pd * pf} ranks over {backend} on {dev.type}")
    launch_mesh.spawn(_gbdt_mesh_rank, pd * pf, (args, pd, pf), backend=backend,
                      device=dev)
    return None


def _gbdt_mesh_rank(rank: int, dev: torch.device, args, pd: int, pf: int):
    """One rank of ``--mesh``: the whole dataset and the server state on
    every rank, the build sharded over the mesh. Rank 0 prints; every rank
    checks that all ranks hold the same forest."""
    from repro_torch.core.sgbdt import train_loss, train_metrics
    from repro_torch.launch.mesh import make_gbdt_mesh
    from repro_torch.ps import Trainer
    from repro_torch.trees import binning

    world = torch.distributed.get_world_size()
    if world != pd * pf:
        raise SystemExit(f"--mesh-shape {pd}x{pf} needs {pd * pf} ranks, got {world}")
    if dev.type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    say = print if rank == 0 else (lambda *a, **k: None)
    mesh = make_gbdt_mesh(pd, pf, device=dev, backend=args.mesh_backend,
                          feature_axis=args.mesh == "2d")
    say(f"mesh: {args.mesh} {mesh.shape} ({world} ranks, {mesh.backend}, device={dev})")
    obj, data = gbdt_dataset_for(args.objective, args.seed, device=dev)
    if args.sparse:
        data = data._replace(bins=binning.to_sparse(data.bins))
        say(f"sparse bins: {data.bins.indices.shape[1]} nnz/row ELL "
            "(dense round-trip exact)")
    cfg = gbdt_config(args.objective, args.steps, args.sample or 0.8, args.hist_mode,
                      args.backend)
    trainer = Trainer(cfg, mesh=mesh)
    cb = trainer.collective_bytes(data)
    if cb is not None:
        # One tree build per round: the realized (wire) bytes of every
        # collective in the sharded build, by kind.
        kinds = ", ".join(f"{k}={v:,}B" for k, v in sorted(cb["realized_by_kind"].items()))
        say(f"collective bytes/round: {cb['realized_bytes']:,}B realized ({kinds})")
    say(f"gbdt[{obj.name}, K={obj.n_outputs}]: {args.steps} rounds, {args.workers} PS "
        f"workers (loop form, {args.backend} levels)")
    t0 = time.time()

    def on_eval(st, j):
        say(f"  round {j:4d}: train loss {float(train_loss(cfg, data, st)):.4f}")

    state = trainer.train(data, ("round_robin", args.workers), seed=args.seed,
                          eval_every=max(args.log_every, 1) * 5, eval_fn=on_eval)
    metrics = {k: f"{float(v):.4f}" for k, v in train_metrics(cfg, data, state).items()}
    say(f"final {metrics}")
    say(f"trained in {time.time() - t0:.1f}s")
    mine = [t.cpu() for t in (*state.forest, state.f)]
    every = [None] * world
    torch.distributed.all_gather_object(every, mine)
    if not all(all(torch.equal(a, b) for a, b in zip(mine, other)) for other in every):
        raise RuntimeError(f"rank {rank}: the ranks' forests differ")
    say(f"every rank's forest identical: True ({world} ranks)")
    if not np.isfinite(float(train_loss(cfg, data, state))):
        raise RuntimeError("training diverged")
    return state


def _same(a, b, names=("leaf_value",)) -> bool:
    """F and the named forest arrays of two states bitwise equal."""
    return torch.equal(a.f, b.f) and all(
        torch.equal(getattr(a.forest, n), getattr(b.forest, n)) for n in names)


def run_gbdt_threads(args, cfg, data, obj):
    """The real host-async PS runtime: threads, recorded k(j), elastic
    membership faults, sharded pulls, checkpoints, and bitwise replay and
    resume verification; returns ``(state, trace)``."""
    from repro_torch.core.sgbdt import train_loss
    from repro_torch.ps import AsyncRuntime, FaultPlan, RunTrace

    join_at = {}
    for spec in args.join or ():
        w, _, at = spec.partition(":")
        join_at[int(w)] = int(at)
    faults = FaultPlan(
        crash_tickets=frozenset(args.crash_ticket or ()),
        leave_tickets=frozenset(args.leave_ticket or ()),
        join_at=join_at,
    )
    if args.adaptive_step:
        cfg = cfg._replace(adaptive_step=args.adaptive_step)
    rt = AsyncRuntime(cfg, data, n_workers=args.workers, faults=faults,
                      shard_pulls=args.shard_pulls)
    print(f"gbdt[{obj.name}, K={obj.n_outputs}]: {cfg.n_trees} rounds, "
          f"{args.workers} REAL worker threads (host-async runtime, {args.backend} "
          f"levels), device={rt.device}")
    run_kw = dict(
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        halt_at_fold=args.halt_at_fold,
        trace_path=args.trace_out,
    )
    if args.checkpoint_every and not args.checkpoint_dir:
        raise SystemExit("--checkpoint-every needs --checkpoint-dir")
    if args.resume_from:
        if not args.checkpoint_dir:
            raise SystemExit("--resume-from needs --checkpoint-dir")
        prefix = RunTrace.load(args.resume_from)
        print(f"resuming from trace prefix {args.resume_from} "
              f"({prefix.n_trees}/{cfg.n_trees} folds) + checkpoints under "
              f"{args.checkpoint_dir}")
        state, trace = rt.resume(prefix, args.checkpoint_dir, **{
            k: v for k, v in run_kw.items() if k != "checkpoint_dir"
        })
    else:
        state, trace = rt.run(seed=args.seed, **run_kw)
    s = trace.summary()
    print(f"makespan {s['makespan_s']:.2f}s  "
          f"staleness mean {s['mean_staleness']:.2f} max {s['max_staleness']}  "
          f"build {s['t_build_mean_s']*1e3:.1f}ms "
          f"queue {s['t_queue_mean_s']*1e3:.1f}ms "
          f"fold {s['t_fold_mean_s']*1e3:.1f}ms")
    print(f"staleness histogram: {trace.staleness_histogram()}")
    if trace.events:
        print(f"membership events ({trace.n_epochs} epochs):")
        for e in trace.events:
            print(f"  fold {e['fold']:4d}: {e['kind']} worker {e['worker']}"
                  + (f" (ticket {e['ticket']})" if e["ticket"] >= 0 else ""))
    if trace.n_parts:
        print(f"sharded pulls (P={trace.n_parts}): "
              f"{s['pull_bytes_mean']:.0f} B/pull vs {s['pull_bytes_full']} B "
              f"full ({100 * s['pull_reduction']:.1f}% reduction)")
    if trace.adaptive_rho:
        print(f"adaptive step (rho={trace.adaptive_rho}): mean scale "
              f"{s['step_scale_mean']:.4f}")
    loss = float(train_loss(cfg, data, state))
    print(f"final train loss {loss:.4f}")
    if not np.isfinite(loss):
        raise RuntimeError("training diverged")
    if args.trace_out:
        path = trace.save(args.trace_out)
        print(f"trace -> {path}")
    if args.halt_at_fold is not None:
        print(f"halted at fold {args.halt_at_fold} (simulated crash); "
              f"resume with --resume-from {args.trace_out or '<trace>'}")
        if args.verify_replay:
            raise SystemExit(
                "--verify-replay needs a complete run; a halted prefix "
                "replays only via --resume-from or --verify-resume"
            )
    if args.verify_resume:
        if not args.checkpoint_dir:
            raise SystemExit("--verify-resume needs --checkpoint-dir")
        identical = _same(state, rt.replay_from_checkpoint(args.checkpoint_dir, trace))
        print(f"checkpoint + trace-suffix replay identical: {identical}")
        if not identical:
            raise AssertionError("crash-resume replay drifted from the live run")
    if args.verify_replay and args.halt_at_fold is None:
        st_replay, _ = rt.replay(trace)
        identical = _same(state, st_replay, ("leaf_value", "feature", "threshold"))
        print(f"record-and-replay identical forest: {identical}")
        if not identical:
            raise AssertionError("replay drifted from the threaded run")
    return state, trace


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--delay", type=int, default=0,
                    help="gradient staleness tau (DelayedGradient wrapper)")
    ap.add_argument("--rho", type=float, default=0.3,
                    help="overlap probability for the Prop.-1 step scaling")
    ap.add_argument("--sample", type=float, default=0.0,
                    help="Bernoulli sampling rate for importance-weighted batches")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the plain versions)")
    ap.add_argument("--workers", type=int, default=8,
                    help="parameter-server worker count (--arch gbdt)")
    ap.add_argument("--objective", default="logistic",
                    help="GBDT objective registry spec: logistic | mse | quantile[:a] | "
                         "huber[:delta] | multiclass:K | lambdarank")
    ap.add_argument("--sparse", action="store_true",
                    help="train on the SparseBins layout (exact round trip; the "
                         "histogram's cost scales with the stored entries)")
    ap.add_argument("--hist-mode", choices=("subtract", "rebuild"), default="subtract",
                    dest="hist_mode",
                    help="GBDT level histograms: 'subtract' derives each split's sibling "
                         "from the parent; 'rebuild' histograms every node")
    ap.add_argument("--backend", choices=("staged", "fused"), default="staged",
                    help="GBDT tree levels: 'staged' (histogram, split gain and "
                         "routing kernels) or 'fused' (one level kernel where it fits)")
    ap.add_argument("--runtime", choices=("simulated", "threads"), default="simulated",
                    help="PS execution: 'simulated' replays a delay schedule; 'threads' "
                         "runs real worker threads and records the realized k(j)")
    ap.add_argument("--mesh", choices=("none", "1d", "2d"), default="none",
                    help="GBDT build sharding: '1d' shards samples over a ('data',) "
                         "mesh (psum-merged histograms); '2d' the block-distributed "
                         "(data x feature) mesh with the argmax-merge split search. "
                         "Starts its ranks itself, or joins them under torchrun")
    ap.add_argument("--mesh-shape", default=None, metavar="PDxPF",
                    help="mesh shape, e.g. '4' (--mesh 1d) or '2x2' / '1x4' "
                         "(--mesh 2d; sparse bins need Pd=1)")
    ap.add_argument("--mesh-backend", choices=("gloo", "nccl"), default=None,
                    help="process-group backend of --mesh (default: nccl on the card, "
                         "gloo on the CPU; ranks that share one card need gloo)")
    ap.add_argument("--scan", action="store_true",
                    help="run the GBDT trainer over its explicit schedule and print the "
                         "per-round loss")
    ap.add_argument("--trace-out", default=None,
                    help="write the realized RunTrace JSON here (--runtime threads)")
    ap.add_argument("--verify-replay", action="store_true",
                    help="replay the recorded trace through the deterministic engine and "
                         "assert the forests are bit-identical (--runtime threads)")
    ap.add_argument("--crash-ticket", type=int, action="append",
                    help="crash the worker that first draws this build ticket "
                         "(repeatable; the ticket is re-issued)")
    ap.add_argument("--leave-ticket", type=int, action="append",
                    help="worker gracefully leaves after building this ticket (repeatable)")
    ap.add_argument("--join", action="append", metavar="W:J",
                    help="worker W (re)joins when the server reaches fold count J "
                         "(repeatable)")
    ap.add_argument("--shard-pulls", type=int, default=0, metavar="P",
                    help="shard the server leaf table into P partitions; workers pull "
                         "only partitions their sample touches (rowwise objectives only)")
    ap.add_argument("--adaptive-step", type=float, default=0.0, metavar="RHO",
                    help="staleness-adaptive server fold: scale each fold by "
                         "1/(1 + 6*RHO*tau) with tau the observed staleness "
                         "(--runtime threads)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="runtime checkpoint directory (--runtime threads)")
    ap.add_argument("--checkpoint-every", type=int, default=0, metavar="K",
                    help="checkpoint the server + in-flight versions every K folds")
    ap.add_argument("--halt-at-fold", type=int, default=None, metavar="J",
                    help="simulate a whole-process crash: stop the server after J folds "
                         "and write the prefix trace")
    ap.add_argument("--resume-from", default=None, metavar="TRACE",
                    help="resume a halted run from its prefix trace JSON + "
                         "--checkpoint-dir; unfolded tickets are re-issued")
    ap.add_argument("--verify-resume", action="store_true",
                    help="after the run, rebuild the final state from the newest "
                         "checkpoint + trace suffix and assert it matches bitwise")
    args = ap.parse_args(argv)

    if args.arch == "gbdt":
        return run_gbdt(args)
    dev = resolve_device(args.device)
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()

    lr = args.lr
    if args.delay:
        lr *= staleness_step_scale(args.delay, args.rho)
        print(f"delay={args.delay}: scaling lr by Prop. 1 -> {lr:.2e}")
    opt = adamw(cosine_schedule(lr, max(args.steps // 20, 1), args.steps),
                weight_decay=0.01, max_grad_norm=1.0)
    if args.delay:
        opt = delayed_gradient(opt, args.delay)
    step_fn = make_train_step(cfg, opt, accum=args.accum, sampling_rate=args.sample)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(cfg, gen, device=dev)
    opt_state = opt.init(params)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"{cfg.name}: {n_params/1e6:.2f}M params, family={cfg.family}, device={dev}")

    t0 = time.time()
    losses = []
    for i, batch in enumerate(synthetic_batches(cfg, args.batch, args.seq, args.steps,
                                                args.seed, dev)):
        params, opt_state, metrics = step_fn(params, opt_state, batch, gen)
        losses.append(float(metrics["loss"]))
        if (i + 1) % args.log_every == 0:
            rate = args.batch * args.seq * args.log_every / (time.time() - t0)
            print(f"step {i+1:5d} loss={losses[-1]:.4f} ce={float(metrics['ce']):.4f} "
                  f"aux={float(metrics['aux']):.4f} tok/s={rate:,.0f}")
            t0 = time.time()
    print(f"final loss: {losses[-1]:.4f} (start {losses[0]:.4f}); ce "
          f"{float(metrics['ce']):.4f}, aux {float(metrics['aux']):.4f}")
    if not np.isfinite(losses[-1]):
        raise RuntimeError("training diverged")
    return losses


if __name__ == "__main__":
    main()
