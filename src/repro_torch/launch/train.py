"""Training driver of the port's LM zoo (twin of the LM part of
``repro.launch.train``), on the card unless ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
        --steps 200 --batch 8 --seq 128 [--full] [--delay 4] [--sample 0.8]

``--delay`` wraps the optimizer in the paper's DelayedGradient staleness
mechanism with Proposition 1's step scale; ``--sample`` draws Bernoulli
importance weights per microbatch: the two halves of asynch-SGBDT applied
to NN training. Configs are reduced unless ``--full``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

import repro_torch.configs as configs
from repro_torch import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import init_params
from repro_torch.models.cache import require_dense
from repro_torch.optim import adamw, cosine_schedule, delayed_gradient, staleness_step_scale
from repro_torch.optim.optimizers import tree_leaves


def synthetic_batches(cfg, batch: int, seq: int, steps: int, seed: int = 0,
                      device: str | torch.device | None = None):
    """Markov-chain token stream with learnable (non-uniform) bigram
    structure: the reference's numpy stream bit for bit, as int32 tensors
    on ``device``."""
    require_dense(cfg)
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
        yield {
            "tokens": torch.as_tensor(toks[:, :-1].astype(np.int32), device=dev),
            "labels": torch.as_tensor(toks[:, 1:].astype(np.int32), device=dev),
        }


def main(argv: list[str] | None = None) -> list[float]:
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
    args = ap.parse_args(argv)

    if args.arch == "gbdt":
        raise NotImplementedError("--arch gbdt: the GBDT driver is not ported yet "
                                  "(ROADMAP.md, A12: drivers and benchmarks)")
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
            print(f"step {i+1:5d} loss={losses[-1]:.4f} tok/s={rate:,.0f}")
            t0 = time.time()
    print(f"final loss: {losses[-1]:.4f} (start {losses[0]:.4f})")
    if not np.isfinite(losses[-1]):
        raise RuntimeError("training diverged")
    return losses


if __name__ == "__main__":
    main()
