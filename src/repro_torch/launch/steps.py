"""Step builders: the train step, and the prefill and decode programs of
the serving path (twin of ``repro.launch.steps``, single device).

``make_train_step`` builds the production step: microbatched gradient
accumulation (f32 accumulators), optional Bernoulli importance weights
(the paper's sampled objective) and the optimizer update, which works in
place (``optim.optimizers``).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import decode_step, forward_train, prefill
from repro_torch.optim.optimizers import Optimizer, apply_updates, tree_leaves, tree_map


def make_train_step(cfg: ModelConfig, opt: Optimizer, accum: int = 1,
                    sampling_rate: float = 0.0) -> Callable:
    """Returns train_step(params, opt_state, batch, generator) -> (params,
    opt_state, metrics {"loss", "ce", "aux"}).

    The batch's leading axis splits into ``accum`` microbatches; their
    gradients accumulate in f32 and are divided by ``accum``. With
    ``sampling_rate`` R > 0 each microbatch draws keep-weights keep / R
    (keep ~ Bernoulli(R) a sequence) from ``generator``; the reference
    draws them from a JAX key, so the two packages draw other bits. The
    parameters (made to require grad) and the optimizer state are updated
    in place and returned.
    """

    def add_weights(mb: dict, generator: torch.Generator | None) -> dict:
        if sampling_rate <= 0.0:
            return mb
        b = mb["tokens"].shape[0]
        u = torch.rand((b,), generator=generator,
                       device=generator.device if generator is not None else "cpu")
        keep = (u < sampling_rate).to(mb["tokens"].device)
        # importance weights Q_i / R_i: unbiased for the unweighted mean
        return {**mb, "weights": keep.float() / sampling_rate}

    def train_step(params: dict, opt_state, batch: dict,
                   generator: torch.Generator | None = None):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        if accum == 1:
            loss, metrics = forward_train(params, cfg, add_weights(batch, generator))
            grads = torch.autograd.grad(loss, leaves)
        else:
            b = batch["tokens"].shape[0]
            if b % accum:
                raise ValueError(f"batch {b} does not split into {accum} microbatches")
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for p in leaves]
            ce = aux = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
            for i in range(accum):
                mb = {k: v.reshape((accum, b // accum) + v.shape[1:])[i]
                      for k, v in batch.items()}
                mb_loss, m = forward_train(params, cfg, add_weights(mb, generator))
                for acc, g in zip(grads, torch.autograd.grad(mb_loss, leaves)):
                    acc.add_(g)  # in f32: acc + g.astype(f32)
                ce, aux = ce + m["ce"].detach(), aux + m["aux"].detach()
            for acc in grads:
                acc.div_(accum)
            loss = ce / accum
            metrics = {"ce": ce / accum, "aux": aux / accum}
        it = iter(grads)
        grads = tree_map(lambda _: next(it).contiguous(), params)
        with torch.no_grad():
            updates, opt_state = opt.update(grads, opt_state, params)
            params = apply_updates(params, updates)
        return params, opt_state, {"loss": loss.detach(),
                                   **{k: v.detach() for k, v in metrics.items()}}

    return train_step


def make_prefill_step(cfg: ModelConfig, max_len: int | None = None) -> Callable:
    """prefill_step(params, batch) -> (next_token (B,) int32, logits, cache);
    the next token is the greedy argmax (the first maximum on ties)."""

    def prefill_step(params, batch):
        logits, cache = prefill(params, cfg, batch, max_len=max_len)
        return torch.argmax(logits, dim=-1).to(torch.int32), logits, cache

    return prefill_step


def make_decode_step(cfg: ModelConfig) -> Callable:
    """serve_step(params, tokens (B, 1), cache) -> (next_token (B,) int32,
    cache'), the cache updated in place."""

    def serve_step(params, tokens, cache):
        logits, cache = decode_step(params, cfg, tokens, cache)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return serve_step
