"""Step builders: the prefill and decode programs of the serving path
(twin of the serving part of ``repro.launch.steps``)."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import decode_step, prefill


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
