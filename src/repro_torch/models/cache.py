"""Decode caches of the dense family (twin of the dense part of
``repro.models.cache``).

Layout: ``{"pos": () int32, "self": {"k", "v": (L, B, cap, KV, hd),
"slot_pos": (L, cap) int32}}``. The attention cache is a ring buffer of
``cap`` slots; ``slot_pos`` holds each slot's absolute position (-1 =
empty); ``cap`` is ``ModelConfig.window_for(seq_len)``; ``pos`` is the
absolute position of the next token.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.models.config import ModelConfig

Cache = dict


def require_dense(cfg: ModelConfig) -> None:
    """The port carries the dense family only so far."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet (ROADMAP.md, "
            "queue: the other LM families, after the training slice)")


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device: str | torch.device | None = None) -> Cache:
    """A zero cache: every slot empty, ``pos`` 0."""
    require_dense(cfg)
    dev = resolve_device(device)
    cap = cfg.window_for(seq_len)
    shape = (cfg.n_layers, batch, cap, cfg.n_kv_heads, cfg.head_dim)
    return {
        "pos": torch.zeros((), dtype=torch.int32, device=dev),
        "self": {
            "k": torch.zeros(shape, dtype=torch_dtype(cfg), device=dev),
            "v": torch.zeros(shape, dtype=torch_dtype(cfg), device=dev),
            "slot_pos": torch.full((cfg.n_layers, cap), -1, dtype=torch.int32, device=dev),
        },
    }
