"""Decode caches of every family of the LM zoo (twin of
``repro.models.cache``).

Dense and MoE layout: ``{"pos": () int32, "self": {"k", "v": (L, B, cap, KV, hd),
"slot_pos": (L, cap) int32}}``. The attention cache is a ring buffer of
``cap`` slots; ``slot_pos`` holds each slot's absolute position (-1 =
empty); ``cap`` is ``ModelConfig.window_for(seq_len)``; ``pos`` is the
absolute position of the next token.

Hybrid layout (zamba2): ``{"pos", "ssm": (L, B, nh, hp, st), "conv": (L,
B, 3, conv channels), "shared": the ring above over ``L //
shared_attn_every`` slots}``: each Mamba2 layer's recurrent state and its
last three conv inputs, and each invocation of the shared attention
block's K/V. All in the model's dtype.

VLM layout (llama-3.2-vision): ``{"pos", "self": the ring above over the
g x spg self layers, group-major (g = n_layers / cross_attn_every groups
of spg = cross_attn_every - 1), "media_k", "media_v": (g, B, M, KV,
hd)}``: each group's cross layer's K/V of the media, computed once at
prefill. Audio layout (whisper): ``{"pos", "self": the ring over the
decoder's layers, "media_k", "media_v": (L, B, M, KV, hd)}``: each decoder
layer's K/V of the encoder's output.

xLSTM layout (``ssm``): ``{"pos", "mlstm": {"c": (g, mpg, B, H, hd, hd),
"n": (g, mpg, B, H, hd), "m": (g, mpg, B, H) f32}, "slstm": {"c", "n",
"h": (g, B, H, hd), "m": (g, B, H, hd) f32}}`` (g = n_layers /
slstm_every groups of mpg = slstm_every - 1 mLSTM layers and one sLSTM
layer): each layer's recurrent carry, the matrix memory C and its
normaliser n pre-scaled by exp(-m), in the model's dtype but the
stabilisers m. It does not grow with the context.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.models.config import ModelConfig

Cache = dict

PORTED_FAMILIES = ("dense", "moe", "hybrid", "vlm", "audio", "ssm")


def require_ported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a family the LM zoo does not have (the
    reference's ``raise ValueError(fam)``)."""
    if cfg.family not in PORTED_FAMILIES:
        raise ValueError(f"{cfg.name}: unknown model family {cfg.family!r}")


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _ring(n: int, batch: int, cap: int, cfg: ModelConfig, dev: torch.device) -> dict:
    shape = (n, batch, cap, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=torch_dtype(cfg), device=dev),
        "v": torch.zeros(shape, dtype=torch_dtype(cfg), device=dev),
        "slot_pos": torch.full((n, cap), -1, dtype=torch.int32, device=dev),
    }


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device: str | torch.device | None = None) -> Cache:
    """A zero cache: every slot empty, every state zero, ``pos`` 0."""
    require_ported(cfg)
    dev = resolve_device(device)
    cap = cfg.window_for(seq_len)
    cache: Cache = {"pos": torch.zeros((), dtype=torch.int32, device=dev)}
    dt = torch_dtype(cfg)
    if cfg.family in ("dense", "moe"):
        cache["self"] = _ring(cfg.n_layers, batch, cap, cfg, dev)
        return cache
    if cfg.family in ("vlm", "audio"):
        if cfg.family == "vlm":
            g = cfg.n_layers // cfg.cross_attn_every
            n_self, n_media = g * (cfg.cross_attn_every - 1), g
        else:
            n_self = n_media = cfg.n_layers
        cache["self"] = _ring(n_self, batch, cap, cfg, dev)
        media = (n_media, batch, cfg.n_media_tokens, cfg.n_kv_heads, cfg.head_dim)
        cache["media_k"] = torch.zeros(media, dtype=dt, device=dev)
        cache["media_v"] = torch.zeros(media, dtype=dt, device=dev)
        return cache
    if cfg.family == "hybrid":
        conv_ch = cfg.d_inner + 2 * cfg.ssm_state
        cache["ssm"] = torch.zeros(
            (cfg.n_layers, batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
            dtype=dt, device=dev)
        cache["conv"] = torch.zeros((cfg.n_layers, batch, 3, conv_ch), dtype=dt, device=dev)
        cache["shared"] = _ring(cfg.n_layers // cfg.shared_attn_every, batch, cap, cfg, dev)
        return cache
    g, mpg = cfg.n_layers // cfg.slstm_every, cfg.slstm_every - 1
    h, hd = cfg.n_heads, cfg.head_dim

    def zeros(shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)
    cache["mlstm"] = {"c": zeros((g, mpg, batch, h, hd, hd)),
                      "n": zeros((g, mpg, batch, h, hd)),
                      "m": zeros((g, mpg, batch, h), torch.float32)}
    state = (g, batch, h, hd)
    cache["slstm"] = {"c": zeros(state), "n": zeros(state), "m": zeros(state, torch.float32),
                      "h": zeros(state)}
    return cache


def cache_structure(cfg: ModelConfig, batch: int, seq_len: int) -> Cache:
    """The cache's blueprint: ``init_cache`` on the ``meta`` device, leaves
    with shapes and dtypes and no storage (the reference's
    ``ShapeDtypeStruct`` leaves)."""
    return init_cache(cfg, batch, seq_len, device="meta")


def abstract_cache(cfg: ModelConfig, batch: int, seq_len: int) -> Cache:
    """The cache's blueprint (``cache_structure``), as the dry runs take it."""
    return cache_structure(cfg, batch, seq_len)
