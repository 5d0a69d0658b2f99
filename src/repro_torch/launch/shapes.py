"""The assigned input shapes and their abstract inputs (twin of
``repro.launch.shapes``).

``batch_inputs`` and ``decode_inputs`` return tensors on the ``meta``
device, the reference's ``ShapeDtypeStruct`` stand-ins: each has its
input's shape and dtype and no storage, so the 32k and 524k-token decode
caches of every config can be built on any machine. Decode shapes build the
cache for a ``seq_len`` context (``models.cache.abstract_cache``) and feed
ONE new token.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import cache as cache_mod
from repro_torch.models.config import ModelConfig

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def shape_skip_reason(cfg: ModelConfig, shape: ShapeSpec) -> str | None:
    """The documented skips: whisper has no 500k decoding horizon, and a
    full-attention model runs long_500k only through its sliding-window or
    long-context opt-in."""
    if shape.name == "long_500k":
        if cfg.family == "audio":
            return "enc-dec audio: 448-token decode horizon, no sub-quadratic variant"
        sub_quadratic = (
            cfg.family in ("hybrid", "ssm")
            or cfg.sliding_window > 0
            or cfg.long_context_window > 0
        )
        if not sub_quadratic:
            return "pure full attention cannot serve 524288 tokens"
    return None


def _meta(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_inputs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """The abstract batch of a train or prefill shape: tokens (B, S) int32;
    labels (B, S) int32 and weights (B,) f32 to train; media (B, M, D) in
    the model's dtype for the VLM and audio families."""
    b, s = shape.global_batch, shape.seq_len
    out = {"tokens": _meta((b, s), torch.int32)}
    if shape.kind == "train":
        out["labels"] = _meta((b, s), torch.int32)
        out["weights"] = _meta((b,), torch.float32)
    if cfg.family in ("vlm", "audio"):
        out["media"] = _meta((b, cfg.n_media_tokens, cfg.d_model), cache_mod.torch_dtype(cfg))
    return out


def decode_inputs(cfg: ModelConfig, shape: ShapeSpec) -> tuple[dict, dict]:
    """(tokens, cache), abstract, of a decode shape: one new token (B, 1)
    int32 against the cache of a ``seq_len`` context."""
    b, s = shape.global_batch, shape.seq_len
    return {"tokens": _meta((b, 1), torch.int32)}, cache_mod.abstract_cache(cfg, b, s)
