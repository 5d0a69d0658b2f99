"""Model assembly of the LM zoo (the dense, MoE, hybrid, VLM, audio and
xLSTM families): parameter schema, init, the train forward, prefill and
decode (twin of ``repro.models.transformer``).

``param_schema(cfg)`` is the one source of truth for parameter names and
shapes: a nested dict of ``Entry(shape, axes, init)`` with layers stacked
on a leading (L, ...) axis and weights laid out for ``x @ w``, as in the
reference, so ``convert.lm_params_from_numpy`` is a copy name for name.
The layer stack is a Python loop over the stacked tensors (the
reference's ``lax.scan``). In training, with ``cfg.remat``, each dense
layer runs under ``torch.utils.checkpoint``: by the reference's "full"
policy it keeps only its input, and under ``remat_policy="dots"`` also the
outputs of its batch-free matmuls (``_DOTS_SAVED``). Packed rows
(``segments``) train on the dense and MoE families. Prefill and decode
run under ``torch.inference_mode()``.

The MoE family (phi3.5-moe, dbrx) stacks layers of attention and
``layers.moe_ffn`` (``moe``: the router ``wr`` (D, E) and the experts'
``wg``, ``wu`` (E, D, F) and ``wd`` (E, F, D)); the train backbone sums
each layer's router aux loss into the loss (weighted by
``router_aux_weight``) and takes ``remat_policy`` as the dense one does;
prefill routes by the capacity-factor rule, decode with every token kept
(``capacity=-1``), as the reference does. ``forward_train``,
``backbone_train``, ``prefill`` and ``decode_step`` take ``mesh`` and
``batch_axes`` for ``moe_ffn``'s expert-parallel branch (the sharded
steps of ``launch.steps``).

The hybrid family (zamba2) scans groups of ``shared_attn_every`` Mamba2
layers, each group followed by the one shared attention + MLP block (the
same weights at every call), then the tail Mamba2 layers:
``groups.mamba`` is stacked (g, every, ...), ``tail`` (tail, ...), and
``shared`` is one unstacked dense layer. With ``cfg.remat`` each group
and each tail layer is checkpointed, as the reference's ``_scan`` does;
``remat_policy`` is not read there, as in the reference. The Mamba2
layers' ``a_log`` and ``dt_bias`` are f32 whatever ``cfg.dtype`` is.

The VLM family (llama-3.2-vision) scans groups of ``cross_attn_every - 1``
dense self layers, each group closed by a gated cross-attention layer
that reads the media (B, M, D): ``groups.self`` is stacked (g, spg, ...),
``groups.cross`` (g, ...) with the scalar gates ``gate_attn`` and
``gate_mlp`` (zero at init, so a fresh cross layer is the identity:
``tanh`` of the f32 gate, cast to the activations' dtype, scales its
attention and its MLP). With ``cfg.remat`` each group is checkpointed as
one; its self layers are not checkpointed apart. The audio family
(whisper) runs the encoder's bidirectional layers over the media (one
checkpoint a layer), ``enc_ln``, then decoder layers of causal self
attention, cross-attention to the encoder's output and the MLP (one
checkpoint a layer). Neither reads ``remat_policy``, as in the
reference. Prefill computes each cross layer's media K/V once (a group's,
or a decoder layer's) into the cache's ``media_k`` / ``media_v``; decode
reads them and never projects the media again.

The xLSTM family (``ssm``: xlstm-1.3b) scans groups of ``slstm_every - 1``
mLSTM layers, each group closed by one sLSTM layer (``models.xlstm``):
``groups.mlstm`` is stacked (g, mpg, ...), ``groups.slstm`` (g, ...).
With ``cfg.remat`` each group is checkpointed as one, with no policy, as
in the reference. Prefill returns each mLSTM layer's carry (C, n, m) and
each sLSTM layer's (c, n, m, h); decode writes them in place.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from repro_torch import collectives, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import xlstm as X
from repro_torch.models.cache import require_ported, torch_dtype
from repro_torch.models.config import ModelConfig

Params = dict


class Entry(NamedTuple):
    shape: tuple
    axes: tuple  # logical axis names, same length as shape
    init: str = "normal"  # normal | zeros | ones | alog | dtbias


# Entries kept in f32 whatever the model's dtype (the reference's
# ``abstract_params``).
F32_INITS = ("alog", "dtbias")


def entry_dtype(cfg: ModelConfig, e: Entry) -> torch.dtype:
    """The dtype of a parameter: f32 for ``a_log`` and ``dt_bias``, else the
    model's."""
    return torch.float32 if e.init in F32_INITS else torch_dtype(cfg)


# ------------------------------------------------------------------ schemas
def _attn_schema(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {
        "wq": Entry((d, cfg.q_dim), ("embed", "q_flat")),
        "wk": Entry((d, cfg.kv_dim), ("embed", "kv_flat")),
        "wv": Entry((d, cfg.kv_dim), ("embed", "kv_flat")),
        "wo": Entry((cfg.q_dim, d), ("q_flat", "embed")),
    }


def _mlp_schema(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "wg": Entry((d, f), ("embed", "ff")),
        "wu": Entry((d, f), ("embed", "ff")),
        "wd": Entry((f, d), ("ff", "embed")),
    }


def _moe_schema(cfg: ModelConfig) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "wr": Entry((d, e), ("embed", None)),
        "wg": Entry((e, d, f), ("experts", "embed", "ff")),
        "wu": Entry((e, d, f), ("experts", "embed", "ff")),
        "wd": Entry((e, f, d), ("experts", "ff", "embed")),
    }


def _mamba_schema(cfg: ModelConfig) -> dict:
    d, di, st, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    proj = 2 * di + 2 * st + nh
    conv_ch = di + 2 * st
    return {
        "in_proj": Entry((d, proj), ("embed", "inner_proj")),
        "conv_w": Entry((4, conv_ch), (None, "conv_ch")),
        "conv_b": Entry((conv_ch,), ("conv_ch",), "zeros"),
        "dt_bias": Entry((nh,), (None,), "dtbias"),
        "a_log": Entry((nh,), (None,), "alog"),
        "d_skip": Entry((nh,), (None,), "ones"),
        "norm": Entry((di,), ("inner",), "ones"),
        "out_proj": Entry((di, d), ("inner", "embed")),
        "ln": Entry((d,), ("embed",), "ones"),
    }


def _mlstm_schema(cfg: ModelConfig) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    return {
        "wq": Entry((d, d), ("embed", "q_flat")),
        "wk": Entry((d, d), ("embed", "q_flat")),
        "wv": Entry((d, d), ("embed", "q_flat")),
        "w_if": Entry((d, 2 * h), ("embed", None)),
        "b_if": Entry((2 * h,), (None,), "zeros"),
        "wo_gate": Entry((d, d), ("embed", "q_flat")),
        "wo": Entry((d, d), ("q_flat", "embed")),
        "ln": Entry((d,), ("embed",), "ones"),
    }


def _slstm_schema(cfg: ModelConfig) -> dict:
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    return {
        "w_gates": Entry((d, 4 * d), ("embed", "gates")),
        "b_gates": Entry((4 * d,), ("gates",), "zeros"),
        "r_gates": Entry((h, 4, hd, hd), (None, None, None, "head_dim")),
        "wo": Entry((d, d), ("q_flat", "embed")),
        "ln": Entry((d,), ("embed",), "ones"),
    }


def _dense_layer(cfg: ModelConfig) -> dict:
    return {
        "attn": _attn_schema(cfg),
        "mlp": _mlp_schema(cfg),
        "ln1": Entry((cfg.d_model,), ("embed",), "ones"),
        "ln2": Entry((cfg.d_model,), ("embed",), "ones"),
    }


def _moe_layer(cfg: ModelConfig) -> dict:
    return {
        "attn": _attn_schema(cfg),
        "moe": _moe_schema(cfg),
        "ln1": Entry((cfg.d_model,), ("embed",), "ones"),
        "ln2": Entry((cfg.d_model,), ("embed",), "ones"),
    }


def _cross_layer(cfg: ModelConfig) -> dict:
    return {
        "xattn": _attn_schema(cfg),
        "mlp": _mlp_schema(cfg),
        "ln1": Entry((cfg.d_model,), ("embed",), "ones"),
        "ln2": Entry((cfg.d_model,), ("embed",), "ones"),
        "gate_attn": Entry((), (), "zeros"),
        "gate_mlp": Entry((), (), "zeros"),
    }


def _decoder_layer(cfg: ModelConfig) -> dict:  # audio decoder: self + cross + mlp
    return {
        "attn": _attn_schema(cfg),
        "xattn": _attn_schema(cfg),
        "mlp": _mlp_schema(cfg),
        "ln1": Entry((cfg.d_model,), ("embed",), "ones"),
        "lnx": Entry((cfg.d_model,), ("embed",), "ones"),
        "ln2": Entry((cfg.d_model,), ("embed",), "ones"),
    }


def _stack(schema: dict, n: int) -> dict:
    return {
        k: _stack(v, n) if isinstance(v, dict)
        else Entry((n,) + v.shape, ("layers",) + v.axes, v.init)
        for k, v in schema.items()
    }


def hybrid_layout(cfg: ModelConfig) -> tuple[int, int, int]:
    """(groups, Mamba2 layers a group, tail layers) of a hybrid model."""
    every = cfg.shared_attn_every
    g = cfg.n_layers // every
    return g, every, cfg.n_layers - g * every


def vlm_layout(cfg: ModelConfig) -> tuple[int, int]:
    """(groups, self layers a group) of a VLM model: each group closes with
    one cross-attention layer."""
    return cfg.n_layers // cfg.cross_attn_every, cfg.cross_attn_every - 1


def xlstm_layout(cfg: ModelConfig) -> tuple[int, int]:
    """(groups, mLSTM layers a group) of an xLSTM model: each group closes
    with one sLSTM layer."""
    return cfg.n_layers // cfg.slstm_every, cfg.slstm_every - 1


def param_schema(cfg: ModelConfig) -> dict:
    require_ported(cfg)
    d, v = cfg.d_model, cfg.padded_vocab
    schema = {
        "embed": Entry((v, d), ("vocab", "embed")),
        "lm_head": Entry((d, v), ("embed", "vocab")),
        "final_norm": Entry((d,), ("embed",), "ones"),
    }
    if cfg.family in ("dense", "moe"):
        layer_schema = _dense_layer(cfg) if cfg.family == "dense" else _moe_layer(cfg)
        schema["layers"] = _stack(layer_schema, cfg.n_layers)
        return schema
    if cfg.family == "vlm":
        g, spg = vlm_layout(cfg)
        schema["groups"] = {"self": _stack(_stack(_dense_layer(cfg), spg), g),
                            "cross": _stack(_cross_layer(cfg), g)}
        return schema
    if cfg.family == "audio":
        schema["encoder"] = _stack(_dense_layer(cfg), cfg.encoder_layers)
        schema["decoder"] = _stack(_decoder_layer(cfg), cfg.n_layers)
        schema["enc_ln"] = Entry((d,), ("embed",), "ones")
        return schema
    if cfg.family == "hybrid":
        g, every, tail = hybrid_layout(cfg)
        schema["groups"] = {"mamba": _stack(_stack(_mamba_schema(cfg), every), g)}
        if tail:
            schema["tail"] = _stack(_mamba_schema(cfg), tail)
        schema["shared"] = _dense_layer(cfg)
        return schema
    g, mpg = xlstm_layout(cfg)
    schema["groups"] = {"mlstm": _stack(_stack(_mlstm_schema(cfg), mpg), g),
                        "slstm": _stack(_slstm_schema(cfg), g)}
    return schema


def map_schema(fn, schema: dict, path: tuple = ()) -> dict:
    """``fn(path, entry)`` over the schema's leaves, in its order."""
    return {
        k: map_schema(fn, v, path + (k,)) if isinstance(v, dict) else fn(path + (k,), v)
        for k, v in schema.items()
    }


# --------------------------------------------------------------------- init
def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device: str | torch.device | None = None) -> Params:
    """Random parameters in ``cfg.dtype``: normal weights scaled by
    1 / sqrt(fan_in) (fan_in = the second-to-last dim), drawn in f32 from
    ``generator`` (which must live on ``device``), in schema order; norms
    are ones. An entry of three dims or more (a stack of layers) is drawn
    one leading slice at a time into its output, so the f32 draw never
    holds more than one slice (a 16-layer phi3.5-moe expert entry is 27 GB
    in f32). A Mamba2 layer's ``a_log`` is log(1 + h % 15) + 0.5 for head
    h and its ``dt_bias`` -4, both f32, as the reference makes them."""
    dev = resolve_device(device)
    dt = torch_dtype(cfg)

    def make(path, e: Entry) -> torch.Tensor:
        if e.init == "zeros":
            return torch.zeros(e.shape, dtype=dt, device=dev)
        if e.init == "ones":
            return torch.ones(e.shape, dtype=dt, device=dev)
        if e.init == "alog":
            base = torch.log(1.0 + torch.arange(e.shape[-1], dtype=torch.float32,
                                                 device=dev) % 15)
            return (base + 0.5).expand(e.shape).contiguous()
        if e.init == "dtbias":
            return torch.full(e.shape, -4.0, dtype=torch.float32, device=dev)
        fan_in = e.shape[-2] if len(e.shape) >= 2 else e.shape[-1]
        scale = (1.0 / torch.sqrt(torch.tensor(float(max(fan_in, 1))))).to(dev)

        def draw(shape):
            return torch.randn(shape, generator=generator, dtype=torch.float32,
                               device=dev).mul_(scale)
        if len(e.shape) < 3:
            return draw(e.shape).to(dt)
        out = torch.empty(e.shape, dtype=dt, device=dev)
        for part in out:
            part.copy_(draw(e.shape[1:]))
        return out

    return map_schema(make, param_schema(cfg))


def abstract_params(cfg: ModelConfig) -> Params:
    """The parameters' blueprint: tensors on the ``meta`` device with each
    entry's shape and dtype and no storage (the reference's
    ``ShapeDtypeStruct`` leaves)."""
    return map_schema(lambda path, e: torch.empty(e.shape, dtype=entry_dtype(cfg, e),
                                                  device="meta"), param_schema(cfg))


def layer(stacked: dict, i: int) -> dict:
    """Layer ``i``'s slice of a stacked parameter or cache tree (views)."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i] for k, v in stacked.items()}


class LanguageModel(torch.nn.Module):
    """Holds a model's parameters as (frozen) module parameters whose
    ``state_dict`` names are the schema's paths ("layers.attn.wq"), and
    serves them through ``prefill`` and ``decode_step``. Each parameter
    must have its entry's shape and dtype (``entry_dtype``)."""

    def __init__(self, cfg: ModelConfig, params: Params):
        super().__init__()
        self.cfg = cfg
        self._paths = []

        def register(path, entry):
            owner = self
            for name in path[:-1]:
                if not hasattr(owner, name):
                    owner.add_module(name, torch.nn.Module())
                owner = getattr(owner, name)
            tensor = params
            for name in path:
                tensor = tensor[name]
            if (tuple(tensor.shape), tensor.dtype) != (entry.shape, entry_dtype(cfg, entry)):
                raise ValueError(f"{'.'.join(path)}: {tuple(tensor.shape)} {tensor.dtype}, "
                                 f"expected {entry.shape} {entry_dtype(cfg, entry)}")
            owner.register_parameter(path[-1], torch.nn.Parameter(tensor, requires_grad=False))
            self._paths.append(path)

        map_schema(register, param_schema(cfg))

    @property
    def params(self) -> Params:
        """The nested parameter dict the functions of this module take."""
        out: dict = {}
        for path in self._paths:
            node, owner = out, self
            for name in path[:-1]:
                node = node.setdefault(name, {})
                owner = getattr(owner, name)
            node[path[-1]] = getattr(owner, path[-1])
        return out

    def prefill(self, batch: dict, max_len: int | None = None):
        return prefill(self.params, self.cfg, batch, max_len)

    def decode_step(self, tokens: torch.Tensor, cache: dict):
        return decode_step(self.params, self.cfg, tokens, cache)


# ------------------------------------------------------------ train forward
def _dense_block(p: dict, x: torch.Tensor, cfg: ModelConfig, window: int,
                 segments: torch.Tensor | None = None) -> torch.Tensor:
    x = x + L.self_attention_train(p["attn"], L.rms_norm(x, p["ln1"]), cfg, window,
                                   segments=segments)
    return x + L.mlp(p["mlp"], L.rms_norm(x, p["ln2"]))


def _moe_block(p: dict, x: torch.Tensor, cfg: ModelConfig, window: int,
               segments: torch.Tensor | None = None, mesh=None,
               batch_axes: tuple = ("data",)) -> tuple[torch.Tensor, torch.Tensor]:
    x = x + L.self_attention_train(p["attn"], L.rms_norm(x, p["ln1"]), cfg, window,
                                   segments=segments)
    out, aux = L.moe_ffn(p["moe"], L.rms_norm(x, p["ln2"]), cfg, mesh, batch_axes)
    return x + out, aux


def _mamba_block(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return x + S.mamba2_train(p, L.rms_norm(x, p["ln"]), cfg)


def _hybrid_group(ps: list, x: torch.Tensor, shared: dict, cfg: ModelConfig,
                  window: int) -> torch.Tensor:
    """One group: its Mamba2 layers, then the shared block."""
    for p in ps:
        x = _mamba_block(p, x, cfg)
    return _dense_block(shared, x, cfg, window)


def _cross_block(p: dict, x: torch.Tensor, media, cfg: ModelConfig) -> torch.Tensor:
    """A gated cross-attention layer: ``media`` is (B, M, D), or a cached
    ``(k, v)`` pair; each gate is ``tanh`` of the f32 scalar in x's dtype."""
    g1 = torch.tanh(p["gate_attn"].float()).to(x.dtype)
    g2 = torch.tanh(p["gate_mlp"].float()).to(x.dtype)
    x = x + g1 * L.cross_attention(p["xattn"], L.rms_norm(x, p["ln1"]), media, cfg)
    return x + g2 * L.mlp(p["mlp"], L.rms_norm(x, p["ln2"]))


def _vlm_group(ps: list, cross: dict, x: torch.Tensor, media: torch.Tensor,
               cfg: ModelConfig, window: int) -> torch.Tensor:
    """One VLM group: its self layers, then its gated cross layer."""
    for p in ps:
        x = _dense_block(p, x, cfg, window)
    return _cross_block(cross, x, media, cfg)


def _xlstm_group(ps: list, sp: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """One xLSTM group: its mLSTM layers, then its sLSTM layer."""
    for p in ps:
        x = x + X.mlstm_train(p, L.rms_norm(x, p["ln"]), cfg)
    return x + X.slstm_train(sp, L.rms_norm(x, sp["ln"]), cfg)


def _enc_block(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = x + L.encoder_attention(p["attn"], L.rms_norm(x, p["ln1"]), cfg)
    return x + L.mlp(p["mlp"], L.rms_norm(x, p["ln2"]))


def _dec_block(p: dict, x: torch.Tensor, enc, cfg: ModelConfig, window: int) -> torch.Tensor:
    """An audio decoder layer: causal self-attention, cross-attention to
    ``enc`` (the encoder's output, or a cached ``(k, v)`` pair), the MLP."""
    x = x + L.self_attention_train(p["attn"], L.rms_norm(x, p["ln1"]), cfg, window)
    x = x + L.cross_attention(p["xattn"], L.rms_norm(x, p["lnx"]), enc, cfg)
    return x + L.mlp(p["mlp"], L.rms_norm(x, p["ln2"]))


def unstack(stacked: dict) -> list[dict]:
    """Every layer's tree of a stacked (L, ...) tree, split once by
    ``torch.unbind``: its backward is one ``stack`` a leaf, where L indexing
    views would each give a zero-filled (L, ...) gradient."""
    split = {k: unstack(v) if isinstance(v, dict) else torch.unbind(v, 0)
             for k, v in stacked.items()}
    n = len(next(iter(split.values())))
    return [{k: v[i] for k, v in split.items()} for i in range(n)]


# The "dots" policy (the reference's ``dots_with_no_batch_dims_saveable``):
# the outputs of matmuls without a batch dimension are kept. ``x @ W`` of a
# (B, S, D) x reaches the dispatcher as an ``mm`` of the flattened rows (q,
# k, v, o, gate, up, down), as do the MoE router's product and each
# expert's three (2-D on its (C, D) tokens); the attention's einsums are
# ``bmm``s, which keep a batch dimension, and are recomputed with
# everything else, the flash kernels (launched out of the dispatcher's
# sight) included.
_DOTS_SAVED = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]


def _dots_contexts():
    return create_selective_checkpoint_contexts(_DOTS_SAVED)


def _maybe_checkpoint(cfg: ModelConfig, fn, *args, policy: str = "full"):
    """``fn(*args)``, under activation checkpointing when ``cfg.remat``:
    ``policy="dots"`` saves ``_DOTS_SAVED``'s outputs, any other value
    recomputes the whole of ``fn`` ("full"), as in the reference."""
    if not cfg.remat:
        return fn(*args)
    if policy == "dots":
        return checkpoint(fn, *args, use_reentrant=False, context_fn=_dots_contexts)
    return checkpoint(fn, *args, use_reentrant=False)


def backbone_train(params: Params, cfg: ModelConfig, x: torch.Tensor,
                   segments: torch.Tensor | None = None,
                   media: torch.Tensor | None = None, mesh=None,
                   batch_axes: tuple = ("data",)) -> tuple[torch.Tensor, torch.Tensor]:
    """Hidden states (B, S, D) of the teacher-forced sequence, and the MoE
    aux loss (the sum of the layers' router losses; 0 for the other
    families), from embedded tokens x (B, S, D). ``segments`` (B, S),
    packed-document ids (0 = padding), mask the dense and MoE families'
    attention; their layers read ``cfg.remat_policy`` ("dots", or anything
    else for "full"), the other families' do not. ``media`` (B, M, D) is
    what the VLM's cross layers and whisper's encoder read. ``mesh`` and
    ``batch_axes`` go to ``layers.moe_ffn`` (x is then this rank's block of
    the batch over ``batch_axes``); the other layers run on this rank's
    rows alone."""
    require_ported(cfg)
    window = cfg.window_for(x.shape[1])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "moe":
        for p in unstack(params["layers"]):
            x, a = _maybe_checkpoint(cfg, _moe_block, p, x, cfg, window, segments, mesh,
                                     batch_axes, policy=cfg.remat_policy)
            aux = aux + a
    elif cfg.family == "vlm":  # one checkpoint a group, no policy (the reference's)
        for group in unstack(params["groups"]):
            x = _maybe_checkpoint(cfg, _vlm_group, unstack(group["self"]), group["cross"], x,
                                  media, cfg, window)
    elif cfg.family == "audio":  # the encoder over the media, one checkpoint a layer
        enc = media
        for p in unstack(params["encoder"]):
            enc = _maybe_checkpoint(cfg, _enc_block, p, enc, cfg)
        enc = L.rms_norm(enc, params["enc_ln"])
        for p in unstack(params["decoder"]):
            x = _maybe_checkpoint(cfg, _dec_block, p, x, enc, cfg, window)
    elif cfg.family == "hybrid":  # the reference's hybrid branch takes no policy
        for group in unstack(params["groups"]["mamba"]):
            x = _maybe_checkpoint(cfg, _hybrid_group, unstack(group), x, params["shared"],
                                  cfg, window)
        for p in unstack(params["tail"]) if "tail" in params else ():
            x = _maybe_checkpoint(cfg, _mamba_block, p, x, cfg)
    elif cfg.family == "ssm":  # one checkpoint a group, no policy (the reference's)
        for group in unstack(params["groups"]):
            x = _maybe_checkpoint(cfg, _xlstm_group, unstack(group["mlstm"]), group["slstm"],
                                  x, cfg)
    else:
        for p in unstack(params["layers"]):
            x = _maybe_checkpoint(cfg, _dense_block, p, x, cfg, window, segments,
                                  policy=cfg.remat_policy)
    return x, aux


def forward_train(params: Params, cfg: ModelConfig, batch: dict, mesh=None,
                  batch_axes: tuple = ("data",)) -> tuple[torch.Tensor, dict]:
    """Teacher-forced LM loss. batch: tokens (B, S), labels (B, S),
    [media (B, M, D) — the VLM's and whisper's frontend embeddings],
    [segments (B, S) — packed-document ids, 0 = padding, dense and MoE],
    [weights (B,) — Bernoulli importance weights m'_i / R, the paper's
    sampled objective lifted to sequence level]. Returns (loss, {"ce",
    "aux"}). Logits are taken in ``cfg.dtype``, -1e9 past the vocab, then
    cast to f32; the loss is logsumexp - gold, averaged per sequence, pad
    positions included, as in the reference. Packed rows run the chunked
    attention even under ``attn_impl="flash"``
    (``layers.self_attention_train``); the other families raise
    ``ValueError`` for them, as the reference does.

    On a mesh (``launch.steps.make_train_step``) the batch is this rank's
    block over ``batch_axes`` and the loss, ce and aux are the global
    batch's: ce's numerator and denominator are summed over the batch
    shards (``collectives.reduce_from``: each rank's gradient is then its
    share of the global one, which the step sums)."""
    require_ported(cfg)
    segments = batch.get("segments")
    if segments is not None and cfg.family not in ("dense", "moe"):
        raise ValueError(
            "packed segments need attention masking; recurrent families "
            "would need per-segment state resets (not implemented)")
    x = params["embed"][batch["tokens"].long()]
    x, aux = backbone_train(params, cfg, x, segments, batch.get("media"), mesh, batch_axes)
    logits = _logits(params, cfg, x).float()  # (B, S, Vpad)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, batch["labels"].long()[..., None])[..., 0]
    per_seq = (logz - gold).mean(dim=-1)  # (B,)
    w = batch.get("weights")
    shards = tuple(mesh.axis(a) for a in batch_axes
                   if mesh.axis(a).size > 1) if mesh is not None else ()
    if not shards and w is None:
        ce = per_seq.mean()
    elif not shards:
        ce = (w * per_seq).sum() / torch.clamp(w.sum(), min=1e-6)
    elif w is None:
        rows = per_seq.shape[0] * math.prod(a.size for a in shards)
        ce = collectives.reduce_from(per_seq.sum() / rows, shards, "loss.ce")
    else:
        total = torch.clamp(collectives.psum(w.sum(), shards, "loss.weights"), min=1e-6)
        ce = collectives.reduce_from((w * per_seq).sum() / total, shards, "loss.ce")
    loss = ce + cfg.router_aux_weight * aux
    return loss, {"ce": ce, "aux": aux}


# ------------------------------------------------------------ serving paths
def _logits(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """(B, S, D) hidden -> (B, S, Vpad) logits, -1e9 past the vocab."""
    logits = L.rms_norm(x, params["final_norm"]) @ params["lm_head"]
    mask = torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab_size
    return logits.masked_fill(~mask, -1e9)


def _ring_from_kv(ks: torch.Tensor, vs: torch.Tensor, cap: int) -> dict:
    """Stacked full-sequence K/V (L, B, S, KV, hd) -> a ring cache of ``cap``
    slots a layer (slot of position p = p % cap).
    cap >= S: positions 0..S-1 land in slots 0..S-1, the rest stay empty —
    full attention with decode headroom. cap < S (sliding window): the last
    ``cap`` positions are kept; requires cap | S so the ring alignment
    (slot = pos % cap) holds. Every leaf is its own contiguous tensor, so
    decode can write it in place.
    """
    nl, s = ks.shape[0], ks.shape[2]
    if cap >= s:
        pad = (0, 0, 0, 0, 0, cap - s)
        idx = torch.arange(cap, dtype=torch.int32, device=ks.device)
        slot = torch.where(idx < s, idx, -1)
        return {
            "k": torch.nn.functional.pad(ks, pad),
            "v": torch.nn.functional.pad(vs, pad),
            "slot_pos": slot.expand(nl, cap).contiguous(),
        }
    if s % cap:
        raise ValueError("ring capacity must divide prefill length")
    slot = torch.arange(cap, dtype=torch.int32, device=ks.device) + (s - cap)
    return {
        "k": ks[:, :, s - cap:].contiguous(),
        "v": vs[:, :, s - cap:].contiguous(),
        "slot_pos": slot.expand(nl, cap).contiguous(),
    }


def _ffn(p: dict, x: torch.Tensor, cfg: ModelConfig, capacity: int | None = None,
         mesh=None, batch_axes: tuple = ("data",)):
    """A serving layer's feed-forward part: the MoE FFN (its aux dropped) on
    a layer that has one, else the MLP."""
    if "moe" in p:
        return L.moe_ffn(p["moe"], x, cfg, mesh, batch_axes, capacity=capacity)[0]
    return L.mlp(p["mlp"], x)


@torch.inference_mode()
def prefill(params: Params, cfg: ModelConfig, batch: dict, max_len: int | None = None,
            mesh=None, batch_axes: tuple = ("data",)) -> tuple[torch.Tensor, dict]:
    """Score the prompt and build the decode cache. batch: tokens (B, S),
    [media (B, M, D): the VLM's and whisper's frontend embeddings].
    ``max_len`` is the total context budget (prompt + decode headroom);
    the attention cache capacity is ``cfg.window_for(max_len)``. Returns
    (last-position logits (B, Vpad), cache) in the ``models.cache`` layout.
    ``mesh`` and ``batch_axes`` go to ``layers.moe_ffn``, as in
    ``backbone_train``.
    """
    require_ported(cfg)
    tokens = batch["tokens"]
    s = tokens.shape[1]
    x = params["embed"][tokens.long()]
    cap = cfg.window_for(max_len if max_len is not None else s)
    window = cfg.window_for(s)
    ks, vs = [], []

    def self_attn(p, x):
        a, (k, v) = L.self_attention_train(
            p["attn"], L.rms_norm(x, p["ln1"]), cfg, window, return_kv=True)
        ks.append(k)
        vs.append(v)
        return x + a

    def attn_block(p, x):
        x = self_attn(p, x)
        return x + _ffn(p, L.rms_norm(x, p["ln2"]), cfg, mesh=mesh, batch_axes=batch_axes)

    cache: dict = {"pos": torch.tensor(s, dtype=torch.int32, device=x.device)}
    if cfg.family in ("dense", "moe"):
        for i in range(cfg.n_layers):
            x = attn_block(layer(params["layers"], i), x)
        cache["self"] = _ring_from_kv(torch.stack(ks), torch.stack(vs), cap)
        return _logits(params, cfg, x[:, -1:, :])[:, 0], cache

    if cfg.family in ("vlm", "audio"):
        media, mks, mvs = batch["media"], [], []

        def media_kv(p_attn, src):  # once a cross layer: the cache's media K/V
            mks.append((src @ p_attn["wk"]).reshape(
                src.shape[0], src.shape[1], cfg.n_kv_heads, cfg.head_dim))
            mvs.append((src @ p_attn["wv"]).reshape(
                src.shape[0], src.shape[1], cfg.n_kv_heads, cfg.head_dim))
            return mks[-1], mvs[-1]

        if cfg.family == "vlm":
            g, spg = vlm_layout(cfg)
            for i in range(g):
                group = layer(params["groups"], i)
                for j in range(spg):
                    x = attn_block(layer(group["self"], j), x)
                x = _cross_block(group["cross"], x, media_kv(group["cross"]["xattn"], media),
                                 cfg)
        else:
            enc = media
            for i in range(cfg.encoder_layers):
                enc = _enc_block(layer(params["encoder"], i), enc, cfg)
            enc = L.rms_norm(enc, params["enc_ln"])
            for i in range(cfg.n_layers):
                p = layer(params["decoder"], i)
                x = self_attn(p, x)
                x = x + L.cross_attention(p["xattn"], L.rms_norm(x, p["lnx"]),
                                          media_kv(p["xattn"], enc), cfg)
                x = x + L.mlp(p["mlp"], L.rms_norm(x, p["ln2"]))
        cache["self"] = _ring_from_kv(torch.stack(ks), torch.stack(vs), cap)
        cache["media_k"], cache["media_v"] = torch.stack(mks), torch.stack(mvs)
        return _logits(params, cfg, x[:, -1:, :])[:, 0], cache

    if cfg.family == "hybrid":
        states, convs = [], []

        def mamba(p, x):
            out, h, conv = S.mamba2_train(p, L.rms_norm(x, p["ln"]), cfg, return_state=True)
            states.append(h)
            convs.append(conv)
            return x + out

        g, every, tail = hybrid_layout(cfg)
        for i in range(g):
            group = layer(params["groups"]["mamba"], i)
            for j in range(every):
                x = mamba(layer(group, j), x)
            x = attn_block(params["shared"], x)
        for i in range(tail):
            x = mamba(layer(params["tail"], i), x)
        cache["ssm"] = torch.stack(states)
        cache["conv"] = torch.stack(convs)
        cache["shared"] = _ring_from_kv(torch.stack(ks), torch.stack(vs), cap)
        return _logits(params, cfg, x[:, -1:, :])[:, 0], cache

    g, mpg = xlstm_layout(cfg)  # the ssm family (xLSTM)
    mstates, sstates = [], []
    for i in range(g):
        group = layer(params["groups"], i)
        for j in range(mpg):
            p = layer(group["mlstm"], j)
            out, state = X.mlstm_train(p, L.rms_norm(x, p["ln"]), cfg, return_state=True)
            mstates.append(state)
            x = x + out
        sp = group["slstm"]
        out, state = X.slstm_train(sp, L.rms_norm(x, sp["ln"]), cfg, return_state=True)
        sstates.append(state)
        x = x + out

    def stacked(states, k, lead):  # carry part k of every layer, (lead..., B, ...)
        out = torch.stack([s[k] for s in states])
        return out.reshape(lead + out.shape[1:])
    cache["mlstm"] = {n: stacked(mstates, k, (g, mpg)) for k, n in enumerate("cnm")}
    cache["slstm"] = {n: stacked(sstates, k, (g,)) for k, n in enumerate("cnmh")}
    return _logits(params, cfg, x[:, -1:, :])[:, 0], cache


@torch.inference_mode()
def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor, cache: dict,
                mesh=None, batch_axes: tuple = ("data",)) -> tuple[torch.Tensor, dict]:
    """One token (B, 1) against the cache -> (logits (B, Vpad), cache').
    ``mesh`` and ``batch_axes`` go to ``layers.moe_ffn`` (the sharded
    decode step passes ``batch_axes=()``: every rank holds every row).

    The cache is updated in place (each attention layer writes the slot of
    ``pos``, each Mamba2 layer its state and conv rows, each mLSTM and
    sLSTM layer its carry) and returned with
    ``pos`` advanced; the reference returns a new cache and leaves the old
    one as it was. The cross layers read the cached media K/V (the VLM's
    g x spg self layers index the flat ring group-major).
    """
    require_ported(cfg)
    x = params["embed"][tokens.long()]  # (B, 1, D)
    pos = cache["pos"]
    ring = cache.get("shared", cache.get("self"))  # the attention ring, if any

    def self_attn(p, x, i):
        out, _, _, _ = L.self_attention_decode(
            p["attn"], L.rms_norm(x, p["ln1"]), ring["k"][i], ring["v"][i],
            ring["slot_pos"][i], pos, cfg, ring["k"].shape[2])
        return x + out

    def attn_block(p, x, i):
        x = self_attn(p, x, i)
        return x + _ffn(p, L.rms_norm(x, p["ln2"]), cfg, capacity=-1, mesh=mesh,
                        batch_axes=batch_axes)

    def media(i):
        return cache["media_k"][i], cache["media_v"][i]

    def mamba(p, x, i):
        out, st, cv = S.mamba2_decode(p, L.rms_norm(x, p["ln"]), cache["ssm"][i],
                                      cache["conv"][i], cfg)
        cache["ssm"][i].copy_(st)
        cache["conv"][i].copy_(cv)
        return x + out

    if cfg.family in ("dense", "moe"):
        for i in range(cfg.n_layers):
            x = attn_block(layer(params["layers"], i), x, i)
    elif cfg.family == "vlm":
        g, spg = vlm_layout(cfg)
        for i in range(g):
            group = layer(params["groups"], i)
            for j in range(spg):
                x = attn_block(layer(group["self"], j), x, i * spg + j)
            x = _cross_block(group["cross"], x, media(i), cfg)
    elif cfg.family == "audio":
        for i in range(cfg.n_layers):
            p = layer(params["decoder"], i)
            x = self_attn(p, x, i)
            x = x + L.cross_attention(p["xattn"], L.rms_norm(x, p["lnx"]), media(i), cfg)
            x = x + L.mlp(p["mlp"], L.rms_norm(x, p["ln2"]))
    elif cfg.family == "hybrid":
        g, every, tail = hybrid_layout(cfg)
        for i in range(g):
            group = layer(params["groups"]["mamba"], i)
            for j in range(every):
                x = mamba(layer(group, j), x, i * every + j)
            x = attn_block(params["shared"], x, i)
        for i in range(tail):
            x = mamba(layer(params["tail"], i), x, g * every + i)
    elif cfg.family == "ssm":
        g, mpg = xlstm_layout(cfg)
        mc, sc = cache["mlstm"], cache["slstm"]
        for i in range(g):
            group = layer(params["groups"], i)
            for j in range(mpg):
                p = layer(group["mlstm"], j)
                out, *state = X.mlstm_decode(p, L.rms_norm(x, p["ln"]), mc["c"][i, j],
                                             mc["n"][i, j], mc["m"][i, j], cfg)
                for n, t in zip("cnm", state):
                    mc[n][i, j].copy_(t)
                x = x + out
            sp = group["slstm"]
            out, *state = X.slstm_decode(sp, L.rms_norm(x, sp["ln"]), sc["c"][i], sc["n"][i],
                                         sc["m"][i], sc["h"][i], cfg)
            for n, t in zip("cnmh", state):
                sc[n][i].copy_(t)
            x = x + out
    else:
        raise ValueError(cfg.family)
    cache["pos"] = pos + 1
    return _logits(params, cfg, x)[:, 0], cache
