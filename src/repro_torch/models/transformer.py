"""Model assembly of the dense family: parameter schema, init, the train
forward, prefill and decode (twin of the dense part of
``repro.models.transformer``).

``param_schema(cfg)`` is the one source of truth for parameter names and
shapes: a nested dict of ``Entry(shape, axes, init)`` with layers stacked
on a leading (L, ...) axis and weights laid out for ``x @ w``, as in the
reference, so ``convert.lm_params_from_numpy`` is a copy name for name.
The layer stack is a Python loop over the stacked tensors (the
reference's ``lax.scan``). In training, with ``cfg.remat``, each layer
runs under ``torch.utils.checkpoint`` (the reference's "full" remat
policy). Prefill and decode run under ``torch.inference_mode()``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.cache import require_dense, torch_dtype
from repro_torch.models.config import ModelConfig

Params = dict


class Entry(NamedTuple):
    shape: tuple
    axes: tuple  # logical axis names, same length as shape
    init: str = "normal"  # normal | zeros | ones


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


def _dense_layer(cfg: ModelConfig) -> dict:
    return {
        "attn": _attn_schema(cfg),
        "mlp": _mlp_schema(cfg),
        "ln1": Entry((cfg.d_model,), ("embed",), "ones"),
        "ln2": Entry((cfg.d_model,), ("embed",), "ones"),
    }


def _stack(schema: dict, n: int) -> dict:
    return {
        k: _stack(v, n) if isinstance(v, dict)
        else Entry((n,) + v.shape, ("layers",) + v.axes, v.init)
        for k, v in schema.items()
    }


def param_schema(cfg: ModelConfig) -> dict:
    require_dense(cfg)
    d, v = cfg.d_model, cfg.padded_vocab
    return {
        "embed": Entry((v, d), ("vocab", "embed")),
        "lm_head": Entry((d, v), ("embed", "vocab")),
        "final_norm": Entry((d,), ("embed",), "ones"),
        "layers": _stack(_dense_layer(cfg), cfg.n_layers),
    }


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
    are ones."""
    dev = resolve_device(device)
    dt = torch_dtype(cfg)

    def make(path, e: Entry) -> torch.Tensor:
        if e.init == "zeros":
            return torch.zeros(e.shape, dtype=dt, device=dev)
        if e.init == "ones":
            return torch.ones(e.shape, dtype=dt, device=dev)
        fan_in = e.shape[-2] if len(e.shape) >= 2 else e.shape[-1]
        scale = 1.0 / torch.sqrt(torch.tensor(float(max(fan_in, 1))))
        w = torch.randn(e.shape, generator=generator, dtype=torch.float32, device=dev)
        return (w * scale.to(dev)).to(dt)

    return map_schema(make, param_schema(cfg))


def layer(stacked: dict, i: int) -> dict:
    """Layer ``i``'s slice of a stacked parameter or cache tree (views)."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i] for k, v in stacked.items()}


class LanguageModel(torch.nn.Module):
    """Holds a dense model's parameters as (frozen) module parameters whose
    ``state_dict`` names are the schema's paths ("layers.attn.wq"), and
    serves them through ``prefill`` and ``decode_step``."""

    def __init__(self, cfg: ModelConfig, params: Params):
        super().__init__()
        self.cfg = cfg
        self._paths = []

        def register(path, _entry):
            owner = self
            for name in path[:-1]:
                if not hasattr(owner, name):
                    owner.add_module(name, torch.nn.Module())
                owner = getattr(owner, name)
            tensor = params
            for name in path:
                tensor = tensor[name]
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
def _dense_block(p: dict, x: torch.Tensor, cfg: ModelConfig, window: int) -> torch.Tensor:
    x = x + L.self_attention_train(p["attn"], L.rms_norm(x, p["ln1"]), cfg, window)
    return x + L.mlp(p["mlp"], L.rms_norm(x, p["ln2"]))


def unstack(stacked: dict) -> list[dict]:
    """Every layer's tree of a stacked (L, ...) tree, split once by
    ``torch.unbind``: its backward is one ``stack`` a leaf, where L indexing
    views would each give a zero-filled (L, ...) gradient."""
    split = {k: unstack(v) if isinstance(v, dict) else torch.unbind(v, 0)
             for k, v in stacked.items()}
    n = len(next(iter(split.values())))
    return [{k: v[i] for k, v in split.items()} for i in range(n)]


def backbone_train(params: Params, cfg: ModelConfig,
                   x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Hidden states (B, S, D) of the teacher-forced sequence, and the MoE
    aux loss (0 for the dense family), from embedded tokens x (B, S, D)."""
    require_dense(cfg)
    if cfg.remat and cfg.remat_policy != "full":
        raise NotImplementedError(
            f"remat_policy={cfg.remat_policy!r}: only the 'full' policy is ported "
            "(ROADMAP.md, queue: remat_policy='dots')")
    window = cfg.window_for(x.shape[1])
    for p in unstack(params["layers"]):
        if cfg.remat:
            x = checkpoint(_dense_block, p, x, cfg, window, use_reentrant=False)
        else:
            x = _dense_block(p, x, cfg, window)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def forward_train(params: Params, cfg: ModelConfig,
                  batch: dict) -> tuple[torch.Tensor, dict]:
    """Teacher-forced LM loss. batch: tokens (B, S), labels (B, S),
    [weights (B,) — Bernoulli importance weights m'_i / R, the paper's
    sampled objective lifted to sequence level]. Returns (loss, {"ce",
    "aux"}). Logits are taken in ``cfg.dtype``, -1e9 past the vocab, then
    cast to f32; the loss is logsumexp - gold, averaged per sequence."""
    require_dense(cfg)
    if batch.get("segments") is not None:
        raise NotImplementedError("packed segments are not ported yet (ROADMAP.md, queue: "
                                  "segments and data/pipeline.py)")
    x = params["embed"][batch["tokens"].long()]
    x, aux = backbone_train(params, cfg, x)
    logits = _logits(params, cfg, x).float()  # (B, S, Vpad)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, batch["labels"].long()[..., None])[..., 0]
    per_seq = (logz - gold).mean(dim=-1)  # (B,)
    w = batch.get("weights")
    if w is None:
        ce = per_seq.mean()
    else:
        ce = (w * per_seq).sum() / torch.clamp(w.sum(), min=1e-6)
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


@torch.inference_mode()
def prefill(params: Params, cfg: ModelConfig, batch: dict,
            max_len: int | None = None) -> tuple[torch.Tensor, dict]:
    """Score the prompt and build the decode cache. batch: tokens (B, S).
    ``max_len`` is the total context budget (prompt + decode headroom);
    the cache capacity is ``cfg.window_for(max_len)``. Returns
    (last-position logits (B, Vpad), cache) in the ``models.cache`` layout.
    """
    require_dense(cfg)
    tokens = batch["tokens"]
    s = tokens.shape[1]
    x = params["embed"][tokens.long()]
    cap = cfg.window_for(max_len if max_len is not None else s)
    window = cfg.window_for(s)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        p = layer(params["layers"], i)
        a, (k, v) = L.self_attention_train(
            p["attn"], L.rms_norm(x, p["ln1"]), cfg, window, return_kv=True)
        x = x + a
        x = x + L.mlp(p["mlp"], L.rms_norm(x, p["ln2"]))
        ks.append(k)
        vs.append(v)
    cache = {"pos": torch.tensor(s, dtype=torch.int32, device=x.device),
             "self": _ring_from_kv(torch.stack(ks), torch.stack(vs), cap)}
    return _logits(params, cfg, x[:, -1:, :])[:, 0], cache


@torch.inference_mode()
def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: dict) -> tuple[torch.Tensor, dict]:
    """One token (B, 1) against the cache -> (logits (B, Vpad), cache').

    The cache is updated in place (each layer writes the slot of ``pos``)
    and returned with ``pos`` advanced; the reference returns a new cache
    and leaves the old one as it was.
    """
    require_dense(cfg)
    x = params["embed"][tokens.long()]  # (B, 1, D)
    pos = cache["pos"]
    c = cache["self"]
    cap = c["k"].shape[2]
    for i in range(cfg.n_layers):
        p = layer(params["layers"], i)
        out, _, _, _ = L.self_attention_decode(
            p["attn"], L.rms_norm(x, p["ln1"]), c["k"][i], c["v"][i], c["slot_pos"][i],
            pos, cfg, cap)
        x = x + out
        x = x + L.mlp(p["mlp"], L.rms_norm(x, p["ln2"]))
    cache["pos"] = pos + 1
    return _logits(params, cfg, x)[:, 0], cache
