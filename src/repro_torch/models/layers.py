"""Transformer building blocks: norms, rope, self-attention, the SwiGLU
MLP and the MoE FFN (twin of ``repro.models.layers``), which the dense and
MoE layers, the hybrid
family's shared block, whisper's encoder and decoder and the VLM's gated
cross-attention layers are made of.

Attention is q-chunked on the plain path (a loop over query chunks), so
peak score memory is bounded by (B, H, chunk, S_kv). With
``attn_impl="flash"`` full-causal training and prefill go through the
flash kernel instead, unless the rows hold packed documents
(``segments``), which only the chunked path masks. The KV cache is a ring
buffer over ``capacity`` slots with per-slot absolute positions, which
unifies full attention (capacity = max_len) and a sliding window
(capacity = window) under one code path.
Dtype casts stand where the reference has them.

The MoE FFN: top-k routing, then each expert, one after another, on a
fixed-capacity dispatch of its tokens (slot = rank among the expert's
tokens in token order; tokens past the capacity are dropped), and the
outputs added back to their rows in expert order. It syncs nothing with
the host (no mask indexing, ``nonzero`` or ``.item()``; every shape
follows from T, E and the capacity), and its sum is the same on every
run: a row takes at most one add an expert. On a (data, model) mesh each
model rank runs its E / tp experts on its batch shard's tokens, with the
capacity of its shard, and one psum over 'model' combines them (the
reference's expert-parallel ``shard_map`` branch; ``moe_ffn``).
"""
from __future__ import annotations

import math

import torch

from repro_torch import collectives
from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig

Params = dict[str, torch.Tensor]


# ------------------------------------------------------------------- basics
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The variance in f32, the product in x's dtype."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * scale


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, hd); positions: (S,) or (B, S)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freqs  # (..., S, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    if ang.dim() == 2:  # (S, half) -> broadcast over batch and heads
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:  # (B, S, half)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
           wd: torch.Tensor) -> torch.Tensor:
    return (torch.nn.functional.silu(x @ wg) * (x @ wu)) @ wd


# ---------------------------------------------------------------- attention
def _attend(
    q: torch.Tensor,  # (B, Sq, H, hd), rope'd
    k: torch.Tensor,  # (B, Sk, KV, hd)
    v: torch.Tensor,  # (B, Sk, KV, hd)
    q_pos: torch.Tensor,  # (B, Sq) absolute positions of queries
    k_pos: torch.Tensor,  # (Sk,) absolute positions of keys (-1 = empty slot)
    window: int,  # attend iff 0 <= qpos - kpos < window (causal SWA)
    causal: bool,
    q_seg: torch.Tensor | None = None,  # (B, Sq) packing segment ids (0 = pad)
    k_seg: torch.Tensor | None = None,  # (B, Sk)
) -> torch.Tensor:
    """A query attends only to the keys of its own packed document
    (``q_seg == k_seg``), and a pad query (segment 0) to none: its row of
    scores is all -inf, and its output and gradient come out 0."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, sq, kv, h // kv, hd)
    # The scale is divided in q's dtype, as the reference does.
    root = float(torch.tensor(float(hd)).sqrt().to(q.dtype))
    scores = (torch.einsum("bqkgd,bskd->bkgqs", qg, k) / root).float()
    dist = q_pos[:, None, None, :, None] - k_pos[None, None, None, None, :]
    valid = k_pos[None, None, None, None, :] >= 0
    if causal:
        valid = valid & (dist >= 0) & (dist < window)
    if q_seg is not None and k_seg is not None:
        qs = q_seg[:, None, None, :, None]
        valid = valid & (qs == k_seg[:, None, None, None, :]) & (qs > 0)
    scores = scores.masked_fill(~valid, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    p = torch.where(torch.isfinite(scores).any(-1, keepdim=True), p, torch.zeros_like(p))
    out = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype), v)
    return out.reshape(b, sq, h, hd)


def chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_pos: torch.Tensor,  # (Sq,) absolute query positions (shared across batch)
    k_pos: torch.Tensor,  # (Sk,)
    window: int,
    causal: bool,
    chunk: int,
    segments: torch.Tensor | None = None,  # (B, S) packing segment ids
) -> torch.Tensor:
    """A loop over query chunks: bounded score memory for long sequences.
    The last chunk is simply shorter (rows are independent), where the
    reference pads it. With ``segments`` each query chunk takes its slice
    of them and the keys take them whole."""
    b, sq = q.shape[:2]
    chunk = min(chunk, sq)
    outs = [
        _attend(q[:, i:i + chunk], k, v, q_pos[i:i + chunk].expand(b, -1), k_pos, window,
                causal, q_seg=None if segments is None else segments[:, i:i + chunk],
                k_seg=segments)
        for i in range(0, sq, chunk)
    ]
    return torch.cat(outs, dim=1)


def _project_qkv(p: Params, x: torch.Tensor, cfg: ModelConfig):
    b, s, _ = x.shape
    q = (x @ p["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = (x @ p["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = (x @ p["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    return q, k, v


def self_attention_train(
    p: Params, x: torch.Tensor, cfg: ModelConfig, window: int, return_kv: bool = False,
    segments: torch.Tensor | None = None,
):
    """Full-sequence path (training, scoring, prefill): causal, or sliding
    window. ``segments`` (B, S) keeps packed documents apart (0 = padding).
    ``attn_impl="flash"`` takes the flash kernel when the window covers the
    whole sequence and nothing is packed, by the reference's rule; otherwise
    the chunked path runs."""
    b, s, _ = x.shape
    pos = torch.arange(s, device=x.device)
    q, k, v = _project_qkv(p, x, cfg)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)
    if cfg.attn_impl == "flash" and window >= s and segments is None:
        out = ops.flash_attention(q, k, v, causal=True)
    else:
        out = chunked_attention(q, k, v, pos, pos, window, True, cfg.attn_chunk,
                                segments=segments)
    out = out.reshape(b, s, cfg.q_dim) @ p["wo"]
    if return_kv:
        return out, (k, v)
    return out


def ring_cache_from_prefill(k: torch.Tensor, v: torch.Tensor, cap: int):
    """Fold full-sequence (B, S, KV, hd) K/V into a ring cache of ``cap``
    slots. Requires cap | S so slot s holds absolute position S - cap + s."""
    s = k.shape[1]
    if s % cap:
        raise ValueError("ring capacity must divide prefill length")
    slot_pos = torch.arange(cap, dtype=torch.int32, device=k.device) + (s - cap)
    return k[:, s - cap:], v[:, s - cap:], slot_pos


def encoder_attention(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Bidirectional self-attention (whisper's encoder): rope on q and k,
    every query sees every key, through the chunked path (the reference's
    plain chunked attention; no flash kernel)."""
    b, s, _ = x.shape
    pos = torch.arange(s, device=x.device)
    q, k, v = _project_qkv(p, x, cfg)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)
    out = chunked_attention(q, k, v, pos, pos, s, False, cfg.attn_chunk)
    return out.reshape(b, s, cfg.q_dim) @ p["wo"]


def cross_attention(p: Params, x: torch.Tensor, kv_src, cfg: ModelConfig) -> torch.Tensor:
    """x (B, S, D) attends to media or encoder states: ``kv_src`` is (B, M,
    D), projected here by wk and wv, or a cached ``(k, v)`` pair of (B, M,
    KV, hd) when serving. No rope on this path; not causal (every query
    sees all M keys), through the chunked path as in the reference."""
    b, s, _ = x.shape
    q = (x @ p["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    if isinstance(kv_src, tuple):
        k, v = kv_src
    else:
        m = kv_src.shape[1]
        k = (kv_src @ p["wk"]).reshape(b, m, cfg.n_kv_heads, cfg.head_dim)
        v = (kv_src @ p["wv"]).reshape(b, m, cfg.n_kv_heads, cfg.head_dim)
    m = k.shape[1]
    pos_q = torch.arange(s, device=x.device)
    pos_k = torch.arange(m, device=x.device)
    out = chunked_attention(q, k, v, pos_q, pos_k, m + s + 1, False, cfg.attn_chunk)
    return out.reshape(b, s, cfg.q_dim) @ p["wo"]


def self_attention_decode(
    p: Params,
    x: torch.Tensor,  # (B, 1, D) current token
    cache_k: torch.Tensor,  # (B, C, KV, hd) ring buffer
    cache_v: torch.Tensor,
    slot_pos: torch.Tensor,  # (C,) absolute position stored in each slot (-1 empty)
    pos: torch.Tensor,  # () current absolute position
    cfg: ModelConfig,
    window: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step against the ring cache -> (out, k', v', slot').

    Unlike the reference, which returns new arrays, the slot of ``pos`` is
    written in place: ``cache_k``, ``cache_v`` and ``slot_pos`` (views into
    the stacked cache) are updated and returned.
    """
    b = x.shape[0]
    cap = cache_k.shape[1]
    q, k, v = _project_qkv(p, x, cfg)
    posb = pos.reshape(1)
    q = rope(q, posb, cfg.rope_theta)
    k = rope(k, posb, cfg.rope_theta)
    slot = (posb % cap).long()
    cache_k.index_copy_(1, slot, k)
    cache_v.index_copy_(1, slot, v)
    slot_pos.index_copy_(0, slot, posb.to(slot_pos.dtype))
    out = _attend(q, cache_k, cache_v, posb[None, :].expand(b, 1), slot_pos, window, True)
    return out.reshape(b, 1, cfg.q_dim) @ p["wo"], cache_k, cache_v, slot_pos


# ---------------------------------------------------------------------- MLP
def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    return swiglu(x, p["wg"], p["wu"], p["wd"])


# ---------------------------------------------------------------------- MoE
def _router(p: Params, xf: torch.Tensor, cfg: ModelConfig):
    """Top-k routing and the switch-style load-balance aux loss. The logits
    are an f32 product (left in true f32: a TF32 product moves near-tied
    ids); the k largest probabilities come from a stable descending sort,
    so a tie goes to the lower expert, as ``jax.lax.top_k`` breaks it
    (``torch.topk`` promises no order on ties); they are renormalised and
    cast to xf's dtype. aux = E * mean_e(mean_t(one_hot(top-1 id)) *
    mean_t(probs)). Returns (weights (T, k), ids (T, k) int64, aux)."""
    logits = xf.float() @ p["wr"].float()  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    weights, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, ids = weights[:, :cfg.top_k], ids[:, :cfg.top_k]
    weights = weights / weights.sum(dim=-1, keepdim=True)
    onehot = torch.nn.functional.one_hot(ids[:, 0], cfg.n_experts).float()  # top-1 load
    aux = cfg.n_experts * (onehot.mean(dim=0) * probs.mean(dim=0)).mean()
    return weights.to(xf.dtype), ids, aux


def expert_dispatch(ids: torch.Tensor, weights: torch.Tensor, n_experts: int,
                    capacity: int, e_offset: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """The fixed-capacity dispatch of experts ``e_offset`` .. ``e_offset +
    n_experts - 1``: each one's token row at each of its ``capacity``
    slots (E, C) (T, the sentinel, where a slot stays empty), and each
    token's combine weight for each expert (E, T) (0 if not routed to it).
    A token's slot is its rank among the expert's routed tokens, in token
    order; tokens at or past the capacity are dropped. No host sync: the
    tokens scatter into capacity + 1 slots an expert, the last catching
    every token not placed, and it is cut off."""
    t = ids.shape[0]
    dev = ids.device
    experts = torch.arange(n_experts, device=dev)
    m = ids[None] == (experts + e_offset)[:, None, None]  # (E, T, k)
    tok_w = torch.where(m, weights[None], torch.zeros((), dtype=weights.dtype,
                                                      device=dev)).sum(dim=-1)
    routed = m.any(dim=-1)  # (E, T): each expert's scan runs along its row
    rank = torch.cumsum(routed.long(), dim=1) - 1
    slot = torch.where(routed & (rank < capacity), rank, capacity)
    slot = slot + experts[:, None] * (capacity + 1)
    dispatch = torch.full((n_experts * (capacity + 1),), t, dtype=torch.long, device=dev)
    dispatch.scatter_(0, slot.reshape(-1), torch.arange(t, device=dev).repeat(n_experts))
    return dispatch.view(n_experts, capacity + 1)[:, :capacity], tok_w


def _expert_block(xf: torch.Tensor, ids: torch.Tensor, weights: torch.Tensor,
                  wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor, e_offset: int,
                  capacity: int) -> torch.Tensor:
    """The experts of wg/wu/wd (E_loc, ...) on their dispatched tokens, one
    expert after another, as in the reference: a (C, D) gather of the input
    with a zero row for the sentinel, the SwiGLU MLP as three 2-D products,
    and the output scaled by the token's weight and added back to its row
    in expert order (at most one add a row each expert, so the sum is the
    same on every run, whatever top_k). Returns the weighted output (T, D);
    dropped tokens get nothing."""
    t, d = xf.shape
    dispatch, tok_w = expert_dispatch(ids, weights, wg.shape[0], capacity, e_offset)
    we = torch.cat([tok_w, tok_w.new_zeros((tok_w.shape[0], 1))], dim=1).gather(1, dispatch)
    xpad = torch.cat([xf, xf.new_zeros((1, d))])
    out = xf.new_zeros((t + 1, d))
    for j, (g, u, dn) in enumerate(zip(wg.unbind(0), wu.unbind(0), wd.unbind(0))):
        he = swiglu(torch.index_select(xpad, 0, dispatch[j]), g, u, dn)  # (C, D)
        out.index_add_(0, dispatch[j], he * we[j, :, None])
    return out[:t]


def moe_capacity(cfg: ModelConfig, tokens: int, capacity: int | None = None) -> int:
    """Slots an expert: ``capacity`` if given, every token under -1 (lossless;
    decode), else max(1, int(top_k * T / E * capacity_factor))."""
    if capacity == -1:
        return tokens
    if capacity is not None:
        return capacity
    return max(1, int(cfg.top_k * tokens / cfg.n_experts * cfg.capacity_factor))


def moe_ff_axis(cfg: ModelConfig, mesh, batch_axes: tuple) -> str | None:
    """The mesh axis each expert's d_ff is cut over: 'data' when the batch
    does not use it (``batch_axes`` empty, as at decode), it has more than
    one rank and divides d_ff; else None (the reference's rule)."""
    data = dict(mesh.shape).get("data", 1)
    return "data" if not batch_axes and data > 1 and cfg.d_ff % data == 0 else None


def moe_ffn(p: Params, x: torch.Tensor, cfg: ModelConfig, mesh=None,
            batch_axes: tuple[str, ...] = ("data",), model_axis: str = "model",
            capacity: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The MoE FFN -> (out (B, S, D), aux). ``capacity``: None for the
    capacity-factor rule, -1 for every token (decode).

    Without a mesh, or on one where nothing is cut (``model_axis``, the
    batch axes and the d_ff route all of one rank: the host mesh), it runs
    on one device (the reference's ``mesh=None`` branch): route the (B, S)
    tokens, run every expert on its fixed-capacity dispatch and combine.
    Where ``model_axis`` has one rank but the batch is cut, it takes the
    mesh branch all the same (E / 1 experts; the reference takes its
    one-device branch there on the global batch): ``x`` is then this
    rank's block, so the capacity is the shard's and ``aux`` the mean over
    the shards, as at tp > 1.

    On a mesh (``launch.mesh.make_lm_mesh``; the reference's
    expert-parallel branch), ``x`` is this rank's block of the batch over
    ``batch_axes``, the same on every rank of ``model_axis`` (with
    ``batch_axes`` empty, the whole batch on every rank: the caller cuts
    the batch, and falls back to no cut where the batch does not divide
    over the axes, as the reference does). ``p["wg"]``, ``"wu"`` and
    ``"wd"`` hold this rank's E / tp experts, and on the route that cuts
    d_ff over 'data' (``moe_ff_axis``) this rank's d_ff block of each;
    the router ``wr`` is whole. The capacity is the shard's: T_loc =
    (B / dp) x S tokens. The partial outputs are summed over 'model'
    (and 'data' on the d_ff route) and ``aux`` is the mean over the batch
    shards. For the backward, the tokens and the combine weights enter
    the experts through ``collectives.copy_to`` (Megatron's f): each rank's
    gradient of them holds only its experts' share, so it is summed over
    the same axes, which also sums the router's share of ``wr``'s
    gradient; the aux term's gradient is whole on every rank and does not
    pass there, so it is not summed again.
    """
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    weights, ids, aux = _router(p, xf, cfg)
    cap = moe_capacity(cfg, xf.shape[0], capacity)
    names = dict(mesh.shape) if mesh is not None else {}
    shards = tuple(mesh.axis(a) for a in batch_axes if names.get(a, 1) > 1) if names else ()
    ff_axis = moe_ff_axis(cfg, mesh, batch_axes) if names else None
    if names.get(model_axis, 1) == 1 and not shards and ff_axis is None:
        out = _expert_block(xf, ids, weights, p["wg"], p["wu"], p["wd"], 0, cap)
        return out.reshape(b, s, d), aux
    model = mesh.axis(model_axis)
    e_loc = cfg.n_experts // model.size
    if cfg.n_experts % model.size or p["wg"].shape[0] != e_loc:
        raise ValueError(f"{cfg.n_experts} experts over {model.size} '{model_axis}' ranks: "
                         f"this rank holds {p['wg'].shape[0]}, expected {e_loc}")
    axes = (model,) + ((mesh.axis(ff_axis),) if ff_axis else ())
    out = _expert_block(collectives.copy_to(xf, axes, "moe.x"), ids,
                        collectives.copy_to(weights, axes, "moe.weights"),
                        p["wg"], p["wu"], p["wd"], model.index * e_loc, cap)
    out = collectives.reduce_from(out, axes, "moe.out")
    aux = collectives.reduce_from(aux, shards, "moe.aux") / math.prod(a.size for a in shards)
    return out.reshape(b, s, d), aux
