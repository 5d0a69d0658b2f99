"""Per-model sharding policies: parameters, batches, caches, optimizer state
(twin of ``repro.sharding.policy``).

``param_specs`` walks the declarative parameter schema, so the specs can
never drift from the parameters. Cache specs come from the cache's shapes
(``models.cache.cache_structure``, nothing allocated) and per-family
rules; batch specs shard the batch over ('pod', 'data') and, when the batch
is too small, the attention cache's capacity takes the leftover axes so a
long context still distributes. Every function reads only ``mesh.shape``
(a ``launch.mesh.make_dry_mesh`` will do) and returns the nested dicts,
``PartitionSpec`` leaves, of ``sharding.rules``. An unknown family raises
``ValueError`` (``models.cache.require_ported``).
"""
from __future__ import annotations

from typing import Any

from repro_torch.models import cache as cache_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import map_schema, param_schema
from repro_torch.optim.delayed import DelayedState
from repro_torch.optim.optimizers import AdamState, SgdState
from repro_torch.sharding.rules import P, PartitionSpec, batch_axes, spec_for


# ---------------------------------------------------------------- parameters
def param_specs(cfg: ModelConfig, mesh, rules=None) -> dict:
    """Specs congruent with ``init_params(cfg, ...)``."""
    return map_schema(lambda path, e: spec_for(e.shape, e.axes, mesh, rules),
                      param_schema(cfg))


# ------------------------------------------------------------------ batches
def data_specs(cfg: ModelConfig, mesh, batch: int) -> dict:
    """Specs of a training / prefill batch dict (tokens, labels, [media])."""
    cache_mod.require_ported(cfg)
    baxes = divisible_batch_axes(mesh, batch)
    tok = P(baxes or None)
    out = {"tokens": tok, "labels": tok}
    if cfg.family in ("vlm", "audio"):
        out["media"] = P(baxes or None, None, None)
    return out


def divisible_batch_axes(mesh, batch: int) -> tuple[str, ...]:
    """The batch mesh axes, in order, each taken while its size divides
    what is left of ``batch``."""
    got: list[str] = []
    rem = batch
    sizes = dict(mesh.shape)
    for a in batch_axes(mesh):
        if rem % sizes[a] == 0:
            got.append(a)
            rem //= sizes[a]
    return tuple(got)


# -------------------------------------------------------------------- caches
def _attn_cache_spec(mesh, k_shape, used_batch) -> dict:
    """(L, B, C, KV, hd) ring-cache specs: 'model' on the KV heads, else on
    the capacity, else on head_dim; batch axes the batch could not take
    soak into the capacity (long context, tiny batch)."""
    _, _, cap, kv, hd = k_shape
    names = dict(mesh.shape)
    model = names.get("model", 1)
    free_batch = [a for a in ("pod", "data") if names.get(a, 1) > 1 and a not in used_batch]
    kv_spec: Any = None
    cap_spec: Any = None
    hd_spec: Any = None
    if model > 1 and kv % model == 0:
        kv_spec = "model"
    elif model > 1 and cap % model == 0:
        cap_spec = "model"
    elif model > 1 and hd % model == 0:
        hd_spec = "model"
    extra = tuple(a for a in free_batch if cap % names[a] == 0)
    if extra:
        cap_spec = extra if cap_spec is None else (cap_spec,) + extra
    kv_p = P(None, used_batch or None, cap_spec, kv_spec, hd_spec)
    return {"k": kv_p, "v": kv_p, "slot_pos": P()}


def cache_specs(cfg: ModelConfig, mesh, batch: int, seq_len: int) -> dict:
    """Specs congruent with ``cache_structure(cfg, batch, seq_len)``."""
    struct = cache_mod.cache_structure(cfg, batch, seq_len)
    baxes = divisible_batch_axes(mesh, batch)
    model = dict(mesh.shape).get("model", 1)

    def model_if(dim: int):
        return "model" if model > 1 and dim % model == 0 else None

    out: dict = {"pos": P()}
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        out["self"] = _attn_cache_spec(mesh, struct["self"]["k"].shape, baxes)
        if cfg.family in ("vlm", "audio"):
            mk = struct["media_k"].shape  # (g or L, B, M, KV, hd)
            out["media_k"] = out["media_v"] = P(None, baxes or None, None, model_if(mk[3]),
                                                None)
        return out
    if cfg.family == "hybrid":
        ssm = struct["ssm"].shape  # (L, B, nh, hp, st)
        out["ssm"] = P(None, baxes or None, model_if(ssm[2]), None, None)
        conv = struct["conv"].shape  # (L, B, K-1, conv_ch)
        out["conv"] = P(None, baxes or None, None, model_if(conv[3]))
        out["shared"] = _attn_cache_spec(mesh, struct["shared"]["k"].shape, baxes)
        return out
    # xLSTM. The matrix memory shards on its output dim (q of C[p, q]): the
    # read contracts p, so a p shard would gather C every step; a q shard
    # keeps the read and the update local. Heads first, else head_dim.
    mc = struct["mlstm"]["c"].shape  # (g, mpg, B, H, hd, hd)
    hspec = model_if(mc[3])
    hdspec = None if hspec else model_if(mc[4])
    out["mlstm"] = {"c": P(None, None, baxes or None, hspec, None, hdspec),
                    "n": P(None, None, baxes or None, hspec, hdspec),
                    "m": P(None, None, baxes or None, hspec)}
    sc = struct["slstm"]["c"].shape  # (g, B, H, hd)
    shs = model_if(sc[2])
    sspec = P(None, baxes or None, shs, None if shs else model_if(sc[3]))
    out["slstm"] = {"c": sspec, "n": sspec, "m": sspec, "h": sspec}
    return out


# ----------------------------------------------------------------- optimizer
def _map_specs(fn, tree):
    if isinstance(tree, PartitionSpec):
        return fn(tree)
    return {k: _map_specs(fn, v) for k, v in tree.items()}


def optimizer_state_specs(state: Any, pspecs: dict) -> Any:
    """Specs of an optimizer state (``AdamState``, ``SgdState``,
    ``DelayedState``, or a ``chain``'s tuple of them): moments inherit the
    parameter specs (ZeRO: the state shards as far as the parameters do),
    the delayed-gradient ring gets a leading unsharded delay axis, scalars
    are replicated."""
    if isinstance(state, AdamState):
        return AdamState(step=P(), mu=pspecs, nu=pspecs)
    if isinstance(state, SgdState):
        return SgdState(momentum=pspecs if state.momentum != () else ())
    if isinstance(state, DelayedState):
        return DelayedState(step=P(), ring=_map_specs(lambda s: P(None, *s), pspecs),
                            inner=optimizer_state_specs(state.inner, pspecs))
    if isinstance(state, tuple) and not hasattr(state, "_fields"):
        return tuple(optimizer_state_specs(s, pspecs) for s in state)
    raise TypeError(f"unknown optimizer state node {type(state)}")
