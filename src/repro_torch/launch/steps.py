"""Step builders: the train step, and the prefill and decode programs of
the serving path (twin of ``repro.launch.steps``), on one device or over a
(data, model) mesh (``launch.mesh.make_lm_mesh``).

``make_train_step`` builds the production step: microbatched gradient
accumulation (f32 accumulators), optional Bernoulli importance weights
(the paper's sampled objective) and the optimizer update, which works in
place (``optim.optimizers``).

On a mesh each rank holds its shard of every parameter, placed by the
specs (``sharding.policy.param_specs``, or the ones given), and of the
optimizer state, which ``opt.init`` of the shards makes in the same
placement (``optimizer_state_specs``). Before the forward, each rank
gathers every parameter to the form it computes with
(``working_specs``): dense and embedding weights whole, the MoE expert
weights whole over 'data' but only this rank's E / tp experts over
'model', so the expert weights never cross the 'model' axis. Attention,
the MLP and the rest run replicated over 'model' on this rank's rows of
the batch (no tensor parallelism of the dense layers). After the
backward the gradients are summed over the batch axes in f32 and cut to
the shard (the reference's ``grad_specs`` pin: a reduce-scatter), and the
optimizer updates the shards in place, clipping by the global norm
(``optim.optimizers.global_norm_by``). Every rank takes the global batch
and cuts its own rows; with ``sampling_rate`` each draws the global keep
vector from its generator, as the single-device step draws it, and takes
its block.

The serving steps on a mesh cut the prompt's rows over the batch axes,
gather the logits and the cache back whole, and decode every row on every
rank: the decode's MoE runs with ``batch_axes=()``, each expert's d_ff cut
over 'data' (``layers.moe_ff_axis``), as the reference's does. Their
parameters are gathered once and again only when a held shard changes.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from repro_torch import collectives
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (
    decode_step,
    forward_train,
    map_schema,
    param_schema,
    prefill,
)
from repro_torch.optim.optimizers import (
    Optimizer,
    apply_updates,
    global_norm_by,
    tree_leaves,
    tree_map,
)
from repro_torch.sharding.policy import cache_specs, param_specs
from repro_torch.sharding.rules import P, block, entry_axes, map_specs, reshard

EXPERT_LEAVES = ("wg", "wu", "wd")  # the MoE layer's per-expert weights


def batch_shards(mesh, batch_axes: tuple, rows: int) -> tuple[str, ...]:
    """The axes ``rows`` are cut over: ``batch_axes``, or none where the rows
    do not divide over them (the reference's fallback in ``moe_ffn``)."""
    return tuple(batch_axes) if rows % math.prod(mesh.axis(a).size
                                                 for a in batch_axes) == 0 else ()


def cut_rows(x: torch.Tensor, mesh, axes: tuple) -> torch.Tensor:
    """This rank's block of ``x``'s rows (dim 0) over ``axes``, major first."""
    for a in axes:
        x = block(x, 0, mesh.axis(a))
    return x


def whole_rows(x: torch.Tensor, mesh, axes: tuple, dim: int = 0, tag: str = "rows"):
    """The inverse of ``cut_rows`` along ``dim``."""
    for a in reversed(axes):
        x = collectives.gather(x, mesh.axis(a), dim, tag)
    return x


def working_specs(cfg: ModelConfig, mesh, batch_axes: tuple = ("data",)) -> dict:
    """The spec of each parameter in the form the step computes with: whole,
    except the MoE expert weights, cut over 'model' on their experts dim
    and, on the route that cuts d_ff over 'data' (``layers.moe_ff_axis``),
    over 'data' on their d_ff dim."""
    ff = L.moe_ff_axis(cfg, mesh, batch_axes)

    def leaf(path, e):
        if path[-2:-1] != ("moe",) or path[-1] not in EXPERT_LEAVES:
            return P()
        return P(*("model" if a == "experts" else ff if a == "ff" else None for a in e.axes))

    return map_schema(leaf, param_schema(cfg))


def param_names(cfg: ModelConfig) -> dict:
    """Each parameter's dotted path, in the parameters' structure."""
    return map_schema(lambda path, e: ".".join(path), param_schema(cfg))


def gather_params(params: dict, mesh, specs: dict, work: dict, names: dict) -> dict:
    """The held shards (placed by ``specs``) in the working form ``work``."""
    with torch.no_grad():
        return map_specs(lambda have, want, x, name: reshard(x, mesh, have, want,
                                                             "param:" + name),
                         specs, work, params, names)


class _Working:
    """The parameters of a serving step in their working form, gathered once
    for each route and again only when a held shard is another tensor or
    was written in place (its version counter moved). Shards made under
    ``torch.inference_mode`` keep no version counter and are refused."""

    def __init__(self, cfg: ModelConfig, mesh, specs: dict):
        self.cfg, self.mesh, self.specs = cfg, mesh, specs
        self.names = param_names(cfg)
        self.memo: dict = {}

    def __call__(self, params: dict, batch_axes: tuple) -> dict:
        work = working_specs(self.cfg, self.mesh, batch_axes)
        route = L.moe_ff_axis(self.cfg, self.mesh, batch_axes)
        leaves = tree_leaves(params)
        if any(t.is_inference() for t in leaves):
            raise ValueError("the sharded serving steps memoise their gathered parameters by "
                             "version counter; inference tensors keep none: make the shards "
                             "outside torch.inference_mode")
        key = tuple((id(t), t._version) for t in leaves)
        if self.memo.get(route, (None,))[0] != key:
            self.memo[route] = (key, gather_params(params, self.mesh, self.specs, work,
                                                   self.names))
        return self.memo[route][1]


def _reduce_grad(g: torch.Tensor, mesh, have: P, want: P, axes: tuple,
                 name: str) -> torch.Tensor:
    """A working-form gradient summed over the batch ``axes`` and cut to its
    shard under ``want``: a reduce-scatter (``collectives.psum_scatter``)
    over an axis that ``want`` cuts next on some dim, else a psum; then
    the cuts over the other axes, which need no collective."""
    cur = [entry_axes(have, d) for d in range(g.dim())]
    for a in axes:
        dims = [d for d in range(g.dim())
                if entry_axes(want, d)[:len(cur[d]) + 1] == cur[d] + (a,)]
        if dims:
            g = collectives.psum_scatter(g, mesh.axis(a), dims[0], "grad:" + name)
            cur[dims[0]] += (a,)
        else:
            g = collectives.psum(g, mesh.axis(a), "grad:" + name)
    return reshard(g, mesh, P(*cur), want)


def _sharded_norm(mesh, specs: list) -> Callable:
    """The global squared norm from each leaf's squared shard norm (in the
    leaves' order): each leaf's is summed over the axes its spec shards
    it on, and only those, so a replicated leaf counts once."""
    groups: dict = {}
    for i, spec in enumerate(specs):
        axes = tuple(sorted({a for d in range(len(spec)) for a in entry_axes(spec, d)
                             if mesh.axis(a).size > 1}))
        groups.setdefault(axes, []).append(i)

    def total(squares: list) -> torch.Tensor:
        out = 0
        for axes, idx in groups.items():
            part = torch.stack([squares[i] for i in idx]).sum()
            out = out + collectives.psum(part, tuple(mesh.axis(a) for a in axes), "grad_norm")
        return out

    return total


def make_train_step(cfg: ModelConfig, opt: Optimizer, mesh=None,
                    batch_axes: tuple[str, ...] = ("data",), accum: int = 1,
                    sampling_rate: float = 0.0, grad_specs: dict | None = None) -> Callable:
    """Returns train_step(params, opt_state, batch, generator) -> (params,
    opt_state, metrics {"loss", "ce", "aux"}).

    The batch's leading axis splits into ``accum`` microbatches; their
    gradients accumulate in f32 and are divided by ``accum``. With
    ``sampling_rate`` R > 0 each microbatch draws keep-weights keep / R
    (keep ~ Bernoulli(R) a sequence) from ``generator``; the reference
    draws them from a JAX key, so the two packages draw other bits. The
    parameters (made to require grad) and the optimizer state are updated
    in place and returned.

    With a ``mesh`` (see the module's docstring) ``params`` and
    ``opt_state`` are this rank's shards, placed by ``grad_specs`` (the
    reference's name; ``param_specs(cfg, mesh)`` if None), ``batch`` is the
    global batch, and each microbatch's rows are cut over ``batch_axes``
    (not at all where they do not divide). The metrics are the global
    batch's, the same on every rank.
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

    def microbatches(batch: dict):
        b = batch["tokens"].shape[0]
        if b % accum:
            raise ValueError(f"batch {b} does not split into {accum} microbatches")
        for i in range(accum):
            yield {k: v.reshape((accum, b // accum) + v.shape[1:])[i]
                   for k, v in batch.items()}

    if mesh is not None:
        return _sharded_train_step(cfg, opt, mesh, tuple(batch_axes), accum, add_weights,
                                   microbatches, grad_specs)

    def train_step(params: dict, opt_state, batch: dict,
                   generator: torch.Generator | None = None):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        if accum == 1:
            loss, metrics = forward_train(params, cfg, add_weights(batch, generator))
            grads = torch.autograd.grad(loss, leaves)
        else:
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for p in leaves]
            ce = aux = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
            for mb in microbatches(batch):
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


def _sharded_train_step(cfg: ModelConfig, opt: Optimizer, mesh, batch_axes: tuple,
                        accum: int, add_weights: Callable, microbatches: Callable,
                        grad_specs: dict | None) -> Callable:
    """``make_train_step``'s form on a mesh."""
    specs = grad_specs if grad_specs is not None else param_specs(cfg, mesh)
    names = param_names(cfg)
    flat_specs: list = []
    map_specs(flat_specs.append, specs)
    norm = _sharded_norm(mesh, flat_specs)

    def train_step(params: dict, opt_state, batch: dict,
                   generator: torch.Generator | None = None):
        cut = batch_shards(mesh, batch_axes, batch["tokens"].shape[0] // accum)
        work_specs = working_specs(cfg, mesh, cut)
        work = gather_params(params, mesh, specs, work_specs, names)
        leaves = tree_leaves(work)
        for p in leaves:
            p.requires_grad_(True)
        grads: list = []
        loss = ce = aux = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for mb in microbatches(batch):
            mb = {k: cut_rows(v, mesh, cut) for k, v in add_weights(mb, generator).items()}
            mb_loss, m = forward_train(work, cfg, mb, mesh, cut)
            got = torch.autograd.grad(mb_loss, leaves)
            if accum == 1:  # each leaf goes to f32 as it is reduced
                grads = list(got)
            else:
                grads = grads or [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                                  for p in leaves]
                for acc, g in zip(grads, got):
                    acc.add_(g)
            del got
            loss = loss + mb_loss.detach()
            ce, aux = ce + m["ce"].detach(), aux + m["aux"].detach()
        del work, leaves
        flat_work: list = []
        map_specs(flat_work.append, work_specs)
        it = iter(enumerate(flat_work))

        def cut_grad(spec, name):
            i, have = next(it)
            g, grads[i] = grads[i].float(), None
            g = _reduce_grad(g, mesh, have, spec, cut, name)
            return (g.div_(accum) if accum > 1 else g).contiguous()

        grads = map_specs(cut_grad, specs, names)
        with torch.no_grad(), global_norm_by(norm):
            updates, opt_state = opt.update(grads, opt_state, params)
            params = apply_updates(params, updates)
        if accum > 1:  # the reference reports ce alone
            loss = ce
        return params, opt_state, {"loss": loss / accum, "ce": ce / accum, "aux": aux / accum}

    return train_step


def make_prefill_step(cfg: ModelConfig, mesh=None, batch_axes: tuple[str, ...] = ("data",),
                      max_len: int | None = None, specs: dict | None = None) -> Callable:
    """prefill_step(params, batch) -> (next_token (B,) int32, logits, cache);
    the next token is the greedy argmax (the first maximum on ties). On a
    ``mesh`` the params are this rank's shards placed by ``specs``
    (``param_specs(cfg, mesh)`` if None); the prompt's rows are cut over
    ``batch_axes`` and the logits and the cache come back whole, the same
    on every rank."""
    if mesh is None:
        def prefill_step(params, batch):
            logits, cache = prefill(params, cfg, batch, max_len=max_len)
            return torch.argmax(logits, dim=-1).to(torch.int32), logits, cache

        return prefill_step

    specs = specs if specs is not None else param_specs(cfg, mesh)
    working = _Working(cfg, mesh, specs)

    def sharded_prefill_step(params, batch):
        b, s = batch["tokens"].shape
        cut = batch_shards(mesh, batch_axes, b)
        local = {k: cut_rows(v, mesh, cut) for k, v in batch.items()}
        logits, cache = prefill(working(params, cut), cfg, local, max_len, mesh, cut)
        logits = whole_rows(logits, mesh, cut, tag="logits")

        def rows(spec, x):
            for d in range(x.dim()):
                x = whole_rows(x, mesh, tuple(a for a in entry_axes(spec, d) if a in cut), d,
                               "cache")
            return x

        with torch.inference_mode():
            cache = map_specs(rows, cache_specs(cfg, mesh, b, max_len or s), cache)
        return torch.argmax(logits, dim=-1).to(torch.int32), logits, cache

    return sharded_prefill_step


def make_decode_step(cfg: ModelConfig, mesh=None, batch_axes: tuple[str, ...] = ("data",),
                     specs: dict | None = None) -> Callable:
    """serve_step(params, tokens (B, 1), cache) -> (next_token (B,) int32,
    cache'), the cache updated in place. On a ``mesh`` every rank decodes
    every row against the whole cache (``make_prefill_step``'s), and the
    MoE body runs with ``batch_axes=()``, as the reference's does:
    replicating the handful of decode tokens over 'data' is far cheaper
    than gathering the expert weights over 'data' every token, so each
    expert's d_ff stays cut over 'data' (``layers.moe_ff_axis``).
    ``batch_axes`` is the reference's argument, unread there too."""
    if mesh is None:
        def serve_step(params, tokens, cache):
            logits, cache = decode_step(params, cfg, tokens, cache)
            return torch.argmax(logits, dim=-1).to(torch.int32), cache

        return serve_step

    working = _Working(cfg, mesh, specs if specs is not None else param_specs(cfg, mesh))

    def sharded_serve_step(params, tokens, cache):
        logits, cache = decode_step(working(params, ()), cfg, tokens, cache, mesh, ())
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return sharded_serve_step
