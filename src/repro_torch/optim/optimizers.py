"""Gradient-transform optimizers over the port's nested parameter dicts
(twin of ``repro.optim.optimizers``).

An ``Optimizer`` is an (init, update) pair, as in the reference:

    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

Unlike the reference, whose functions are pure and build new trees, the
port updates in place, leaf by leaf, so a full-width model never holds an
old and a new copy of its moments (granite-3-2b's Adam moments alone are
21 GB in f32):

* ``update`` consumes ``grads``: it may overwrite them and returns updates
  that share their memory; every update is written in the gradient's own
  dtype, which gives the reference's ``p + u.astype(p.dtype)`` whenever
  the gradient's dtype is the parameter's or f32;
* state moments (``SgdState.momentum``, ``AdamState.mu``/``nu``) are
  written in place and the returned state holds the same tensors;
* ``apply_updates`` adds into the parameters in place and returns them.

Elementwise work runs over flat chunks of each leaf, so its temporaries
stay small beside the 2.7 GB of the largest f32 leaf. Each operation
rounds where the reference's does. Call ``update`` and ``apply_updates``
outside autograd (``torch.no_grad()``), as ``launch.steps`` does.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, NamedTuple

import torch

PyTree = Any  # nested dicts (or tuples) of tensors
CHUNK = 1 << 25  # elements a chunk of the elementwise passes


def tree_leaves(tree: PyTree) -> list:
    """The tensors of a nested dict / tuple, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure), rebuilding the structure of ``tree``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def chunks(*tensors: torch.Tensor):
    """Matching flat views of at most CHUNK elements of equally shaped,
    contiguous tensors; writes into them land in the tensors."""
    flat = [t.view(-1) for t in tensors]
    for i in range(0, flat[0].numel(), CHUNK):
        yield tuple(f[i:i + CHUNK] for f in flat)


class Optimizer(NamedTuple):
    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, PyTree], tuple[PyTree, PyTree]]


@torch.no_grad()
def apply_updates(params: PyTree, updates: PyTree) -> PyTree:
    """p += u.to(p.dtype), in place; returns ``params``."""
    tree_map(lambda p, u: p.add_(u.to(p.dtype)), params, updates)
    return params


# -------------------------------------------------------------------- chain
def chain(*transforms: Optimizer) -> Optimizer:
    """Compose gradient transforms left to right."""

    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, params):
        new_state = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, params)
            new_state.append(s)
        return grads, tuple(new_state)

    return Optimizer(init, update)


# ---------------------------------------------------------------- transforms
_NORM_BY: list = []


@contextlib.contextmanager
def global_norm_by(total: Callable[[list], torch.Tensor]):
    """Inside the block, ``clip_by_global_norm`` takes the squared global
    norm as ``total(squares)`` of its leaves' squared norms (in
    ``tree_leaves`` order): the sharded train step sums each shard's over
    the ranks that hold the rest of its leaf (``launch.steps``)."""
    _NORM_BY.append(total)
    try:
        yield
    finally:
        _NORM_BY.pop()


def clip_by_global_norm(max_norm: float) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params):
        squares = []
        for g in tree_leaves(grads):
            leaf = 0
            for (c,) in chunks(g):
                leaf = leaf + c.float().square().sum()
            squares.append(torch.as_tensor(leaf, dtype=torch.float32, device=g.device))
        total = (_NORM_BY[-1] if _NORM_BY else sum)(squares)
        gn = torch.sqrt(torch.as_tensor(total, dtype=torch.float32))
        factor = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
        for g in tree_leaves(grads):
            g.mul_(factor.to(g.dtype))
        return grads, state

    return Optimizer(init, update)


def scale(factor: float) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params):
        for g in tree_leaves(grads):
            g.mul_(factor)
        return grads, state

    return Optimizer(init, update)


def add_decayed_weights(weight_decay: float) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params):
        def decay(g, p):
            for gc, pc in chunks(g, p):
                gc.add_(weight_decay * pc.to(gc.dtype))

        tree_map(decay, grads, params)
        return grads, state

    return Optimizer(init, update)


# ----------------------------------------------------------------- momentum
class SgdState(NamedTuple):
    momentum: PyTree


def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    """SGD with (optional) heavy-ball momentum. The paper's base step is
    plain SGD (momentum = 0): F <- F - v * L'_random."""

    def init(params):
        if momentum == 0.0:
            return SgdState(momentum=())
        return SgdState(momentum=tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params))

    def update(grads, state, params):
        if momentum == 0.0:
            for g in tree_leaves(grads):
                g.mul_(-lr)
            return grads, state

        def step(m, g):
            for mc, gc in chunks(m, g):
                mc.mul_(momentum).add_(gc.float())
                gc.copy_(-lr * mc)

        tree_map(step, state.momentum, grads)
        return grads, state

    return Optimizer(init, update)


class AdamState(NamedTuple):
    step: torch.Tensor  # () int32
    mu: PyTree  # f32
    nu: PyTree  # f32


def adam(
    lr: float | Callable[[torch.Tensor], torch.Tensor],
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
) -> Optimizer:
    """Adam with f32 moments (the production default for the model zoo).

    ``lr`` may be a schedule: a callable step -> learning rate.
    """

    def init(params):
        def zeros():
            return tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)

        device = tree_leaves(params)[0].device
        return AdamState(step=torch.zeros((), dtype=torch.int32, device=device), mu=zeros(),
                         nu=zeros())

    def update(grads, state, params):
        step = state.step + 1
        lr_t = lr(step) if callable(lr) else torch.tensor(lr, dtype=torch.float32,
                                                          device=step.device)
        stepf = step.float()
        bc1 = 1 - b1 ** stepf
        bc2 = 1 - b2 ** stepf
        neg_lr = -lr_t

        def leaf(m, v, g):
            for mc, vc, gc in chunks(m, v, g):
                g32 = gc.float()
                mc.mul_(b1).add_((1 - b1) * g32)
                vc.mul_(b2).add_((1 - b2) * g32.square())
                gc.copy_(neg_lr * (mc / bc1) / (torch.sqrt(vc / bc2) + eps))

        tree_map(leaf, state.mu, state.nu, grads)
        return grads, AdamState(step=step, mu=state.mu, nu=state.nu)

    return Optimizer(init, update)


def adamw(
    lr: float | Callable,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    max_grad_norm: float = 0.0,
) -> Optimizer:
    """The production recipe: clip -> decay -> adam."""
    parts = []
    if max_grad_norm > 0:
        parts.append(clip_by_global_norm(max_grad_norm))
    if weight_decay > 0:
        parts.append(add_decayed_weights(weight_decay))
    parts.append(adam(lr, b1, b2, eps))
    return chain(*parts)


# ----------------------------------------------------------------- schedules
def cosine_schedule(
    peak_lr: float, warmup_steps: int, total_steps: int, floor: float = 0.1
) -> Callable[[torch.Tensor], torch.Tensor]:
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = peak_lr * step / max(warmup_steps, 1)
        frac = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1),
                           0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup_steps, warm, cos)

    return lr
