"""The parameter-server training engine (twin of ``repro.ps.engine``).

Algorithm 3 splits a boosting round across the PS roles:

  worker — pull a (possibly stale) prediction vector F^{k(j)}, draw the
           Bernoulli subdataset Q, build the gradient target, fit a tree
           (``propose_tree``);
  server — fold the pushed tree into the live state F <- F + v * Tree
           (``server_fold``).

``round_body`` composes the two. ``Trainer`` runs it in a Python loop
under any delay schedule, keeping a ring of the last F versions: ``train``
with eval hooks, ``scan_with`` over an explicit (k(j), ticket) pair with a
per-round loss (the form ``ps.runtime`` replays a recorded run through).
With ``cfg.adaptive_step`` the server deflates each pushed tree by its
observed staleness (``staleness_scale``, ``scale_push``).

Randomness is per ticket: ``round_draws(cfg, data, seed, i)`` draws round
i's Bernoulli weights and feature mask from a ``torch.Generator`` seeded
as a pure function of (seed, i), as the reference's round key is
``keys[i]`` of ``jax.random.split(PRNGKey(seed), n_trees)``. So a round's
tree depends on its ticket and its F^{k(j)} only, whichever thread builds
it and in whatever order. The draws cannot reproduce ``jax.random``'s
bits, so ``propose_tree`` and the trainer also take injected draws
(``m_prime`` (N,), ``feat_mask`` (F,)): the parity tests recompute the
reference's draws and hand them in.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.sgbdt import SGBDTConfig, TrainState, init_state
from repro_torch.data.sampling import bernoulli_weights
from repro_torch.ps.schedules import max_staleness, resolve_schedule
from repro_torch.trees.binning import BinnedData
from repro_torch.trees.forest import Forest, forest_push
from repro_torch.trees.learner import build_tree, build_tree_multi
from repro_torch.trees.tree import Tree, apply_tree, apply_tree_stack

# One round's draws: (m_prime (N,) f32, q_any (N,) bool, feat_mask (F,)
# bool), as ``round_draws`` gives them; an injected (m_prime, feat_mask)
# pair also serves (q_any is then m_prime > 0, as counts > 0 is).
Draws = tuple


def round_seed(seed: int, i: int) -> int:
    """The generator seed of ticket ``i`` in a run seeded ``seed``: a pure
    function of the pair (numpy's ``SeedSequence`` mix, 63 bits)."""
    state = np.random.SeedSequence([int(seed), int(i)]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def _draw(cfg: SGBDTConfig, data: BinnedData, gen: torch.Generator | None
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One round's ``(m_prime, q_any, feat_mask)`` from ``gen``: the
    Bernoulli weights first, then the feature mask."""
    dev = data.bins.device
    m_prime, q_any = bernoulli_weights(gen, cfg.sampling_rate, data.multiplicity)
    n_feat = data.n_features
    if cfg.learner.feature_fraction < 1.0:
        feat_mask = torch.rand(n_feat, generator=gen, device=dev) < cfg.learner.feature_fraction
    else:
        feat_mask = torch.ones(n_feat, dtype=torch.bool, device=dev)
    return m_prime, q_any, feat_mask


def round_draws(cfg: SGBDTConfig, data: BinnedData, seed: int, i: int
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Ticket ``i``'s draws, ``(m_prime, q_any, feat_mask)``, on the data's
    device, from a generator seeded ``round_seed(seed, i)``, in
    ``propose_tree``'s order. The same (seed, i) gives the same bits on any
    thread and in any order."""
    gen = torch.Generator(device=data.bins.device)
    gen.manual_seed(round_seed(seed, i))
    return _draw(cfg, data, gen)


def unpack_draws(draws: Draws) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(m_prime, q_any, feat_mask)`` of a draw triple or an injected
    ``(m_prime, feat_mask)`` pair."""
    if len(draws) == 3:
        return tuple(draws)
    m_prime, feat_mask = draws
    return m_prime, m_prime > 0, feat_mask


def propose_tree(
    cfg: SGBDTConfig,
    data: BinnedData,
    f_target: torch.Tensor,
    gen: torch.Generator | None = None,
    m_prime: torch.Tensor | None = None,
    feat_mask: torch.Tensor | None = None,
    builder: Callable | None = None,
) -> tuple[Tree, torch.Tensor]:
    """Worker side: sample Q -> build target from F^{k(j)} -> fit a tree.

    Returns the tree and its prediction delta on the training bins (the
    push payload). A K-output objective fits K trees against the (N, K)
    field, one stacked group with an (N, K) delta: still one push, and one
    (m', mask) draw a round. The step length v scales the leaf table HERE,
    before the gather, so the server fold is a pure add (engine.py:73-81
    of the reference). Unless both draws are injected they come from
    ``gen``: Bernoulli weights first, then the feature mask.

    The hessian weights: the paper's gradient step takes h_i = m'_i
    (broadcast over the K outputs), so a leaf is the mean sampled
    gradient; ``step_kind="newton"`` takes m'_i h_i, the objective's
    hessian under the sample weights, for xgboost's leaf -G / (H + lam).

    ``builder`` (``ps.sharded``) replaces ``build_tree``: ``builder(bins,
    g, h, feat_mask)`` on the whole arrays, one call per output.
    """
    obj = cfg.obj
    if m_prime is None or feat_mask is None:
        m_prime, _, feat_mask = _draw(cfg, data, gen)
    g, h = obj.grad_hess(data.labels, f_target, qid=data.qid)
    v = torch.tensor(cfg.step_length, dtype=torch.float32, device=g.device)
    newton = cfg.step_kind == "newton"
    if obj.n_outputs == 1:
        hess_w = m_prime * h if newton else m_prime
        if builder is None:
            tree = build_tree(cfg.learner, data.bins, m_prime * g, hess_w, feat_mask.bool())
        else:
            tree = builder(data.bins, m_prime * g, hess_w, feat_mask.bool())
        tree = tree._replace(leaf_value=v * tree.leaf_value)
        return tree, apply_tree(tree, data.bins)
    g_w = m_prime[:, None] * g
    h_w = m_prime[:, None] * h if newton else m_prime[:, None].expand_as(g)
    if builder is None:
        trees = build_tree_multi(cfg.learner, data.bins, g_w, h_w, feat_mask.bool())
    else:
        built = [builder(data.bins, g_w[:, k].contiguous(), h_w[:, k].contiguous(),
                         feat_mask.bool()) for k in range(g.shape[1])]
        trees = Tree(*(torch.stack(parts) for parts in zip(*built)))
    trees = trees._replace(leaf_value=v * trees.leaf_value)
    return trees, apply_tree_stack(trees, data.bins)


def server_fold(
    cfg: SGBDTConfig, forest: Forest, f_live: torch.Tensor, tree: Tree, delta: torch.Tensor
) -> tuple[Forest, torch.Tensor]:
    """Server side: F <- F + v * Tree (one tree, or a K-output group into K
    slots). The leaves arrive pre-scaled by v, so this is a slot write plus
    a pure add, the same for every ``cfg`` (the reference's signature)."""
    return forest_push(forest, tree, 1.0), f_live + delta


def staleness_scale(rho: float, staleness, device: str | torch.device | None = None
                    ) -> torch.Tensor:
    """Proposition 1's step deflation for a tau-stale push, 1 / (1 + 6 rho
    tau), as a 0-d f32 tensor on ``device`` (the CPU by default).

    The bits of ``schedules.staleness_scales``: 6 rho is folded in Python
    f64 and rounded to f32 once; then a multiply, an add and a division,
    each its own f32 op (nothing fuses the multiply into the add).
    """
    tau = torch.as_tensor(staleness, dtype=torch.float32, device=device)
    coef = torch.tensor(6.0 * rho, dtype=torch.float32, device=tau.device)
    one = torch.ones_like(tau)
    return one / (one + coef * tau)


def scale_push(cfg: SGBDTConfig, data: BinnedData, tree: Tree, scale: torch.Tensor
               ) -> tuple[Tree, torch.Tensor]:
    """The server's staleness-adaptive deflation of a pushed tree: the scale
    multiplies the LEAF TABLE, and the delta is the scaled tree gathered
    again on the training bins. A multiply next to the fold's add could be
    contracted into an FMA; a gathered operand cannot, and
    ``round(s * leaf)[idx] == round(s * leaf[idx])``. The pushed delta is
    dropped: the tree alone determines the update."""
    tree = tree._replace(leaf_value=scale * tree.leaf_value)
    if cfg.obj.n_outputs == 1:
        return tree, apply_tree(tree, data.bins)
    return tree, apply_tree_stack(tree, data.bins)


def fold_push(
    cfg: SGBDTConfig,
    data: BinnedData,
    forest: Forest,
    f_live: torch.Tensor,
    tree: Tree,
    delta: torch.Tensor,
    staleness: int | None = None,
) -> tuple[Forest, torch.Tensor]:
    """The server's side of a round: with ``cfg.adaptive_step`` and a
    ``staleness`` tau_j = j - k(j) (known only at fold time) the pushed
    tree is deflated first (``scale_push``), then folded. Every trainer
    and the threaded runtime's server run exactly this."""
    if cfg.adaptive_step and staleness is not None:
        scale = staleness_scale(cfg.adaptive_step, staleness, device=f_live.device)
        tree, delta = scale_push(cfg, data, tree, scale)
    return server_fold(cfg, forest, f_live, tree, delta)


def round_body(
    cfg: SGBDTConfig,
    data: BinnedData,
    forest: Forest,
    f_live: torch.Tensor,
    f_target: torch.Tensor,
    gen: torch.Generator | None = None,
    draws: Draws | None = None,
    staleness: int | None = None,
    builder: Callable | None = None,
) -> tuple[Forest, torch.Tensor]:
    """One boosting round: the tree is built against (possibly stale)
    ``f_target`` (by ``builder`` when given) but folded into the live
    server state (``fold_push``, with the adaptive deflation when
    ``staleness`` is given)."""
    m_prime = feat_mask = None
    if draws is not None:
        m_prime, _, feat_mask = unpack_draws(draws)
    tree, delta = propose_tree(cfg, data, f_target, gen, m_prime, feat_mask, builder)
    return fold_push(cfg, data, forest, f_live, tree, delta, staleness)


class Trainer:
    """Mesh-aware parameter-server GBDT trainer (the loop form).

    Runs on the card unless ``device`` is given; without a GPU and without
    a ``device`` it raises.

    With a ``mesh`` (``launch.mesh``) whose ``axis_name`` axis has more
    than one shard, tree builds run data-parallel (``ps.sharded``); a mesh
    that also has a ``feature_axis`` axis (any size) selects the 2D build:
    features shard across it and splits merge with the (L,)-sized argmax
    collective. Every rank runs the same trainer: the server state and the
    fold stay whole on every rank, only the build is sharded, and every
    rank ends with the same forest. The device is the mesh's.
    """

    def __init__(
        self,
        cfg: SGBDTConfig,
        *,
        device: str | torch.device | None = None,
        mesh=None,
        axis_name: str = "data",
        feature_axis: str | None = "feature",
    ):
        self.cfg = cfg
        self.device = resolve_device(device if mesh is None or device is not None
                                     else mesh.device)
        self.mesh = mesh
        self.axis_name = axis_name
        self.feature_axis = feature_axis
        self.builder: Callable | None = None
        self._is_2d = mesh is not None and feature_axis in mesh.axis_names
        if mesh is not None and mesh.device != self.device:
            raise ValueError(f"mesh on {mesh.device}, trainer on {self.device}")
        if self._is_2d:
            from repro_torch.ps.sharded import make_sharded_builder_2d

            self.builder = make_sharded_builder_2d(cfg.learner, mesh, axis_name, feature_axis)
        elif mesh is not None and mesh.shape.get(axis_name, 1) > 1:
            from repro_torch.ps.sharded import make_sharded_builder

            self.builder = make_sharded_builder(cfg.learner, mesh, axis_name)

    def collective_bytes(self, data: BinnedData) -> dict | None:
        """The collective bytes of one tree build on this trainer's mesh
        (``ps.sharded.collective_bytes_per_build``); None when builds are
        single-device (no collectives at all)."""
        if self.builder is None:
            return None
        from repro_torch.ps.sharded import collective_bytes_per_build

        return collective_bytes_per_build(
            self.cfg.learner, self.mesh, data.bins, data_axis=self.axis_name,
            feature_axis=self.feature_axis if self._is_2d else None)

    def _loop(self, data, sched, key_index, ring_size: int, seed: int, draws, rounds: int,
              eval_every: int = 0, eval_fn=None, losses: list | None = None) -> TrainState:
        """Rounds 0 .. rounds-1: round j builds ticket ``key_index[j]``'s
        tree (its ``draws`` entry, else ``round_draws``) against F^{k(j)}
        from the ring and folds it; ``losses`` collects each round's loss."""
        cfg = self.cfg
        if data.bins.device != self.device:
            raise ValueError(f"data lies on {data.bins.device}, trainer on {self.device}")
        state = init_state(cfg, data)
        forest, f = state.forest, state.f
        ring = [f] * ring_size  # the last ring_size versions of F ((N,) or (N, K))
        for j in range(rounds):
            i, k = int(key_index[j]), int(sched[j])
            forest, f = round_body(
                cfg, data, forest, f, ring[k % ring_size], None,
                round_draws(cfg, data, seed, i) if draws is None else draws[i],
                j - k if cfg.adaptive_step else None, self.builder,
            )
            ring[(j + 1) % ring_size] = f
            if losses is not None:
                losses.append(cfg.obj.loss(data.labels, f, data.multiplicity, qid=data.qid))
            if eval_fn is not None and eval_every and (j + 1) % eval_every == 0:
                eval_fn(TrainState(forest, f, j + 1), j + 1)
        return TrainState(forest=forest, f=f, step=rounds)

    def train(
        self,
        data: BinnedData,
        schedule=("round_robin", 1),
        seed: int = 0,
        eval_every: int = 0,
        eval_fn: Callable[[TrainState, int], None] | None = None,
        draws: Sequence[Draws] | None = None,
        rounds: int | None = None,
    ) -> TrainState:
        """Python-loop execution with per-round eval hooks: round j builds
        ticket j. ``draws[j]``, when given, replaces round j's
        ``round_draws``. ``rounds`` stops after that many rounds of the
        schedule (default: all ``cfg.n_trees``); the forest keeps its full
        ``cfg.n_trees`` slots either way."""
        cfg = self.cfg
        sched = resolve_schedule(schedule, cfg.n_trees)
        rounds = cfg.n_trees if rounds is None else rounds
        if not 0 <= rounds <= cfg.n_trees:
            raise ValueError(f"rounds must lie in [0, {cfg.n_trees}], got {rounds}")
        return self._loop(data, sched, range(cfg.n_trees), max_staleness(sched) + 1, seed,
                          draws, rounds, eval_every, eval_fn)

    def scan_with(
        self,
        data: BinnedData,
        schedule,
        key_index,
        ring_size: int,
        draws: Sequence[Draws] | None = None,
        seed: int = 0,
    ) -> tuple[TrainState, torch.Tensor]:
        """The whole run over an explicit (k(j), ticket) pair: round j folds
        ticket ``key_index[j]``'s tree built from F^{k(j)}; returns the state
        and the per-round train losses (T,). The loop-form twin of the
        reference's ``lax.scan`` (``repro/ps/engine.py:309``), which
        ``ps.runtime`` replays a recorded run through. ``draws``, when
        given, is indexed by ticket; ``ring_size`` must exceed the
        schedule's largest staleness."""
        cfg = self.cfg
        sched = resolve_schedule(schedule, cfg.n_trees)
        key_index = np.asarray(key_index)
        if key_index.shape != (cfg.n_trees,):
            raise ValueError(f"key_index shape {key_index.shape} != ({cfg.n_trees},)")
        if ring_size <= max_staleness(sched):
            raise ValueError(f"ring_size {ring_size} cannot hold staleness "
                             f"{max_staleness(sched)}")
        losses: list = []
        state = self._loop(data, sched, key_index, ring_size, seed, draws, cfg.n_trees,
                           losses=losses)
        return state, torch.stack(losses)

    def train_scan(self, data: BinnedData, schedule=("round_robin", 1), seed: int = 0
                   ) -> tuple[TrainState, torch.Tensor]:
        """``scan_with`` under a schedule spec, tickets in round order."""
        sched = resolve_schedule(schedule, self.cfg.n_trees)
        return self.scan_with(data, sched, np.arange(self.cfg.n_trees),
                              max_staleness(sched) + 1, seed=seed)


# One cached Trainer per (config, device, mesh), LRU-bounded: a sweep over
# many configs keeps at most _TRAINERS_MAX of them.
_TRAINERS: "OrderedDict[tuple, Trainer]" = OrderedDict()
_TRAINERS_MAX = 8


def get_trainer(cfg: SGBDTConfig, device: str | torch.device | None = None,
                mesh=None) -> Trainer:
    """The cached ``Trainer`` of ``cfg`` on ``device`` (the card unless one
    is given, the mesh's with a mesh) and ``mesh`` (None: single-device)."""
    dev = resolve_device(device if mesh is None or device is not None else mesh.device)
    key = (cfg, dev, mesh)
    trainer = _TRAINERS.get(key)
    if trainer is None:
        trainer = _TRAINERS[key] = Trainer(cfg, device=dev, mesh=mesh)
        while len(_TRAINERS) > _TRAINERS_MAX:
            _TRAINERS.popitem(last=False)
    else:
        _TRAINERS.move_to_end(key)
    return trainer


def clear_trainers() -> None:
    """Drop every cached Trainer."""
    _TRAINERS.clear()


def train(
    cfg: SGBDTConfig,
    data: BinnedData,
    schedule=("round_robin", 1),
    seed: int = 0,
    eval_every: int = 0,
    eval_fn: Callable[[TrainState, int], None] | None = None,
) -> TrainState:
    """Functional convenience over the cached Trainer of ``cfg`` on the
    data's device."""
    return get_trainer(cfg, data.bins.device).train(
        data, schedule, seed=seed, eval_every=eval_every, eval_fn=eval_fn)
