"""DelayedGradient — the paper's staleness mechanism as an optimizer wrapper
(twin of ``repro.optim.delayed``).

Asynch-SGBDT's server applies updates built from stale state F^{k(j)}
(Algorithm 3). For gradient optimizers the same object is a gradient that
was computed ``delay`` steps ago and arrives now: the wrapper keeps an f32
ring of the last ``delay`` gradients and hands the inner optimizer the one
pushed ``delay`` steps earlier. With ``delay = 0`` it is the identity
(tau = 0 is the serial trainer). ``staleness_step_scale`` is Proposition
1's step-length rule, v ~ 1 / (1 + 6 rho tau).

During warm-up (fewer than ``delay`` gradients pushed) the updates are
exactly zero and the inner state does not move (Adam's step stays 0), as
in Algorithm 3, where the first W trees are built from F^0 and arrive
later. The reference runs the inner update and discards it with a
``where``; the port's inner update works in place, so it is not run
during warm-up, which reads the step count on the host once a step. The
ring is written in place, like the inner optimizers' state
(``optimizers``' docstring).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.optim.optimizers import Optimizer, PyTree, tree_leaves, tree_map


class DelayedState(NamedTuple):
    step: torch.Tensor  # () int32: how many gradients have been pushed
    ring: PyTree  # each leaf (delay, *leaf.shape) f32: the buffered gradients
    inner: PyTree


def delayed_gradient(inner: Optimizer, delay: int) -> Optimizer:
    """Wrap ``inner`` so it consumes gradients ``delay`` steps stale."""
    if delay < 0:
        raise ValueError("delay must be >= 0")
    if delay == 0:
        return inner

    def init(params):
        ring = tree_map(lambda p: torch.zeros((delay,) + tuple(p.shape), dtype=torch.float32,
                                              device=p.device), params)
        device = tree_leaves(params)[0].device
        return DelayedState(step=torch.zeros((), dtype=torch.int32, device=device), ring=ring,
                            inner=inner.init(params))

    def update(grads, state, params):
        pushed = int(state.step)
        slot = pushed % delay
        warm = pushed >= delay
        # Pop the gradient pushed ``delay`` steps ago (in the fresh one's
        # dtype), then push the fresh one into its slot.
        stale = tree_map(lambda r, g: r[slot].to(g.dtype, copy=True), state.ring, grads) \
            if warm else None
        tree_map(lambda r, g: r[slot].copy_(g), state.ring, grads)
        if warm:
            updates, inner_state = inner.update(stale, state.inner, params)
        else:  # no update, and the inner state stays as it is
            updates = tree_map(lambda g: g.zero_(), grads)
            inner_state = state.inner
        return updates, DelayedState(step=state.step + 1, ring=state.ring, inner=inner_state)

    return Optimizer(init, update)


def staleness_step_scale(tau: int, rho: float, omega_delta: float = 0.0) -> float:
    """Proposition 1's step-length deflation for ``tau``-stale updates.

    v(tau) / v(0) = 1 / (1 + 6*rho*tau + 4*rho*tau^2 * Omega * Delta^{1/2}).
    ``omega_delta`` carries the Omega * sqrt(Delta) product (0 => drop the
    quadratic term, the high-diversity regime where the paper's requirements
    hold).
    """
    return 1.0 / (1.0 + 6.0 * rho * tau + 4.0 * rho * tau * tau * omega_delta)
