"""The port's optimizers and delayed-gradient wrapper against the JAX package.

Both packages take the same random nested trees (numpy, seeded) and the
same gradients for five steps; the port updates in place, the reference
builds new trees. Tolerance: rtol 1e-6, atol 1e-7 on parameters and
moments (the same f32 roundings in the same places; global-norm and pow
results may differ in the last ulp). The delayed wrapper's warm-up must
leave the parameters bitwise unchanged and the inner step at 0, and
``staleness_step_scale`` must be exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models as JM
import repro.optim as JO
import repro_torch.configs as tconfigs
import repro_torch.optim as TO
from repro_torch.convert import lm_params_from_numpy, opt_state_from_numpy
from repro_torch.optim.optimizers import tree_leaves

SHAPES = {"w": (6, 5), "blk": {"a": (4,), "b": (3, 2, 4)}, "s": ()}
STEPS = 5


def _tree(rng, shapes, scale=1.0):
    return {k: _tree(rng, v, scale) if isinstance(v, dict)
            else (scale * rng.standard_normal(v)).astype(np.float32)
            for k, v in shapes.items()}


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict) else torch.tensor(v) for k, v in tree.items()}


def _leaves(tree) -> list:
    """A torch tree's leaves in ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _close(got, want, rtol=1e-6, atol=1e-7):
    got, want = _leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol, atol=atol)


def _run(make, steps=STEPS, seed=0, check=None):
    """``steps`` steps of the twin optimizers ``make(pkg)`` on one random
    tree and one gradient stream; returns both packages' params and state."""
    rng = np.random.default_rng(seed)
    p0 = _tree(rng, SHAPES)
    grads = [_tree(rng, SHAPES, 0.5) for _ in range(steps)]
    jopt, topt = make(JO), make(TO)
    pj, pt = jax.tree.map(jnp.asarray, p0), _torch(p0)
    sj, st = jopt.init(pj), topt.init(pt)
    for i, g in enumerate(grads):
        uj, sj = jopt.update(jax.tree.map(jnp.asarray, g), sj, pj)
        pj = JO.apply_updates(pj, uj)
        before = [p.clone() for p in tree_leaves(pt)]
        ut, st = topt.update(_torch(g), st, pt)
        pt = TO.apply_updates(pt, ut)
        _close(pt, pj)
        if check is not None:
            check(i, before, pt, st)
    return pj, sj, pt, st


@pytest.mark.parametrize("make", [
    lambda O: O.sgd(0.1),
    lambda O: O.sgd(0.1, momentum=0.9),
    lambda O: O.adam(O.cosine_schedule(3e-2, 2, STEPS)),
    lambda O: O.adamw(1e-2, weight_decay=0.1, max_grad_norm=1.0),
    lambda O: O.chain(O.scale(0.5), O.clip_by_global_norm(0.3), O.add_decayed_weights(0.01),
                      O.sgd(0.2)),
], ids=["sgd", "sgd-momentum", "adam-cosine", "adamw-clip-decay", "chain"])
def test_transform_matches_reference(make):
    pj, sj, pt, st = _run(make)
    _close(st, sj)


def test_adam_state_layout():
    _, sj, _, st = _run(lambda O: O.adam(1e-2))
    assert st.step.dtype == torch.int32 and int(st.step) == int(sj.step) == STEPS
    assert all(m.dtype == torch.float32 for m in tree_leaves((st.mu, st.nu)))


def test_delayed_gradient_tau_0_is_the_inner_optimizer():
    inner = TO.adamw(1e-2, max_grad_norm=1.0)
    assert TO.delayed_gradient(inner, 0) is inner
    with pytest.raises(ValueError):
        TO.delayed_gradient(inner, -1)


@pytest.mark.parametrize("tau", [1, 3])
def test_delayed_gradient_matches_reference(tau):
    def check(i, before, params, state):
        inner_step = int(state.inner[-1].step)
        if i < tau:  # warm-up: exactly no update, the inner state frozen
            assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(params)))
            assert inner_step == 0
        else:
            assert inner_step == i - tau + 1
        assert int(state.step) == i + 1

    def make(O):
        return O.delayed_gradient(O.adamw(3e-2 * O.staleness_step_scale(tau, 0.3),
                                          weight_decay=0.01, max_grad_norm=1.0), tau)

    pj, sj, pt, st = _run(make, check=check)
    _close(st.ring, sj.ring)
    _close((st.inner[-1].mu, st.inner[-1].nu), (sj.inner[-1].mu, sj.inner[-1].nu))


@pytest.mark.parametrize("tau,rho,od", [(0, 0.3, 0.0), (4, 0.3, 0.0), (3, 0.1, 2.5)])
def test_staleness_step_scale_is_exact(tau, rho, od):
    assert TO.staleness_step_scale(tau, rho, od) == JO.staleness_step_scale(tau, rho, od)


def test_cosine_schedule():
    jl, tl = JO.cosine_schedule(1e-3, 5, 40), TO.cosine_schedule(1e-3, 5, 40)
    for step in (0, 1, 4, 5, 6, 20, 39, 40, 55):
        np.testing.assert_allclose(float(tl(torch.tensor(step, dtype=torch.int32))),
                                   float(jl(jnp.asarray(step, jnp.int32))), rtol=1e-6)


def test_opt_state_from_numpy_continues_the_reference():
    """Two reference steps of the delayed AdamW recipe on reduced
    granite-3-2b's parameter tree, carried across mid-run; two more steps
    in each package then agree."""
    cfg_j = jconfigs.get("granite-3-2b").reduced()
    cfg_t = tconfigs.get("granite-3-2b").reduced()

    def make(O):
        return O.delayed_gradient(O.adamw(1e-2, weight_decay=0.01, max_grad_norm=1.0), 1)

    jopt, topt = make(JO), make(TO)
    pj = JM.init_params(cfg_j, jax.random.PRNGKey(0))
    sj = jopt.init(pj)
    rng = np.random.default_rng(1)

    def grad():
        return jax.tree.map(lambda p: (0.01 * rng.standard_normal(p.shape)).astype(np.float32),
                            pj)
    for _ in range(2):
        uj, sj = jopt.update(jax.tree.map(jnp.asarray, grad()), sj, pj)
        pj = JO.apply_updates(pj, uj)
    pt = lm_params_from_numpy(cfg_t, jax.tree.map(np.asarray, pj), device="cpu")
    st = opt_state_from_numpy(cfg_t, jax.tree.map(np.asarray, sj), pt)
    assert isinstance(st, TO.DelayedState) and int(st.step) == 2
    assert int(st.inner[-1].step) == 1
    for _ in range(2):
        g = grad()
        uj, sj = jopt.update(jax.tree.map(jnp.asarray, g), sj, pj)
        pj = JO.apply_updates(pj, uj)
        ut, st = topt.update(lm_params_from_numpy(cfg_t, g, device="cpu"), st, pt)
        pt = TO.apply_updates(pt, ut)
    _close(pt, pj)
    _close((st.ring, st.inner[-1].mu, st.inner[-1].nu),
           (sj.ring, sj.inner[-1].mu, sj.inner[-1].nu))


def test_opt_state_from_numpy_refuses_other_shapes():
    cfg_j = jconfigs.get("granite-3-2b").reduced()
    cfg_t = tconfigs.get("granite-3-2b").reduced()
    params_j = JM.init_params(cfg_j, jax.random.PRNGKey(0))
    state = jax.tree.map(np.asarray, JO.adam(1e-2).init(params_j))
    params = {"embed": torch.zeros(1)}
    mu = dict(state.mu, embed=np.zeros((3, 3), np.float32))
    with pytest.raises(ValueError, match="embed: shape"):
        opt_state_from_numpy(cfg_t, state._replace(mu=mu), params)
    with pytest.raises(TypeError, match="no port twin"):
        opt_state_from_numpy(cfg_t, {"mu": state.mu}, params)
