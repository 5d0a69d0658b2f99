"""The port's objective, sampling and schedules against the JAX package.

Elementwise float math (``sigmoid``, ``logaddexp``) is rounded differently
by the two frameworks, so those compare to 1e-6; integer schedules
compare exactly; the Bernoulli weights are drawn by different generators
and compare by their law.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.objectives import get_objective as jget_objective
from repro.ps import schedules as jsched
from repro_torch.data.sampling import bernoulli_weights
from repro_torch.objectives import BinaryLogistic, get_objective
from repro_torch.ps import schedules as tsched


def _yfw(seed=0, n=500):
    rng = np.random.default_rng(seed)
    y = (rng.random(n) < 0.4).astype(np.float32)
    f = (2.0 * rng.standard_normal(n)).astype(np.float32)
    w = rng.integers(1, 4, n).astype(np.float32)
    return y, f, w


def test_logistic_matches_jax():
    y, f, w = _yfw()
    t, j = get_objective("logistic"), jget_objective("logistic")
    ty, tf, tw = (torch.from_numpy(a) for a in (y, f, w))
    jy, jf, jw = (jnp.asarray(a) for a in (y, f, w))
    np.testing.assert_allclose(float(t.init_score(ty, tw)), float(j.init_score(jy, jw)),
                               rtol=1e-6)
    for got, want in zip(t.grad_hess(ty, tf), j.grad_hess(jy, jf)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(t.link(tf).numpy(), np.asarray(j.link(jf)), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(float(t.loss(ty, tf, tw)), float(j.loss(jy, jf, jw)),
                               rtol=1e-6)
    tm, jm = t.metrics(ty, tf, tw), j.metrics(jy, jf, jw)
    assert set(tm) == set(jm) == {"loss", "accuracy"}
    np.testing.assert_allclose(float(tm["accuracy"]), float(jm["accuracy"]), rtol=1e-6)


def test_logistic_gradient_is_the_autograd_gradient():
    y, f, _ = _yfw(1, 50)
    obj = BinaryLogistic()
    ft = torch.from_numpy(f).double().requires_grad_()
    total = obj.loss(torch.from_numpy(y).double(), ft) * len(f)  # the unnormalized sum
    (grad,) = torch.autograd.grad(total, ft)
    g, h = obj.grad_hess(torch.from_numpy(y).double(), ft.detach())
    torch.testing.assert_close(g, grad)
    assert (h > 0).all() and (h <= 1.0).all()


def test_registry():
    assert isinstance(get_objective("binary_logistic"), BinaryLogistic)
    obj = BinaryLogistic()
    assert get_objective(obj) is obj
    with pytest.raises(ValueError, match="unknown objective"):
        get_objective("multiclass:3")


@pytest.mark.parametrize("spec", [
    ("round_robin", 1), ("round_robin", 4), ("constant", 3), 5,
    [0, 0, 1, 1, 2, 4, 4, 6, 6, 8],
])
def test_schedules_match_jax(spec):
    np.testing.assert_array_equal(tsched.resolve_schedule(spec, 10),
                                  jsched.resolve_schedule(spec, 10))
    sched = tsched.resolve_schedule(spec, 10)
    assert tsched.max_staleness(sched) == jsched.max_staleness(sched)


@pytest.mark.parametrize("bad", [[0, 2, 0], [-1, 0, 1], ("round_robin", 0), ("warp", 2)])
def test_schedules_reject_bad_specs(bad):
    with pytest.raises(ValueError):
        tsched.resolve_schedule(bad, 3)


def test_bernoulli_weights_are_unbiased():
    """m' = Binomial(m, R) / R: values on the 1/R lattice, mean m."""
    gen = torch.Generator().manual_seed(0)
    mult = torch.tensor([1.0, 3.0, 10.0]).repeat(20_000)
    m_prime, q_any = bernoulli_weights(gen, 0.8, mult)
    assert m_prime.dtype == torch.float32
    counts = m_prime * 0.8
    torch.testing.assert_close(counts, counts.round(), rtol=0, atol=1e-5)
    assert torch.equal(q_any, counts.round() > 0)
    means = m_prime.reshape(-1, 3).mean(0)
    torch.testing.assert_close(means, torch.tensor([1.0, 3.0, 10.0]), rtol=0.02, atol=0)
    again, _ = bernoulli_weights(torch.Generator().manual_seed(0), 0.8, mult)
    assert torch.equal(m_prime, again)
