"""Bernoulli importance sampling — the paper's random variable Q.

Twin of ``repro.data.sampling``. Each of the m_i copies
of sample i is drawn with probability R; the weight m'_i = Binomial(m_i,
R) / R is an unbiased estimator of m_i. Draws come from an explicit
``torch.Generator``; they cannot reproduce ``jax.random``'s bits, so
parity tests inject the reference's draws instead.

Also here: the observables the scalability theory reads — the sparsity of
the Q' vector (Q'_i = any copy drawn), and the closed forms of Delta and
rho, in f32 as the reference computes them.
"""
from __future__ import annotations

import torch


def bernoulli_weights(
    gen: torch.Generator, rate: float, multiplicity: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """One sampling round: (m_prime (N,) f32, q_any (N,) bool)."""
    rate_t = torch.full_like(multiplicity, rate, dtype=torch.float32)
    counts = torch.binomial(multiplicity.float(), rate_t, generator=gen)
    return (counts / rate_t).float(), counts > 0


def _rate(rate, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(rate, dtype=torch.float32, device=like.device)


def q_sparsity(q_any: torch.Tensor) -> torch.Tensor:
    """Fraction of distinct samples present in the subdataset (density of Q')."""
    return q_any.float().mean()


def delta_max(rate, multiplicity: torch.Tensor) -> torch.Tensor:
    """Delta = max_i P(Q'_i = 1) = max_i 1 - (1 - R)^{m_i} (closed form)."""
    return (1.0 - (1.0 - _rate(rate, multiplicity)) ** multiplicity.float()).max()


def overlap_probability(rate, multiplicity: torch.Tensor) -> torch.Tensor:
    """rho = P(two independent subdatasets intersect): with p_i = 1 - (1 -
    R)^{m_i}, P(i in both) = p_i^2 and rho = 1 - prod_i (1 - p_i^2), summed
    in logs."""
    p = 1.0 - (1.0 - _rate(rate, multiplicity)) ** multiplicity.float()
    return 1.0 - torch.exp(torch.log1p(-torch.clamp(p * p, max=1.0 - 1e-7)).sum())


def diversity_stats(rate, multiplicity: torch.Tensor) -> dict[str, torch.Tensor]:
    """The asynch-SGBDT-requirement observables for a (dataset, rate) pair."""
    return {
        "delta": delta_max(rate, multiplicity),
        "rho": overlap_probability(rate, multiplicity),
        "expected_subdataset_density": (
            1.0 - (1.0 - _rate(rate, multiplicity)) ** multiplicity.float()).mean(),
    }
