"""Bernoulli importance sampling — the paper's random variable Q.

Twin of ``repro.data.sampling.bernoulli_weights``. Each of the m_i copies
of sample i is drawn with probability R; the weight m'_i = Binomial(m_i,
R) / R is an unbiased estimator of m_i. Draws come from an explicit
``torch.Generator``; they cannot reproduce ``jax.random``'s bits, so
parity tests inject the reference's draws instead.
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
