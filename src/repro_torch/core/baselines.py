"""Closed-form speedup models (twin of ``repro.core.baselines``): Eq. 13
and the fork-join counterparts.

These are the napkin-math companions to the event simulator: the paper's
scalability upper bound  #workers < T(BuildTree) / T(Comm + BuildTarget)
(Eq. 13) says async speedup is linear until the server saturates, then flat.
The sync models capture Amdahl + barrier + comm growth. The benchmark
harness overlays these curves on the simulated ones.
"""
from __future__ import annotations

import numpy as np


def speedup_model_async(
    workers: np.ndarray, t_build: float, t_comm: float, t_server: float
) -> np.ndarray:
    """Eq. 13: linear until the server pipeline saturates.

    With W workers, trees arrive every t_build/W on average; the server needs
    t_server + t_comm per tree. Throughput = min(W / t_build, 1 / (t_server +
    t_comm)); speedup relative to serial throughput 1 / (t_build + t_server).
    """
    workers = np.asarray(workers, float)
    serial = 1.0 / (t_build + t_server + t_comm)
    cap = 1.0 / max(t_server + t_comm, 1e-12)
    rate = np.minimum(workers / t_build, cap)
    return rate / serial


def max_workers_bound(t_build: float, t_comm: float, t_server: float) -> float:
    """The paper's Eq. 13 bound on useful worker count."""
    return t_build / max(t_comm + t_server, 1e-12)


def speedup_model_sync(
    workers: np.ndarray,
    t_build: float,
    t_comm: float,
    t_server: float,
    parallel_fraction: float = 0.9,
    straggler_factor: float = 0.15,
) -> np.ndarray:
    """LightGBM-style fork-join: Amdahl + log-comm + straggler tax.

    E[max of W lognormals] grows ~ (1 + straggler_factor * log W); the
    barrier pays it every round.
    """
    w = np.asarray(workers, float)
    serial_round = t_build + t_server
    par = t_build * parallel_fraction / w * (1.0 + straggler_factor * np.log(np.maximum(w, 1)))
    rest = t_build * (1 - parallel_fraction) + t_server
    comm = np.where(w > 1, t_comm * np.log2(np.maximum(w, 2)), 0.0)
    return serial_round / (par + rest + comm)


def speedup_model_dimboost(
    workers: np.ndarray,
    t_build: float,
    t_comm: float,
    t_server: float,
    parallel_fraction: float = 0.85,
) -> np.ndarray:
    """DimBoost: centralized PS aggregation — comm cost linear in W."""
    w = np.asarray(workers, float)
    serial_round = t_build + t_server
    par = t_build * parallel_fraction / w
    rest = t_build * (1 - parallel_fraction) + t_server
    comm = np.where(w > 1, t_comm * 0.5 * w, 0.0)
    return serial_round / (par + rest + comm)
