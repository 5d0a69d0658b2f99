"""Delay-schedule providers for the parameter-server engine (twin of
``repro.ps.schedules``, without the cluster-simulator provider).

Asynchrony is the version map k(j): server update j folds in a tree built
from F^{k(j)} (staleness j - k(j)).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


def constant_delay(n_trees: int, tau: int) -> np.ndarray:
    """k(j) = max(0, j - tau): every tree is exactly tau versions stale."""
    j = np.arange(n_trees)
    return np.maximum(0, j - tau).astype(np.int32)


def worker_round_robin(n_trees: int, n_workers: int) -> np.ndarray:
    """Steady state of W homogeneous workers: k(j) = max(0, j - W + 1).
    W = 1 is the serial trainer."""
    j = np.arange(n_trees)
    return np.maximum(0, j - n_workers + 1).astype(np.int32)


def max_staleness(schedule: np.ndarray) -> int:
    return int(np.max(np.arange(len(schedule)) - schedule))


def resolve_schedule(spec, n_trees: int) -> np.ndarray:
    """Normalize a schedule to a validated (n_trees,) int32 k(j).

    Accepted: an int array / sequence (a realized schedule),
    ``("constant", tau)``, ``("round_robin", W)``, a bare int W, or a
    callable ``f(n_trees) -> array``.
    """
    if isinstance(spec, int):
        spec = ("round_robin", spec)
    if isinstance(spec, tuple) and len(spec) == 2 and isinstance(spec[0], str):
        kind, arg = spec
        if kind == "constant":
            if int(arg) < 0:
                raise ValueError(f"constant delay needs tau >= 0, got {arg}")
            sched = constant_delay(n_trees, int(arg))
        elif kind == "round_robin":
            if int(arg) < 1:
                raise ValueError(f"round_robin needs >= 1 worker, got {arg}")
            sched = worker_round_robin(n_trees, int(arg))
        else:
            raise ValueError(f"unknown schedule kind {kind!r}")
    elif callable(spec):
        sched = np.asarray(spec(n_trees), np.int32)
    elif isinstance(spec, (np.ndarray, Sequence)) or hasattr(spec, "__array__"):
        sched = np.asarray(spec, np.int32)
    else:
        raise TypeError(f"cannot resolve schedule from {type(spec).__name__}")

    sched = np.asarray(sched, np.int32)
    if sched.shape != (n_trees,):
        raise ValueError(f"schedule shape {sched.shape} != ({n_trees},)")
    j = np.arange(n_trees)
    if (sched > j).any():
        raise ValueError("causality violation: k(j) > j in schedule")
    if (sched < 0).any():
        raise ValueError("negative version in schedule")
    return sched
