"""Event-driven parameter-server cluster simulator (twin of
``repro.core.simulator``; numpy only, the same draws bit for bit).

Wall-clock asynchrony is *modeled* here: a discrete-event simulation of
Algorithm 3's server/worker protocol with heterogeneous worker speeds,
per-build jitter, and network instability — the three effects the paper
blames for fork-join's poor scalability. The simulator emits (a) the
realized delay schedule k(j), which feeds the trainer (``train_async``),
and (b) makespans. Component times are passed in: a threaded run's
``RunTrace.cluster_spec`` measures them (``ps.runtime``).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    n_workers: int
    t_build: float  # mean tree-build time, reference worker (s)
    t_comm: float  # mean pull+push time per tree (s)
    t_server: float  # server: sample + target + fold per update (s)
    build_cv: float = 0.15  # lognormal per-build jitter
    comm_cv: float = 0.5  # network instability
    speed_spread: float = 0.25  # per-worker speed multiplier ~ LogN(0, spread)
    seed: int = 0


@dataclasses.dataclass
class SimResult:
    schedule: np.ndarray  # (n_trees,) k(j)
    makespan: float
    mean_staleness: float
    max_staleness: int
    server_busy_frac: float


def _lognormal(rng: np.random.Generator, mean: float, cv: float) -> float:
    if mean <= 0:
        return 0.0
    if cv <= 0:
        return mean
    sigma = np.sqrt(np.log(1.0 + cv * cv))
    mu = np.log(mean) - 0.5 * sigma * sigma
    return float(rng.lognormal(mu, sigma))


def simulate_async(spec: ClusterSpec, n_trees: int) -> SimResult:
    """Algorithm 3 timing: workers pull/build/push freely; server serializes
    target rebuilds. Returns the realized delay schedule and makespan."""
    rng = np.random.default_rng(spec.seed)
    speed = np.exp(rng.normal(0.0, spec.speed_spread, spec.n_workers))

    # Events: (time, seq, kind, worker, pulled_version). Kinds: 'push'.
    events: list[tuple[float, int, int, int]] = []
    seq = 0
    for w in range(spec.n_workers):
        pull = _lognormal(rng, spec.t_comm / 2, spec.comm_cv)
        build = _lognormal(rng, spec.t_build, spec.build_cv) * speed[w]
        push = _lognormal(rng, spec.t_comm / 2, spec.comm_cv)
        heapq.heappush(events, (pull + build + push, seq, w, 0))
        seq += 1

    schedule = np.zeros(n_trees, np.int32)
    server_free = 0.0
    server_busy = 0.0
    j = 0
    while j < n_trees:
        t_arrive, _, w, pulled_version = heapq.heappop(events)
        start = max(t_arrive, server_free)
        t_srv = _lognormal(rng, spec.t_server, spec.build_cv)
        server_free = start + t_srv
        server_busy += t_srv
        schedule[j] = pulled_version
        j += 1
        # Worker pulls the fresh version and starts its next build.
        pull = _lognormal(rng, spec.t_comm / 2, spec.comm_cv)
        build = _lognormal(rng, spec.t_build, spec.build_cv) * speed[w]
        push = _lognormal(rng, spec.t_comm / 2, spec.comm_cv)
        heapq.heappush(events, (server_free + pull + build + push, seq, w, j))
        seq += 1

    stale = np.arange(n_trees) - schedule
    return SimResult(
        schedule=schedule,
        makespan=server_free,
        mean_staleness=float(stale.mean()),
        max_staleness=int(stale.max()),
        server_busy_frac=server_busy / server_free,
    )


def staleness_stats(schedule) -> dict:
    """Mean/max staleness + histogram of a realized or simulated k(j)."""
    schedule = np.asarray(schedule)
    stale = np.arange(len(schedule)) - schedule
    taus, counts = np.unique(stale, return_counts=True)
    return {
        "mean_staleness": float(stale.mean()),
        "max_staleness": int(stale.max()),
        "histogram": {int(t): int(c) for t, c in zip(taus, counts)},
    }


def step_scale_stats(schedule, rho: float) -> dict:
    """Effective-step statistics of the adaptive rule on a k(j).

    The staleness-adaptive server deflates fold j's step by
    1 / (1 + 6*rho*tau_j); this summarizes the realized effective step a
    schedule implies — the quantity cross-validated between a threaded
    run's trace and the event model's predicted schedule for the same
    cluster geometry (``crossvalidate_schedule(..., adaptive_rho=...)``).
    """
    from repro_torch.ps.schedules import staleness_scales

    scales = staleness_scales(schedule, rho)
    return {
        "rho": float(rho),
        "mean_scale": float(scales.mean()),
        "min_scale": float(scales.min()),
    }


def simulate_elastic(
    spec: ClusterSpec,
    n_trees: int,
    membership: "Sequence[tuple[int, int]]" = (),
) -> SimResult:
    """``simulate_async`` with worker churn: the event model of the elastic
    runtime.

    ``membership`` is a sequence of ``(at_update, delta)`` pairs: when the
    server has folded ``at_update`` trees, ``delta`` workers join (> 0, new
    worker ids with freshly drawn speeds) or leave (< 0, the most recently
    added live workers stop pulling new work; their in-flight build is
    discarded — crash semantics, matching ``ps.runtime.FaultPlan``).
    Predicts the staleness distribution of a join/leave/crash run so a
    recorded elastic trace has a model to cross-validate against.
    """
    rng = np.random.default_rng(spec.seed)
    membership = sorted((int(j), int(d)) for j, d in membership)
    if any(j < 0 for j, _ in membership):
        raise ValueError("membership events need at_update >= 0")

    def draw_speed():
        return float(np.exp(rng.normal(0.0, spec.speed_spread)))

    def cycle(mean_scale: float) -> float:
        pull = _lognormal(rng, spec.t_comm / 2, spec.comm_cv)
        build = _lognormal(rng, spec.t_build, spec.build_cv) * mean_scale
        push = _lognormal(rng, spec.t_comm / 2, spec.comm_cv)
        return pull + build + push

    events: list[tuple[float, int, int, int]] = []
    seq = 0
    speed: dict[int, float] = {}
    live: list[int] = []
    next_worker = 0
    for _ in range(spec.n_workers):
        w = next_worker
        next_worker += 1
        speed[w] = draw_speed()
        live.append(w)
        heapq.heappush(events, (cycle(speed[w]), seq, w, 0))
        seq += 1

    schedule = np.zeros(n_trees, np.int32)
    server_free = 0.0
    server_busy = 0.0
    j = 0
    mi = 0
    while j < n_trees:
        if not events:
            raise RuntimeError(
                "no live workers left before the run finished — membership "
                "events removed everyone"
            )
        t_arrive, _, w, pulled_version = heapq.heappop(events)
        if w not in live:  # crashed while building: push discarded
            continue
        start = max(t_arrive, server_free)
        t_srv = _lognormal(rng, spec.t_server, spec.build_cv)
        server_free = start + t_srv
        server_busy += t_srv
        schedule[j] = pulled_version
        j += 1
        while mi < len(membership) and membership[mi][0] <= j:
            _, delta = membership[mi]
            mi += 1
            if delta > 0:
                for _ in range(delta):
                    nw = next_worker
                    next_worker += 1
                    speed[nw] = draw_speed()
                    live.append(nw)
                    heapq.heappush(
                        events, (server_free + cycle(speed[nw]), seq, nw, j)
                    )
                    seq += 1
            else:
                for _ in range(-delta):
                    if live:
                        live.pop()
        if w in live:  # pull fresh version, start next build
            heapq.heappush(
                events, (server_free + cycle(speed[w]), seq, w, j)
            )
            seq += 1

    stale = np.arange(n_trees) - schedule
    return SimResult(
        schedule=schedule,
        makespan=server_free,
        mean_staleness=float(stale.mean()),
        max_staleness=int(stale.max()),
        server_busy_frac=server_busy / max(server_free, 1e-12),
    )


def crossvalidate_schedule(
    schedule,
    spec: ClusterSpec,
    makespan: float | None = None,
    membership: Sequence[tuple[int, int]] = (),
    adaptive_rho: float = 0.0,
) -> dict:
    """Validate the event model against a *measured* run.

    ``schedule`` is a realized k(j) (e.g. ``ps.runtime.RunTrace.schedule``)
    and ``spec`` the cluster geometry measured from the same run; the
    simulator predicts a schedule for that geometry and both staleness
    distributions are reported side by side — the same shape of check
    Block-distributed GBT runs between its communication model and real
    cluster traces. ``membership`` forwards the run's worker churn to
    ``simulate_elastic``; ``adaptive_rho > 0`` adds realized-vs-predicted
    effective-step statistics under the staleness-adaptive rule.
    """
    n = len(np.asarray(schedule))
    sim = (
        simulate_elastic(spec, n, membership)
        if membership
        else simulate_async(spec, n)
    )
    out = {
        "spec": dataclasses.asdict(spec),
        "realized": staleness_stats(schedule),
        "simulated": staleness_stats(sim.schedule),
        "simulated_makespan": float(sim.makespan),
    }
    if adaptive_rho:
        out["realized_step_scale"] = step_scale_stats(schedule, adaptive_rho)
        out["simulated_step_scale"] = step_scale_stats(
            sim.schedule, adaptive_rho
        )
    if makespan is not None:
        out["realized_makespan"] = float(makespan)
        out["makespan_ratio"] = float(makespan) / max(float(sim.makespan), 1e-12)
    return out


def simulate_sync(
    spec: ClusterSpec,
    n_trees: int,
    parallel_fraction: float = 0.9,
    comm_model: str = "allreduce",  # 'allreduce' (LightGBM) | 'central' (DimBoost)
) -> float:
    """Fork-join makespan: every round barriers on the slowest worker.

    ``parallel_fraction`` is the share of the tree build that the framework
    actually parallelizes (LightGBM feature-parallel distributes the
    histogram/feature scan, ~90% of the build; the serial remainder plus
    the per-round barrier is the paper's explanation for its 5-7x ceiling).
    'allreduce' comm grows ~log W; 'central' (parameter-server aggregation,
    DimBoost) grows ~linearly in W — the server-burden bottleneck.
    """
    rng = np.random.default_rng(spec.seed + 1)
    speed = np.exp(rng.normal(0.0, spec.speed_spread, spec.n_workers))
    total = 0.0
    w = spec.n_workers
    for _ in range(n_trees):
        shares = np.array(
            [
                _lognormal(rng, spec.t_build * parallel_fraction / w, spec.build_cv)
                * speed[i]
                for i in range(w)
            ]
        )
        serial = _lognormal(rng, spec.t_build * (1 - parallel_fraction), spec.build_cv)
        if w > 1:
            if comm_model == "allreduce":
                comm = _lognormal(rng, spec.t_comm * np.log2(w), spec.comm_cv)
            else:
                comm = _lognormal(rng, spec.t_comm * 0.5 * w, spec.comm_cv)
        else:
            comm = 0.0
        total += shares.max() + serial + comm + spec.t_server
    return total
