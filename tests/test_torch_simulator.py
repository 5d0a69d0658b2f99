"""The port's cluster simulator (``repro_torch.core.simulator``) against the
JAX package's: numpy only in both, so on the same arguments every output is
equal bit for bit (the seeded lognormal draws included), and the
``ClusterSpec`` schedule provider resolves to the same k(j)."""
import dataclasses

import numpy as np
import pytest

from repro.core import simulator as jsim
from repro.ps import schedules as jschedules
from repro_torch.core import simulator as tsim
from repro_torch.ps import schedules as tschedules

SPECS = [
    dict(n_workers=4, t_build=0.05, t_comm=0.01, t_server=0.002),
    dict(n_workers=16, t_build=0.2, t_comm=0.05, t_server=0.01, seed=3),
    dict(n_workers=1, t_build=0.1, t_comm=0.0, t_server=0.001, build_cv=0.0),
    dict(n_workers=8, t_build=0.03, t_comm=0.02, t_server=0.004, comm_cv=0.0,
         speed_spread=0.0, seed=11),
]


def _pair(kw):
    return jsim.ClusterSpec(**kw), tsim.ClusterSpec(**kw)


def _same_result(a, b):
    np.testing.assert_array_equal(a.schedule, b.schedule)
    assert a.schedule.dtype == b.schedule.dtype
    for name in ("makespan", "mean_staleness", "max_staleness", "server_busy_frac"):
        assert getattr(a, name) == getattr(b, name), name


@pytest.mark.parametrize("kw", SPECS)
def test_simulate_async_equals_the_reference(kw):
    j, t = _pair(kw)
    _same_result(jsim.simulate_async(j, 200), tsim.simulate_async(t, 200))
    assert dataclasses.asdict(j) == dataclasses.asdict(t)


@pytest.mark.parametrize("membership", [(), ((10, 2),), ((5, -1), (20, 3), (40, -2))])
def test_simulate_elastic_equals_the_reference(membership):
    j, t = _pair(SPECS[1])
    _same_result(jsim.simulate_elastic(j, 120, membership),
                 tsim.simulate_elastic(t, 120, membership))


def test_simulate_elastic_errors_as_the_reference():
    j, t = _pair(SPECS[0])
    for sim, spec in ((jsim, j), (tsim, t)):
        with pytest.raises(RuntimeError, match="no live workers"):
            sim.simulate_elastic(spec, 50, ((3, -4),))
        with pytest.raises(ValueError, match="at_update"):
            sim.simulate_elastic(spec, 50, ((-1, 1),))


@pytest.mark.parametrize("kw", SPECS)
@pytest.mark.parametrize("comm_model", ["allreduce", "central"])
def test_simulate_sync_equals_the_reference(kw, comm_model):
    j, t = _pair(kw)
    assert jsim.simulate_sync(j, 50, 0.9, comm_model) == tsim.simulate_sync(t, 50, 0.9,
                                                                             comm_model)


@pytest.mark.parametrize("rho", [0.0, 0.05, 0.3])
def test_staleness_and_step_scale_stats_equal_the_reference(rho):
    sched = jsim.simulate_async(jsim.ClusterSpec(**SPECS[1]), 300).schedule
    assert jsim.staleness_stats(sched) == tsim.staleness_stats(sched)
    assert jsim.step_scale_stats(sched, rho) == tsim.step_scale_stats(sched, rho)


@pytest.mark.parametrize("membership,rho", [((), 0.0), (((8, 1), (30, -1)), 0.1)])
def test_crossvalidate_schedule_equals_the_reference(membership, rho):
    sched = jschedules.worker_round_robin(64, 4)
    j, t = _pair(SPECS[0])
    assert (jsim.crossvalidate_schedule(sched, j, makespan=1.5, membership=membership,
                                        adaptive_rho=rho)
            == tsim.crossvalidate_schedule(sched, t, makespan=1.5, membership=membership,
                                           adaptive_rho=rho))


@pytest.mark.parametrize("kw", SPECS[:2])
def test_cluster_spec_schedule_provider_equals_the_reference(kw):
    j, t = _pair(kw)
    np.testing.assert_array_equal(jschedules.resolve_schedule(j, 96),
                                  tschedules.resolve_schedule(t, 96))
