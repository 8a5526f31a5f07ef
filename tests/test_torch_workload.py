"""The port's workload generators against the reference's: the same spec and
seed must give the same arrays, bit for bit (padded times, counts, eager
per-app times and ``AppSpec`` s)."""
from types import SimpleNamespace

import numpy as np
import pytest

from repro_torch.core import workload as tw
from repro_torch.core import workload_spec as tws


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.experimental
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                       raising=False)
        from repro.core import workload, workload_spec
        yield SimpleNamespace(wl=workload, ws=workload_spec)


def _same_padded(a, b):
    (ta, ca), (tb, cb) = a.to_padded(), b.to_padded()
    assert ta.dtype == tb.dtype and ca.dtype == cb.dtype
    np.testing.assert_array_equal(ta, tb)
    np.testing.assert_array_equal(ca, cb)
    assert a.duration_minutes == b.duration_minutes


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("min_events", [0, 1])
def test_uniform(ref, seed, min_events):
    kw = dict(days=14.0, seed=seed, max_events=64, min_events=min_events)
    _same_padded(tws.WorkloadSpec.uniform(64, **kw).materialize(),
                 ref.ws.WorkloadSpec.uniform(64, **kw).materialize())


@pytest.mark.parametrize("seed", [0, 3])
def test_azure_like_padded(ref, seed):
    kw = dict(days=3.0, seed=seed, max_events=48)
    _same_padded(tws.azure_like(64, **kw).materialize(),
                 ref.ws.azure_like(64, **kw).materialize())


@pytest.mark.parametrize("name", sorted(tws.SCENARIOS))
def test_scenarios(ref, name):
    assert sorted(tws.SCENARIOS) == sorted(ref.ws.SCENARIOS)
    kw = dict(days=2.0, seed=5, max_events=32)
    _same_padded(tws.scenario(name, 48, **kw).materialize(),
                 ref.ws.scenario(name, 48, **kw).materialize())


def test_mixed_cohorts(ref):
    def spec(m):
        return m.WorkloadSpec.mix(
            [m.Cohort(name="low", weight=2.0, rate_log10_max=1.0),
             m.Cohort(name="timers", pattern_probs=(0.6, 0.2, 0.1, 0.1, 0.0))],
            n_apps=60, days=2.0, seed=11, max_events=40, min_events=1,
            weekend_factor=0.5)
    _same_padded(spec(tws).materialize(), spec(ref.ws).materialize())


def test_eager_and_generate_trace(ref):
    a = tws.azure_like(40, days=1.0, seed=2, max_events=None,
                       min_events=1).materialize(eager=True)
    b = ref.ws.azure_like(40, days=1.0, seed=2, max_events=None,
                          min_events=1).materialize(eager=True)
    assert [vars(s) for s in a.specs] == [vars(s) for s in b.specs]
    for x, y in zip(a.times, b.times):
        np.testing.assert_array_equal(x, y)
    c, d = tw.generate_trace(32, days=1.0, seed=4), \
        ref.wl.generate_trace(32, days=1.0, seed=4)
    _same_padded(c, d)
    assert [vars(s) for s in tw.sample_apps(32, seed=4)] == \
        [vars(s) for s in ref.wl.sample_apps(32, seed=4)]


@pytest.mark.parametrize("bad", [dict(n_apps=-1), dict(days=0.0),
                                 dict(max_events=0), dict(min_events=2),
                                 dict(generator="nope")])
def test_validation(ref, bad):
    with pytest.raises(ValueError):
        tws.WorkloadSpec(**bad).materialize()
    with pytest.raises(ValueError):
        ref.ws.WorkloadSpec(**bad).materialize()
