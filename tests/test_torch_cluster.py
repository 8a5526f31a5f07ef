"""The port's fleet simulation (§5.3) against its own oracle and the
reference.

Inside the port the contract is the reference's: the vectorized engine
(``repro_torch.serving.cluster_vector``, phase B on the CPU here: the
sweep step's plain version, the SPES step, the batched ARIMA fit) equals
the per-event oracle (``ClusterSim`` with its policies on the CPU) bit for
bit in cold %, latencies and every per-worker counter; wasted GB-minutes
and resident byte-seconds within rtol 1e-9 (float64 accumulation order).
The parametrisation is the reference's (``tests/test_cluster_conformance.
py``), plus SPES, a fleet long enough for apps to consult the forecaster,
custom app ids and the eviction tie-break past one million canonical ids.

Against the reference: the population columns, every ``AppTable`` column,
the FNV-1a hashes, the worker placement and the hedging streams are equal;
``run_cluster(engine="vector")`` of the reference equals the port on the
same tables for every policy without ARIMA (the same bounds as above);
both cluster goldens are met exactly.
"""
import dataclasses
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core import experiment as E
from repro_torch.core.workload import Trace
from repro_torch.core.workload_spec import (WorkloadSpec, azure_like,
                                            flash_crowd, population_columns)
from repro_torch.runtime.straggler import HedgePolicy
from repro_torch.serving import cluster_vector as CV
from repro_torch.serving.apptable import (AppTable, fnv1a64,
                                          fnv1a64_app_indices)
from repro_torch.serving.cluster_sim import ClusterSim
from repro_torch.serving.cluster_vector import (ClusterSpec, run_cluster,
                                                sweep_cluster)

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "golden")
CPU = dict(device="cpu")
INF = float("inf")
_COUNTERS = ("cold_starts", "warm_starts", "prewarms", "unloads",
             "evictions", "budget_overflows", "bytes_moved")
# the reference's fleets (test_cluster_conformance.py) and the workload
# generators they come from
AZURE = dict(n_apps=220, days=0.25, seed=11, max_events=24)
FLASH = dict(n_apps=160, days=0.25, seed=3, max_events=48)
# At 0.25 days no app can take the ARIMA branch (five idle times past the
# 240-minute range do not fit in 360 minutes), so this fleet runs three
# days: 20 apps consult the forecaster, 107 fits in all.
ARIMA_FLEET = dict(n_apps=60, days=3.0, seed=5, max_events=16)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The ARIMA fit's many small elementwise operations gain nothing from
    intra-op threads and lose badly when test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.experimental
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                       raising=False)
        from repro.core import experiment
        from repro.core import workload_spec
        from repro.runtime import straggler
        from repro.serving import apptable, cluster_vector
        yield SimpleNamespace(E=experiment, ws=workload_spec,
                              straggler=straggler, apptable=apptable,
                              cv=cluster_vector)


@pytest.fixture(scope="module")
def azure_table():
    return AppTable.from_spec(azure_like(**AZURE))


@pytest.fixture(scope="module")
def flash_table():
    return AppTable.from_spec(flash_crowd(**FLASH))


@pytest.fixture(scope="module")
def arima_table():
    return AppTable.from_spec(azure_like(**ARIMA_FLEET))


def _oversubscribe(table, factor=40.0, budget=30e9):
    """Inflate model images ~``factor``x so per-worker assigned bytes
    oversubscribe ``budget`` several times over (single images stay under
    it, clearing the construction guard)."""
    wb = np.minimum((table.memory_mb * 2 ** 20 * factor).astype(np.int64),
                    np.int64(0.8 * budget))
    return dataclasses.replace(table, weight_bytes=wb)


def _assert_results_equal(vec, sca, err=""):
    np.testing.assert_array_equal(vec.cold_pct_per_app, sca.cold_pct_per_app,
                                  err_msg=err)
    np.testing.assert_array_equal(vec.latencies_s, sca.latencies_s,
                                  err_msg=err)
    np.testing.assert_allclose(vec.wasted_gb_minutes, sca.wasted_gb_minutes,
                               rtol=1e-9, err_msg=err)
    assert len(vec.stats_per_worker) == len(sca.stats_per_worker), err
    for w, (sv, ss) in enumerate(zip(vec.stats_per_worker,
                                     sca.stats_per_worker)):
        for key in _COUNTERS:
            assert sv[key] == ss[key], f"{err}: worker {w} {key}"
        np.testing.assert_allclose(sv["resident_byte_seconds"],
                                   ss["resident_byte_seconds"], rtol=1e-9,
                                   err_msg=f"{err}: worker {w}")
    assert vec.restored_mid_run == sca.restored_mid_run, err


def _conform(table, policy, cluster):
    vec = run_cluster(table, policy, cluster, engine="vector", **CPU)
    sca = run_cluster(table, policy, cluster, engine="scalar", **CPU)
    _assert_results_equal(vec, sca,
                          err=f"{type(policy).__name__}/{cluster.name}")
    return vec


def _ref_spec(ref, spec):
    """The reference's twin of a port PolicySpec (the same fields)."""
    return getattr(ref.E, type(spec).__name__)(**dataclasses.asdict(spec))


def _ref_cluster(ref, cluster):
    hedge = None if cluster.hedge is None else \
        ref.straggler.HedgePolicy(**dataclasses.asdict(cluster.hedge))
    fields = dataclasses.asdict(cluster)
    fields["hedge"] = hedge
    return ref.cv.ClusterSpec(**fields)


# --------------------------------------------------------------------------
# Columns, hashes, placement and stragglers against the reference
# --------------------------------------------------------------------------


@pytest.mark.parametrize("gen,kw", [("azure_like", AZURE),
                                    ("flash_crowd", FLASH)])
def test_population_columns_match_reference(ref, gen, kw):
    from repro_torch.core import workload_spec as ws
    got = population_columns(getattr(ws, gen)(**kw))
    want = ref.ws.population_columns(getattr(ref.ws, gen)(**kw))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert "population_columns" in ws.__all__
    with pytest.raises(ValueError, match="patterns"):
        population_columns(WorkloadSpec.uniform(8))


def _table_pair(ref, gen, kw, build):
    from repro_torch.core import workload_spec as ws
    port_spec, ref_spec = getattr(ws, gen)(**kw), getattr(ref.ws, gen)(**kw)
    if build == "from_spec":
        return (AppTable.from_spec(port_spec),
                ref.apptable.AppTable.from_spec(ref_spec))
    return (AppTable.from_trace(port_spec.materialize(eager=True)),
            ref.apptable.AppTable.from_trace(ref_spec.materialize(eager=True)))


@pytest.mark.parametrize("build", ["from_spec", "from_trace"])
@pytest.mark.parametrize("gen,kw", [("azure_like", AZURE),
                                    ("flash_crowd", FLASH)])
def test_apptable_columns_match_reference(ref, gen, kw, build):
    got, want = _table_pair(ref, gen, kw, build)
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, f.name
            np.testing.assert_array_equal(g, w, err_msg=f.name)
        else:
            assert g == w, f.name


def test_fnv1a64_matches_reference(ref):
    # widths 6, 7 and 8 (the %06d pattern grows past a million apps)
    idx = np.array([0, 5, 17, 999_999, 1_000_000, 10 ** 7 + 3, 12_345_678])
    got = fnv1a64_app_indices(idx)
    np.testing.assert_array_equal(got,
                                  ref.apptable.fnv1a64_app_indices(idx))
    assert got.dtype == np.uint64
    for i, h in zip(idx, got):
        s = f"app-{int(i):06d}"
        assert int(h) == fnv1a64(s) == ref.apptable.fnv1a64(s), s
    for s in ("", "a", "endpoint/ü", "app-12"):
        assert fnv1a64(s) == ref.apptable.fnv1a64(s), s
    with pytest.raises(ValueError, match="non-negative"):
        fnv1a64_app_indices(np.array([-1]))


@pytest.mark.parametrize("balancing", ["affinity", "hash"])
def test_worker_assignment_matches_reference_and_oracle(ref, balancing):
    got, want = _table_pair(ref, "azure_like", AZURE, "from_spec")
    for n_workers in (1, 5, 64):
        np.testing.assert_array_equal(
            got.worker_assignment(n_workers, balancing),
            want.worker_assignment(n_workers, balancing))
    sim = ClusterSim(got.to_registry(), E.FixedSpec(keep_alive=5.0),
                     ClusterSpec(n_workers=5, hbm_budget_bytes=INF,
                                 balancing=balancing).to_config(), **CPU)
    sim.run(got.to_trace())
    expect = got.worker_assignment(5, balancing)
    for i in range(got.n_apps):
        if got.counts[i] > 0:
            assert sim._assign[got.app_id(i)] == expect[i], i
    with pytest.raises(ValueError, match="balancing"):
        got.worker_assignment(5, "random")


def test_hedge_streams_match_reference(ref):
    ours = HedgePolicy()
    theirs = ref.straggler.HedgePolicy()
    u1, u2 = ours.event_uniforms(5000)
    v1, v2 = theirs.event_uniforms(5000)
    np.testing.assert_array_equal(u1, v1)
    np.testing.assert_array_equal(u2, v2)
    x = np.random.default_rng(4).uniform(0.05, 30.0, 5000)
    for enabled in (True, False):
        a = dataclasses.replace(ours, enabled=enabled)
        b = dataclasses.replace(theirs, enabled=enabled)
        np.testing.assert_array_equal(a.latency_from_uniforms(x, u1, u2),
                                      b.latency_from_uniforms(x, u1, u2))
        got = [a.effective_latency(1.5, np.random.default_rng(s))
               for s in range(200)]
        want = [b.effective_latency(1.5, np.random.default_rng(s))
                for s in range(200)]
        assert got == want


# --------------------------------------------------------------------------
# The vectorized engine against the port's oracle
# --------------------------------------------------------------------------


@pytest.mark.parametrize("policy,balancing", [
    (E.HybridSpec(), "affinity"),
    (E.HybridSpec(), "hash"),
    (E.HybridSpec(use_arima=False), "affinity"),
    (E.FixedSpec(keep_alive=20.0), "affinity"),
    (E.NoUnloadSpec(), "hash"),
    (E.SpesSpec(), "affinity"),
])
def test_conformance_azure(azure_table, policy, balancing):
    _conform(azure_table, policy,
             ClusterSpec(n_workers=7, hbm_budget_bytes=INF,
                         balancing=balancing))


def test_conformance_flash_crowd(flash_table):
    res = _conform(flash_table, E.HybridSpec(),
                   ClusterSpec(n_workers=5, hbm_budget_bytes=INF))
    assert res.latencies_s.size == flash_table.n_events


@pytest.fixture(scope="module")
def arima_oracle(arima_table):
    """The oracle's run of the ARIMA fleet, once for the module."""
    cluster = ClusterSpec(n_workers=4, hbm_budget_bytes=INF)
    return cluster, run_cluster(arima_table, E.HybridSpec(), cluster,
                                engine="scalar", **CPU)


def test_conformance_with_the_forecaster(arima_table, arima_oracle,
                                         monkeypatch):
    """Apps that consult the forecaster: phase B's batched fit gives the
    oracle's windows. Without the forecast overrides the engine parts from
    the oracle, so this fleet does exercise them."""
    cluster, sca = arima_oracle
    vec = run_cluster(arima_table, E.HybridSpec(), cluster, engine="vector",
                      **CPU)
    _assert_results_equal(vec, sca, err="HybridSpec() with forecasts")
    assert sum(s["prewarms"] for s in sca.stats_per_worker) > 0
    from repro_torch.forecast import replay
    monkeypatch.setattr(replay, "_apply_forecast_overrides",
                        lambda *a, **k: None)
    skipped = run_cluster(arima_table, E.HybridSpec(), cluster,
                          engine="vector", **CPU)
    with pytest.raises(AssertionError):
        _assert_results_equal(skipped, sca)


def test_forecast_keep_alive_is_the_forecasts(arima_table):
    """Phase B hands a pre-warm fire the forecast's own keep-alive, not
    the bound difference ``(pw + ka) - pw``."""
    from repro_torch.core import policy_math
    from repro_torch.forecast import replay
    hybrid = E.HybridSpec().to_config()
    times = arima_table.times.astype(np.float64)
    counts = arima_table.counts.astype(np.int64)
    la, ua, keep = CV._policy_windows(E.HybridSpec(), times, counts, 1 << 17,
                                      torch.device("cpu"))
    la2, ua2, branch = replay._scan_window_sequences(
        times, counts, hybrid, None, torch.device("cpu"), True)
    forecast = (la != la2) | (ua != ua2)
    assert forecast.any()
    # the case occurs: the bound difference is not the keep-alive there
    assert (keep[forecast] != (ua - la)[forecast]).any()
    pw = la[forecast]
    pred = pw / (1.0 - hybrid.arima_margin)
    np.testing.assert_allclose(keep[forecast], 2.0 * hybrid.arima_margin *
                               pred, rtol=1e-12)
    lo, hi = policy_math.window_bounds(pw, keep[forecast])
    np.testing.assert_array_equal(hi, ua[forecast])
    np.testing.assert_array_equal(keep[~forecast], (ua - la)[~forecast])


def test_forecaster_with_hedging_and_hash(arima_table):
    _conform(arima_table, E.HybridSpec(),
             ClusterSpec(n_workers=3, hbm_budget_bytes=INF,
                         balancing="hash", hedge=HedgePolicy()))


def test_hedging_parity(azure_table):
    # Same rank-indexed uniform streams in both engines: identical
    # stragglers, hence bit-equal latencies under hedging.
    hedged = ClusterSpec(n_workers=7, hbm_budget_bytes=INF,
                         hedge=HedgePolicy())
    res = _conform(azure_table, E.FixedSpec(keep_alive=15.0), hedged)
    plain = run_cluster(azure_table, E.FixedSpec(keep_alive=15.0),
                        ClusterSpec(n_workers=7, hbm_budget_bytes=INF),
                        engine="vector", **CPU)
    assert not np.array_equal(res.latencies_s, plain.latencies_s)


def test_checkpoint_at_zero_regression(azure_table):
    """checkpoint_at_minute=0.0 means "checkpoint at the first event"; both
    engines restore, and the round trip does not perturb the run."""
    base = dict(n_workers=6, hbm_budget_bytes=INF)
    ck0 = _conform(azure_table, E.HybridSpec(),
                   ClusterSpec(checkpoint_at_minute=0.0, **base))
    assert ck0.restored_mid_run
    plain = run_cluster(azure_table, E.HybridSpec(), ClusterSpec(**base),
                        engine="scalar", **CPU)
    assert not plain.restored_mid_run
    np.testing.assert_array_equal(ck0.cold_pct_per_app,
                                  plain.cold_pct_per_app)
    np.testing.assert_array_equal(ck0.latencies_s, plain.latencies_s)


def test_checkpoint_mid_and_past_end(azure_table):
    base = dict(n_workers=6, hbm_budget_bytes=INF)
    mid = _conform(azure_table, E.FixedSpec(keep_alive=10.0),
                   ClusterSpec(checkpoint_at_minute=100.0, **base))
    assert mid.restored_mid_run
    never = _conform(azure_table, E.FixedSpec(keep_alive=10.0),
                     ClusterSpec(checkpoint_at_minute=1e9, **base))
    assert not never.restored_mid_run


def _small_trace(times, duration=30.0):
    return Trace(specs=None,
                 times=[np.asarray(t, np.float64) for t in times],
                 duration_minutes=duration)


def test_eviction_pressure_conformance():
    # two 10 GB apps resident together on one 16 GB worker: both engines
    # evict the same victim at the same tick
    table = AppTable.from_trace(_small_trace([[0.0], [1.0]]),
                                exec_s=1.0, memory_mb=512.0,
                                weight_bytes=np.array([10e9, 10e9], np.int64))
    res = _conform(table, E.NoUnloadSpec(),
                   ClusterSpec(n_workers=1, hbm_budget_bytes=16e9))
    assert res.evictions >= 1
    assert res.budget_overflows == 0


@pytest.mark.parametrize("policy,balancing", [
    (E.HybridSpec(), "affinity"),
    (E.FixedSpec(keep_alive=20.0), "hash"),
    (E.NoUnloadSpec(), "affinity"),
    (E.SpesSpec(), "hash"),
])
def test_eviction_storm_conformance(flash_table, policy, balancing):
    # flash-crowd eviction storm: hundreds of soonest-expiry evictions a
    # worker, bit-identical across engines for every policy family
    res = _conform(_oversubscribe(flash_table), policy,
                   ClusterSpec(n_workers=3, hbm_budget_bytes=30e9,
                               balancing=balancing))
    assert res.evictions > 100


def test_eviction_storm_with_hedging(flash_table):
    res = _conform(_oversubscribe(flash_table), E.HybridSpec(),
                   ClusterSpec(n_workers=3, hbm_budget_bytes=30e9,
                               hedge=HedgePolicy()))
    assert res.evictions > 100


def test_checkpoint_mid_eviction_storm(flash_table):
    res = _conform(_oversubscribe(flash_table), E.HybridSpec(),
                   ClusterSpec(n_workers=3, hbm_budget_bytes=30e9,
                               checkpoint_at_minute=60.0))
    assert res.restored_mid_run
    assert res.evictions > 100


def test_eviction_storm_with_the_forecaster(arima_table):
    res = _conform(_oversubscribe(arima_table, factor=60.0, budget=20e9),
                   E.HybridSpec(),
                   ClusterSpec(n_workers=2, hbm_budget_bytes=20e9,
                               checkpoint_at_minute=2000.0))
    assert res.evictions > 10
    assert res.restored_mid_run


def test_custom_app_ids_tie_break_lexicographically(flash_table):
    """Equal expiries tie-break on the app-id string, as the oracle's heap
    pops them: custom ids (here in the reverse of index order) take their
    lexicographic ranks."""
    table = _oversubscribe(flash_table)
    n = table.n_apps
    ids = tuple(f"fn-{n - i:04d}" for i in range(n))
    custom = dataclasses.replace(table, app_ids=ids)
    np.testing.assert_array_equal(CV._app_tie_ranks(custom),
                                  np.arange(n)[::-1])
    np.testing.assert_array_equal(CV._app_tie_ranks(table), np.arange(n))
    for policy in (E.FixedSpec(keep_alive=20.0), E.NoUnloadSpec()):
        res = _conform(custom, policy,
                       ClusterSpec(n_workers=3, hbm_budget_bytes=30e9))
        assert res.evictions > 100


def test_tie_ranks_past_a_million_canonical_ids():
    """``app-1000000`` sorts before ``app-999999``: past six digits the
    canonical ids take their true lexicographic ranks."""
    n = 1_000_001
    table = AppTable(times=np.full((n, 1), np.inf, np.float32),
                     counts=np.zeros(n, np.int32),
                     exec_s=np.ones(n), memory_mb=np.ones(n),
                     weight_bytes=np.ones(n, np.int64),
                     app_hash=np.zeros(n, np.uint64), duration_minutes=1.0)
    ranks = CV._app_tie_ranks(table)
    assert ranks[1_000_000] < ranks[999_999]
    assert ranks[1_000_000] == ranks[100_000] + 1     # after "app-100000"
    assert sorted(ranks[:5]) == list(ranks[:5])
    small = dataclasses.replace(table, times=table.times[:1_000_000],
                                counts=table.counts[:1_000_000])
    np.testing.assert_array_equal(CV._app_tie_ranks(small),
                                  np.arange(1_000_000))


def test_screen_short_circuits_eviction_free_runs(azure_table, monkeypatch):
    # workers whose assigned bytes fit at once never enter the fixed-point
    # loop: poison the replay and run eviction-free fleets through it
    def _boom(*args, **kwargs):
        raise AssertionError(
            "fixed-point eviction replay ran on an eviction-free fleet")

    monkeypatch.setattr(CV, "_evict_worker", _boom)
    _conform(azure_table, E.FixedSpec(keep_alive=10.0),
             ClusterSpec(n_workers=5, hbm_budget_bytes=INF))
    run_cluster(azure_table, E.FixedSpec(keep_alive=10.0),
                ClusterSpec(n_workers=5, hbm_budget_bytes=float(
                    azure_table.weight_bytes.sum())),
                engine="vector", **CPU)


def test_max_eviction_rounds_falls_back_to_scalar(flash_table):
    table = _oversubscribe(flash_table)
    cluster = ClusterSpec(n_workers=3, hbm_budget_bytes=30e9)
    with pytest.warns(RuntimeWarning, match="engine='scalar'"):
        res = run_cluster(table, E.FixedSpec(keep_alive=20.0), cluster,
                          engine="vector", max_eviction_rounds=0, **CPU)
    sca = run_cluster(table, E.FixedSpec(keep_alive=20.0), cluster,
                      engine="scalar", **CPU)
    _assert_results_equal(res, sca, err="max_eviction_rounds fallback")
    assert res.evictions >= 1


def test_single_image_over_budget_raises_in_both_engines():
    table = AppTable.from_trace(_small_trace([[0.0], [1.0]]),
                                exec_s=1.0, memory_mb=512.0,
                                weight_bytes=np.array([20e9, 1e9], np.int64))
    cluster = ClusterSpec(n_workers=1, hbm_budget_bytes=16e9)
    for engine in ("vector", "scalar"):
        with pytest.raises(ValueError, match="larger than the budget"):
            run_cluster(table, E.NoUnloadSpec(), cluster, engine=engine,
                        **CPU)


def test_eviction_screen_passes_on_interleaved_residency():
    # assigned bytes exceed the budget in sum, but the first app expires
    # before the third loads: the exact replay proves the run eviction-free
    table = AppTable.from_trace(
        _small_trace([[0.0], [10.0], [20.0]]),
        exec_s=1.0, memory_mb=512.0,
        weight_bytes=np.array([10e9, 1e9, 10e9], np.int64))
    res = _conform(table, E.FixedSpec(keep_alive=0.5),
                   ClusterSpec(n_workers=1, hbm_budget_bytes=16e9))
    assert res.evictions == 0


# --------------------------------------------------------------------------
# The port against the reference's vectorized engine
# --------------------------------------------------------------------------


@pytest.mark.parametrize("policy,fleet,cluster", [
    (E.HybridSpec(use_arima=False), "azure",
     ClusterSpec(n_workers=7, hbm_budget_bytes=INF)),
    (E.FixedSpec(keep_alive=20.0), "azure",
     ClusterSpec(n_workers=7, hbm_budget_bytes=INF, balancing="hash")),
    (E.NoUnloadSpec(), "azure",
     ClusterSpec(n_workers=7, hbm_budget_bytes=INF, hedge=HedgePolicy())),
    (E.SpesSpec(), "azure", ClusterSpec(n_workers=7, hbm_budget_bytes=INF)),
    (E.HybridSpec(use_arima=False), "storm",
     ClusterSpec(n_workers=3, hbm_budget_bytes=30e9, hedge=HedgePolicy())),
    (E.FixedSpec(keep_alive=20.0), "storm",
     ClusterSpec(n_workers=3, hbm_budget_bytes=30e9, balancing="hash")),
    (E.SpesSpec(), "storm",
     ClusterSpec(n_workers=3, hbm_budget_bytes=30e9,
                 checkpoint_at_minute=60.0)),
], ids=["hybrid-azure", "fixed-azure-hash", "nounload-azure-hedge",
        "spes-azure", "hybrid-storm-hedge", "fixed-storm-hash",
        "spes-storm-checkpoint"])
def test_matches_reference_without_arima(ref, policy, fleet, cluster):
    kw = AZURE if fleet == "azure" else FLASH
    gen = "azure_like" if fleet == "azure" else "flash_crowd"
    ours, theirs = _table_pair(ref, gen, kw, "from_spec")
    if fleet == "storm":
        ours = _oversubscribe(ours)
        theirs = _oversubscribe(theirs)
    got = run_cluster(ours, policy, cluster, **CPU)
    want = ref.cv.run_cluster(theirs, _ref_spec(ref, policy),
                              _ref_cluster(ref, cluster), engine="vector")
    _assert_results_equal(got, want, err=f"{policy.name}/{fleet}")
    if fleet == "storm":
        assert got.evictions > 100


@pytest.mark.parametrize("engine", ["scalar", "vector"])
@pytest.mark.parametrize("fname", ["cluster_small.json",
                                   "cluster_oversub.json"])
def test_golden_fleet(engine, fname):
    """The reference's cluster goldens (``tests/golden_traces.py``: both
    ``HybridSpec()``, ARIMA on), rebuilt in the port: met exactly."""
    with open(os.path.join(GOLDEN_DIR, fname)) as f:
        want = json.load(f)
    if fname == "cluster_small.json":
        workload = azure_like(120, days=0.25, seed=17, max_events=24)
        cluster = ClusterSpec(n_workers=6, hbm_budget_bytes=INF)
    else:
        table = AppTable.from_spec(flash_crowd(96, days=0.25, seed=23,
                                               max_events=32))
        wb = np.minimum((table.memory_mb * 2 ** 20 * 40).astype(np.int64),
                        np.int64(24e9))
        workload = dataclasses.replace(table, weight_bytes=wb)
        cluster = ClusterSpec(n_workers=3, hbm_budget_bytes=30e9)
    assert want["n_apps"] == workload.n_apps
    assert want["n_workers"] == cluster.n_workers
    res = run_cluster(workload, E.HybridSpec(), cluster, engine=engine,
                      **CPU)
    err = f"{engine} vs golden {fname}"
    np.testing.assert_array_equal(
        res.cold_pct_per_app, np.asarray(want["cold_pct_per_app"]),
        err_msg=err)
    for q, v in want["latency_pct"].items():
        assert res.latency_pct(float(q)) == v, f"{err}: p{q}"
    np.testing.assert_allclose(res.wasted_gb_minutes,
                               want["wasted_gb_minutes"], rtol=1e-9,
                               err_msg=err)
    for w, ws in enumerate(want["stats_per_worker"]):
        for key in _COUNTERS:
            assert res.stats_per_worker[w][key] == ws[key], \
                f"{err}: worker {w} {key}"
    if fname == "cluster_oversub.json":
        assert res.evictions == 458


# --------------------------------------------------------------------------
# Tables, the front door and the experiment grid
# --------------------------------------------------------------------------


def test_apptable_uniform_spec_needs_metadata():
    with pytest.raises(ValueError, match="patterns"):
        AppTable.from_spec(WorkloadSpec.uniform(8))
    tab = AppTable.from_spec(WorkloadSpec.uniform(8, seed=2), exec_s=0.5,
                             memory_mb=256.0)
    assert tab.n_apps == 8
    assert np.all(tab.exec_s == 0.5)


def test_apptable_padded_trace_needs_metadata():
    trace = _small_trace([[0.0, 5.0], [1.0]])
    with pytest.raises(ValueError, match="padded-only"):
        AppTable.from_trace(trace)
    tab = AppTable.from_trace(trace, exec_s=[0.1, 0.2], memory_mb=128.0)
    np.testing.assert_array_equal(tab.counts, [2, 1])
    back = tab.to_trace()
    assert back.specs is not None
    np.testing.assert_array_equal(back.events(0), [0.0, 5.0])
    reg = tab.to_registry()
    assert reg.get("app-000000").weight_bytes == 128 * 2 ** 20


def test_run_cluster_rejects_unknown_engine_and_devices(azure_table):
    """An unknown engine or device knob raises; the device counts the
    scale-out takes (``distributed.scaleout``: on the CPU, that many
    shards in turn) give the single-device result
    (``tests/test_torch_scaleout.py`` holds every family to it)."""
    with pytest.raises(ValueError, match="unknown cluster engine"):
        run_cluster(azure_table, E.HybridSpec(), engine="warp", **CPU)
    for devices in (0, -2, "all", True):
        with pytest.raises(ValueError, match="devices"):
            run_cluster(azure_table, E.FixedSpec(), devices=devices, **CPU)
    with pytest.raises(ValueError, match="devices"):
        sweep_cluster(azure_table, [E.FixedSpec()], devices=0, **CPU)
    cl = ClusterSpec(n_workers=3, hbm_budget_bytes=INF)
    want = run_cluster(azure_table, E.FixedSpec(), cl, **CPU)
    for devices in (1, 2, "auto"):
        _assert_results_equal(
            run_cluster(azure_table, E.FixedSpec(), cl, devices=devices,
                        **CPU), want)
    _assert_results_equal(
        sweep_cluster(azure_table, [E.FixedSpec()], [cl], devices=2,
                      **CPU).row(0, 0), want)


def test_sweep_cells_match_single_runs(azure_table):
    specs = [E.FixedSpec(keep_alive=10.0), E.NoUnloadSpec(), E.SpesSpec()]
    clusters = [ClusterSpec(n_workers=3, hbm_budget_bytes=INF),
                ClusterSpec(n_workers=3, hbm_budget_bytes=INF,
                            balancing="hash")]
    grid = sweep_cluster(azure_table, specs, clusters, **CPU)
    assert grid.shape == (1, 3, 2)
    for s, spec in enumerate(specs):
        for c, cl in enumerate(clusters):
            single = run_cluster(azure_table, spec, cl, **CPU)
            _assert_results_equal(grid.row(0, s, c), single,
                                  err=f"cell ({s},{c})")


def test_experiment_run_and_sweep_cluster_axis(azure_table, flash_table):
    cl = ClusterSpec(n_workers=4, hbm_budget_bytes=INF)
    opts = E.EngineOptions(device="cpu")
    single = run_cluster(azure_table, E.FixedSpec(keep_alive=10.0), cl,
                         **CPU)
    via_run = E.run(azure_table, E.FixedSpec(keep_alive=10.0), cluster=cl,
                    options=opts)
    _assert_results_equal(via_run, single, err="experiment.run(cluster=)")
    grid = E.sweep(traces=[azure_table], specs=[E.FixedSpec(keep_alive=10.0)],
                   clusters=[cl], options=opts)
    assert grid.shape == (1, 1, 1)
    _assert_results_equal(grid.row(0, 0, 0), single,
                          err="experiment.sweep(clusters=)")
    # a WorkloadSpec goes straight in, and the options reach the engine
    spec_run = E.run(azure_like(**AZURE), E.HybridSpec(), cluster=cl,
                     options=E.EngineOptions(device="cpu", app_chunk=16))
    _assert_results_equal(
        spec_run, run_cluster(azure_table, E.HybridSpec(), cl, **CPU),
        err="run(WorkloadSpec, cluster=, app_chunk=16)")
    storm = ClusterSpec(n_workers=3, hbm_budget_bytes=30e9)
    with pytest.warns(RuntimeWarning, match="engine='scalar'"):
        E.run(_oversubscribe(flash_table), E.FixedSpec(keep_alive=20.0),
              cluster=storm,
              options=E.EngineOptions(device="cpu", max_eviction_rounds=0))


def test_phase_seconds_are_recorded(azure_table):
    run_cluster(azure_like(**AZURE), E.HybridSpec(use_arima=False),
                ClusterSpec(n_workers=3, hbm_budget_bytes=INF), **CPU)
    assert sorted(CV.PHASE_SECONDS) == ["A", "B", "C", "D", "results",
                                        "table"]
    assert all(v >= 0 for v in CV.PHASE_SECONDS.values())


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_card_phase_b_equals_cpu(cuda):
    """A 200-app fleet with phase B on the card (the step kernel once per
    event column, the batched fit) and on the CPU: equal, field for field,
    with and without the forecaster, with evictions."""
    from repro_torch.kernels import histogram as H
    table = AppTable.from_spec(azure_like(200, days=3.0, seed=5,
                                          max_events=16))
    for policy, cluster in (
            (E.HybridSpec(), ClusterSpec(n_workers=8, hbm_budget_bytes=INF)),
            (E.HybridSpec(use_arima=False),
             ClusterSpec(n_workers=4, hbm_budget_bytes=30e9))):
        tab = table if np.isinf(cluster.hbm_budget_bytes) \
            else _oversubscribe(table)
        before = H.LAUNCHES
        card = run_cluster(tab, policy, cluster, device=cuda)
        assert H.LAUNCHES > before
        host = run_cluster(tab, policy, cluster, **CPU)
        _assert_results_equal(card, host, err=policy.name)
