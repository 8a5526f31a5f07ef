"""The rest of the port's ``core/`` against the reference, on the CPU:
Welford (``core/welford.py``), the vectorised histogram helpers
(``core/histogram.py``), the two grouped percentile helpers of
``policy_math``, ``workload_spec.materialize_loop``, the ARIMA deprecation
shims (``core/arima.py``) and ``EngineOptions``' fields.

The integer and float32 helpers are held exactly equal to the reference's
on seeded numpy inputs (16 to 240 bins, idle times inside and outside the
range, inactive rows, rows past ``policy_math.MAX_SCALED_COUNT`` where the
int32 scaled compare wraps on both sides). The shims fit through the
port's batched ARIMA fit, so they are held to the reference's shims
within the fit's bounds of ``tests/test_torch_forecast_conformance.py``.
"""
import dataclasses
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core import histogram as H
from repro_torch.core import policy_math as PM
from repro_torch.core import welford as W
from repro_torch.core import workload_spec as WS
from repro_torch.core.experiment import EngineOptions
from test_torch_forecast_conformance import (AIC_TOL, PRED_TOL, SELECTION_DELTA,
                                             SHARE)

CPU = torch.device("cpu")
BINS = (16, 60, 240)


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
        import jax.numpy as jnp
        from repro.core import arima, experiment, histogram, policy_math
        from repro.core import welford, workload_spec
        yield SimpleNamespace(jnp=jnp, arima=arima, E=experiment,
                              H=histogram, PM=policy_math, W=welford,
                              WS=workload_spec)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# --------------------------------------------------------------------------
# Welford
# --------------------------------------------------------------------------


def test_scalar_cv_state_equals_reference(ref):
    rng = np.random.default_rng(0)
    mine, theirs = W.CVState(n_bins=60), ref.W.CVState(n_bins=60)
    counts = np.zeros(60, np.int64)
    for _ in range(300):
        b = int(rng.integers(0, 60))
        if counts[b] and rng.random() < 0.2:
            mine.remove(float(counts[b]))
            theirs.remove(float(counts[b]))
            counts[b] -= 1
        else:
            mine.update(float(counts[b]))
            theirs.update(float(counts[b]))
            counts[b] += 1
        assert (mine.sum_counts, mine.sum_sq_counts) == \
            (theirs.sum_counts, theirs.sum_sq_counts)
        assert mine.cv == theirs.cv


@pytest.mark.parametrize("n_bins", BINS)
def test_batched_cv_equals_reference(ref, n_bins):
    """cv_init/cv_update/cv_value step for step, and cv_from_counts, on
    seeded counts; float32 as in the reference."""
    jnp = ref.jnp
    rng = np.random.default_rng(n_bins)
    n = 257
    counts = np.zeros((n, n_bins), np.int32)
    mine = W.cv_init(n, device="cpu")
    theirs = ref.W.cv_init(n)
    for _ in range(40):
        b = rng.integers(0, n_bins, n)
        active = rng.random(n) < 0.7
        old = counts[np.arange(n), b]
        mine = W.cv_update(mine, _t(old), _t(active))
        theirs = ref.W.cv_update(theirs, jnp.asarray(old), jnp.asarray(active))
        counts[np.arange(n), b] += active
        for k in ("sum", "sum_sq"):
            np.testing.assert_array_equal(_np(mine[k]), np.asarray(theirs[k]))
        # the reference's cv_value raises (it calls the arrays' numpy
        # dtype object as a scalar type), so the port's is held to what it
        # computes: bin_count_cv in the accumulators' float32
        np.testing.assert_array_equal(
            _np(W.cv_value(mine, n_bins)),
            np.asarray(ref.PM.bin_count_cv(theirs["sum"], theirs["sum_sq"],
                                           n_bins, np.float32)))
    np.testing.assert_array_equal(
        _np(W.cv_from_counts(_t(counts))),
        np.asarray(ref.W.cv_from_counts(jnp.asarray(counts))))
    assert mine["sum"].dtype == torch.float32


def test_reference_cv_value_raises(ref):
    """ROADMAP "Known state of the reference": its ``cv_value`` passes
    ``state["sum"].dtype`` (a numpy dtype object) where ``bin_count_cv``
    calls its ``dtype`` argument as a scalar type."""
    with pytest.raises(TypeError, match="not callable"):
        ref.W.cv_value(ref.W.cv_init(3), 16)


def test_cv_init_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        W.cv_init(4)
    with pytest.raises(RuntimeError, match="is_available"):
        H.init_state(4, H.HistogramConfig())


# --------------------------------------------------------------------------
# The vectorised histogram helpers
# --------------------------------------------------------------------------


def _hist_cfg(n_bins):
    return H.HistogramConfig(bin_minutes=240.0 / n_bins * 0.5,
                             range_minutes=120.0, margin=0.15)


def _idle_times(rng, n, cfg):
    """Idle times inside and outside the range (and negative ones, which
    classify as neither), float32."""
    it = rng.uniform(-2.0, 1.3 * cfg.range_minutes, n)
    return it.astype(np.float32)


def _assert_state(mine, theirs):
    for field in H.HistogramState._fields:
        a, b = _np(getattr(mine, field)), np.asarray(getattr(theirs, field))
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)


@pytest.mark.parametrize("n_bins", BINS)
def test_record_and_windows_equal_reference(ref, n_bins):
    jnp = ref.jnp
    cfg = _hist_cfg(n_bins)
    rcfg = ref.H.HistogramConfig(**dataclasses.asdict(cfg))
    rng = np.random.default_rng(100 + n_bins)
    n = 131
    mine = H.init_state(n, cfg, device="cpu")
    theirs = ref.H.init_state(n, rcfg)
    _assert_state(mine, theirs)
    for _ in range(30):
        it = _idle_times(rng, n, cfg)
        active = rng.random(n) < 0.8
        mine = H.record_idle_times(mine, _t(it), _t(active), cfg)
        theirs = ref.H.record_idle_times(theirs, jnp.asarray(it),
                                         jnp.asarray(active), rcfg)
        _assert_state(mine, theirs)
        for a, b in zip(H.percentile_windows(mine, cfg),
                        ref.H.percentile_windows(theirs, rcfg)):
            np.testing.assert_array_equal(_np(a), np.asarray(b))
    assert int(mine.oob.sum()) > 0 and int(mine.total.sum()) > 0
    for pct, up in ((5.0, False), (99.0, True), (37.5, False)):
        np.testing.assert_array_equal(
            _np(H._weighted_percentile_bins(mine.counts, mine.total, pct,
                                            up)),
            np.asarray(ref.H._weighted_percentile_bins(
                theirs.counts, theirs.total, pct, up)))


@pytest.mark.parametrize("n_bins", BINS)
def test_cum_record_and_find_first_ge_equal_reference(ref, n_bins):
    jnp = ref.jnp
    cfg = _hist_cfg(n_bins)
    rcfg = ref.H.HistogramConfig(**dataclasses.asdict(cfg))
    rng = np.random.default_rng(200 + n_bins)
    n = 97
    cum = torch.zeros((n, n_bins), dtype=torch.int32)
    rcum = jnp.zeros((n, n_bins), jnp.int32)
    for _ in range(25):
        it = _idle_times(rng, n, cfg)
        active = rng.random(n) < 0.8
        out = H.cum_record_idle_times(cum, _t(it), _t(active), cfg)
        want = ref.H.cum_record_idle_times(rcum, jnp.asarray(it),
                                           jnp.asarray(active), rcfg)
        for a, b in zip(out, want):
            np.testing.assert_array_equal(_np(a), np.asarray(b))
        cum, rcum = out[0], want[0]
    thr = rng.integers(0, 40, n).astype(np.int32)
    np.testing.assert_array_equal(
        _np(H.find_first_ge(cum, _t(thr))),
        np.asarray(ref.H.find_first_ge(rcum, jnp.asarray(thr))))


@pytest.mark.parametrize("n_bins", BINS)
def test_helpers_equal_reference_past_max_scaled_count(ref, n_bins):
    """Rows whose counts pass ``MAX_SCALED_COUNT``: the int32 scaled
    compare wraps, on both sides alike."""
    jnp = ref.jnp
    edge = PM.MAX_SCALED_COUNT
    rng = np.random.default_rng(300 + n_bins)
    n = 6
    counts = rng.integers(0, 50, (n, n_bins)).astype(np.int32)
    counts[0, n_bins // 2] = edge                  # at the edge
    counts[1, 0] = edge + 1                        # one past it
    counts[2, :] = 2 * edge // n_bins + 1          # past it, spread out
    total = counts.sum(1, dtype=np.int64).astype(np.int32)
    cum = np.cumsum(counts, 1, dtype=np.int64).astype(np.int32)
    cfg = _hist_cfg(n_bins)
    rcfg = ref.H.HistogramConfig(**dataclasses.asdict(cfg))
    zeros = np.zeros(n, np.float32)
    mine = H.HistogramState(_t(counts), _t(np.zeros(n, np.int32)),
                            _t(total), _t(zeros), _t(zeros))
    theirs = ref.H.HistogramState(jnp.asarray(counts),
                                  jnp.zeros(n, jnp.int32),
                                  jnp.asarray(total), jnp.asarray(zeros),
                                  jnp.asarray(zeros))
    for a, b in zip(H.percentile_windows(mine, cfg),
                    ref.H.percentile_windows(theirs, rcfg)):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    thr = np.asarray([edge, edge + 1, edge // 3, 5, 0, edge], np.int32)
    np.testing.assert_array_equal(
        _np(H.find_first_ge(_t(cum), _t(thr))),
        np.asarray(ref.H.find_first_ge(jnp.asarray(cum), jnp.asarray(thr))))


def test_scale_raw_threshold_equals_reference(ref):
    jnp = ref.jnp
    for x in (0, 7, PM.MAX_SCALED_COUNT, np.int32(12)):
        assert PM.scale_raw_threshold(x) == ref.PM.scale_raw_threshold(x)
        assert type(PM.scale_raw_threshold(x)) is \
            type(ref.PM.scale_raw_threshold(x))
    arr = np.asarray([0, 3, 214748], np.int32)
    np.testing.assert_array_equal(PM.scale_raw_threshold(arr),
                                  ref.PM.scale_raw_threshold(arr))
    got = PM.scale_raw_threshold(_t(arr))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        _np(got), np.asarray(ref.PM.scale_raw_threshold(jnp.asarray(arr))))


@pytest.mark.parametrize("n_bins", BINS)
def test_first_bin_ge_scaled_grouped_equals_reference(ref, n_bins):
    """Exactly the reference's, and the ungrouped search over the gathered
    rows, on seeded group states and thresholds."""
    jnp = ref.jnp
    rng = np.random.default_rng(400 + n_bins)
    G, W_, n = 3, 7, 53
    gcum = np.cumsum(rng.integers(0, 4, (G, n, n_bins)), -1).astype(np.int32)
    group = rng.integers(0, G, W_).astype(np.int32)
    thr = (rng.integers(0, 4 * n_bins, (W_, n)) * PM.PCT_SCALE
           // 3).astype(np.int32)
    got = PM.first_bin_ge_scaled_grouped(_t(gcum), _t(group), _t(thr))
    want = ref.PM.first_bin_ge_scaled_grouped(
        jnp.asarray(gcum), jnp.asarray(group), jnp.asarray(thr))
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    np.testing.assert_array_equal(
        _np(got), _np(PM.first_bin_ge_scaled(_t(gcum[group]), _t(thr),
                                             gather=True)))


# --------------------------------------------------------------------------
# materialize_loop
# --------------------------------------------------------------------------


@pytest.mark.parametrize("scenario,kw", [
    ("azure_like", dict(days=2.0, seed=8, max_events=32)),
    ("bursty", dict(days=1.0, seed=2, max_events=16)),
    ("timer_heavy", dict(days=3.0, seed=5, max_events=48, min_events=1)),
])
def test_materialize_loop_equals_reference(ref, scenario, kw):
    mine = WS.materialize_loop(WS.SCENARIOS[scenario](60, **kw))
    theirs = ref.WS.materialize_loop(ref.WS.SCENARIOS[scenario](60, **kw))
    for a, b in zip(mine.to_padded(), theirs.to_padded()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert mine.duration_minutes == theirs.duration_minutes


def test_materialize_loop_agrees_with_materialize_distributionally():
    """The per-app baseline is the same workload class as the vectorised
    engine (separate random streams, so not the same draws): comparable
    event mass and the same padded width; the reference's check."""
    spec = WS.azure_like(400, days=2.0, seed=8, max_events=32)
    cf = spec.materialize().to_padded()[1]
    cs = WS.materialize_loop(spec).to_padded()[1]
    assert cs.shape == cf.shape
    assert np.abs(cf.mean() - cs.mean()) / max(cs.mean(), 1e-9) < 0.35
    with pytest.raises(ValueError, match="patterns"):
        WS.materialize_loop(WS.WorkloadSpec.uniform(10))


# --------------------------------------------------------------------------
# The ARIMA deprecation shims
# --------------------------------------------------------------------------


def _shim(module, name):
    with pytest.warns(DeprecationWarning) as rec:
        obj = getattr(module, name)
    return obj, str(rec[0].message)


def _series(n=12, seed=7):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        length = int(rng.integers(12, 90))
        if i % 3 == 0:
            y = 100.0 + np.cumsum(rng.normal(0.0, 5.0, length))
        elif i % 3 == 1:
            y = rng.exponential(300.0, length)
        else:
            y = 200.0 + 40.0 * np.sin(np.arange(length) / 2.0) \
                + rng.normal(0.0, 3.0, length)
        out.append(y)
    return out


def test_shims_warn_with_their_replacement():
    from repro_torch.core import arima
    from repro_torch.forecast import forecaster
    for name in arima.__all__:
        obj, msg = _shim(arima, name)
        assert "repro_torch.forecast" in msg and name in msg
    assert _shim(arima, "ArimaForecaster")[0] is forecaster.ArimaForecaster
    with pytest.raises(AttributeError):
        arima.no_such_name


def test_shims_return_what_their_replacement_returns():
    from repro_torch.core import arima
    from repro_torch.forecast import ORDER_GRID, fit_window
    fit_arima = _shim(arima, "fit_arima")[0]
    auto_arima = _shim(arima, "auto_arima")[0]
    for y in _series(4):
        fit = fit_window(y, device="cpu")
        for idx, order in enumerate(ORDER_GRID):
            m = fit_arima(y, order, device="cpu")
            if not fit.valid[0, idx]:
                assert m is None
                continue
            assert m.order == order and m.aic == float(fit.aic[0, idx])
            assert m.mu == float(fit.mu[0, idx])
        best = min((i for i in range(len(ORDER_GRID)) if fit.valid[0, i]),
                   key=lambda i: (float(fit.aic[0, i]), i))
        assert auto_arima(y, device="cpu").order == ORDER_GRID[best]
    with pytest.raises(ValueError, match="outside the supported grid"):
        fit_arima(_series(1)[0], (3, 0, 0), device="cpu")


def test_shims_within_the_fit_bounds_of_the_reference(ref):
    """fit_arima over the order grid and auto_arima against the
    reference's shims: AIC and one-step forecasts within the fit's bounds
    (at most ``SHARE`` of the pairs beyond them), the selected order equal
    wherever the reference's two best AICs are ``SELECTION_DELTA`` apart."""
    from repro_torch.core import arima
    from repro_torch.forecast import ORDER_GRID
    mine_fit, mine_auto = (_shim(arima, n)[0] for n in ("fit_arima",
                                                         "auto_arima"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        their_fit, their_auto = ref.arima.fit_arima, ref.arima.auto_arima
    d_aic, d_pred, pairs = [], [], 0
    for y in _series(6):
        aics = []
        for order in ORDER_GRID:
            m, t = mine_fit(y, order, device="cpu"), their_fit(y, order)
            assert (m is None) == (t is None), order
            if t is None:
                continue
            pairs += 1
            aics.append(t.aic)
            d_aic.append(abs(m.aic - t.aic))
            want = t.forecast(y)
            d_pred.append(abs(m.forecast(y) - want) / max(abs(want), 1e-6))
        two = sorted(aics)[:2]
        if len(two) == 2 and two[1] - two[0] >= SELECTION_DELTA:
            assert mine_auto(y, device="cpu").order == their_auto(y).order
    assert pairs > 60
    assert np.mean(np.asarray(d_aic) > AIC_TOL) <= SHARE
    assert np.mean(np.asarray(d_pred) > PRED_TOL) <= SHARE


def test_shims_default_to_the_card(monkeypatch):
    from repro_torch.core import arima
    fit_arima = _shim(arima, "fit_arima")[0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        fit_arima(_series(1)[0], (1, 0, 0))


# --------------------------------------------------------------------------
# EngineOptions
# --------------------------------------------------------------------------


def test_engine_options_are_a_superset_of_the_reference(ref):
    """Every field of the reference's, with its default; the port adds
    ``device`` (the card)."""
    theirs = {f.name: f.default for f in dataclasses.fields(ref.E.EngineOptions)}
    mine = {f.name: f.default for f in dataclasses.fields(EngineOptions)}
    assert set(theirs) <= set(mine)
    for name, default in theirs.items():
        assert mine[name] == default, name
    assert set(mine) - set(theirs) == {"device"}
    assert mine["device"] == "cuda"


def test_tpu_knobs_are_accepted_and_change_nothing():
    from repro_torch.core.experiment import HybridSpec, run
    trace = WS.azure_like(30, days=1.0, seed=2, max_events=16).materialize()
    base = run(trace, HybridSpec(use_arima=False), engine="kernel",
               options=EngineOptions(device="cpu"))
    knobs = run(trace, HybridSpec(use_arima=False), engine="kernel",
                options=EngineOptions(device="cpu", tile_apps=8,
                                      interpret=True))
    for f in ("cold", "wasted_minutes", "final_prewarm", "final_keep_alive"):
        np.testing.assert_array_equal(getattr(base, f), getattr(knobs, f))
