"""The port's forecasting subsystem against the reference.

Two layers (on the CPU; the reference runs in the same process on the
same seeded numpy inputs); the third, the port's engines against its own
scalar oracle, is ``tests/test_torch_forecast_replay.py``:

  * **the fit against the reference.** A float32 iterative fit is not
    bit-equal between XLA and PyTorch, so the port's ``fit_arima_grid`` is
    held to the reference's on a bank of 256 seeded windows (AR(1), MA(1),
    trend, exponential gaps, periodic; lengths 3-64) within bounds set on
    shares of the fits. Measured on the CPU before they were written here
    (port against reference, this bank, as
    ``tests/torch_forecast_report.py`` prints them): ``valid`` equal on
    all 4,352 (window, order) pairs; |dAIC| 99th percentile 1.07e-4 (max
    1.31); relative |dpred| 99th percentile 3.23e-4 (max 1.9%); the
    selected order equal on 256 of 256 windows, its forecast beyond 1e-4
    relative on 3.1% of them (max 4.7e-3). The bounds: 99% of pairs within
    |dAIC| <= 3e-4 and within relative |dpred| <= 1e-3; the selected
    order equal wherever the reference's two best valid AICs are >= 0.01
    apart, and 96% of the selected forecasts within 1e-4. Each bound fails
    a fit with one LM iteration fewer (99th percentiles 6.7e-4 and
    1.8e-3; 5.1% of the selected forecasts beyond 1e-4) and fits with any
    one start dropped (>= 0.151, >= 5.1e-3; >= 6.6% beyond, and 5-10
    selected orders changed): ``test_bounds_catch_faults``.
  * **runs against the reference.** ``run(HybridSpec(use_arima=True))``
    gives the reference's cold counts on the reference's three replay
    seeds and the three golden traces; an app's final windows may differ
    only where both sides' final window is a forecast's and the forecasts
    lie within 1% (measured: 22 apps, at most 9.3e-4; each is listed in
    ROADMAP Queue C). On ``synthesized_small`` 15 apps consult the
    forecaster only before their last event: the reference's ``fused``
    engine skips their post-pass (it selects from the scan's final
    state), the port's does not, so those apps are held to the
    reference's ``scalar`` engine, the oracle its post-pass reproduces
    (14 of them differ between the reference's two engines in their cold
    counts, app 20 only in its waste).
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core import experiment as E
from repro_torch.forecast import MAX_OBS, ORDER_GRID, fit_arima_grid
from repro_torch.forecast import arima_batched
from repro_torch.interop import trace_from_numpy

CPU = dict(device="cpu")
# the fit's bounds against the reference (see the module docstring)
SHARE = 0.01                 # at most 1% of the pairs beyond AIC/PRED_TOL
AIC_TOL = 3e-4               # |dAIC|
PRED_TOL = 1e-3              # relative |dpred|
SELECTED_SHARE = 0.04        # at most 4% of the selected forecasts beyond
SELECTED_PRED_TOL = 1e-4     # relative |dpred| of the selected order
SELECTION_DELTA = 0.01       # AIC gap under which the order may differ
# a run's final forecast windows against the reference's
RUN_FORECAST_TOL = 1e-2
GOLDENS = ("bursty_subms_multiweek", "coarse_twoweek", "synthesized_small")
# the apps of synthesized_small where the reference's fused engine is not
# its scalar oracle (ROADMAP Queue C, repaired in the port); app 20 differs
# in waste only, the others in their cold counts
MID_TRACE_APPS = {"synthesized_small": [7, 9, 11, 13, 14, 16, 17, 20, 22, 32,
                                        33, 34, 41, 56, 60]}
RUN_FIELDS = ("cold", "final_prewarm", "final_keep_alive", "wasted_minutes")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The fit's many small elementwise operations gain nothing from
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
        import golden_traces
        from repro.core import experiment
        from repro.core.policy import HybridConfig as RefHybridConfig
        from repro.forecast import fit_arima_grid as ref_fit
        yield SimpleNamespace(gt=golden_traces, E=experiment, fit=ref_fit,
                              HybridConfig=RefHybridConfig)


def _port_trace(t):
    if t.times is not None:
        return trace_from_numpy(t.times, duration_minutes=t.duration_minutes)
    times, counts = t.to_padded()
    return trace_from_numpy(times, counts,
                            duration_minutes=t.duration_minutes)


# --------------------------------------------------------------------------
# The fit against the reference
# --------------------------------------------------------------------------


def _window_bank(n=256, seed=0):
    """Seeded windows of five kinds, lengths 3-64."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((n, MAX_OBS), np.float32)
    lens = np.zeros(n, np.int32)
    for i in range(n):
        length = int(rng.integers(3, MAX_OBS + 1))
        kind = i % 5
        if kind == 0:                                 # AR(1)
            base = rng.uniform(10.0, 300.0)
            phi = rng.uniform(-0.9, 0.95)
            sd = rng.uniform(0.1, 20.0)
            y = [base]
            for _ in range(length - 1):
                y.append(base + phi * (y[-1] - base) + rng.normal(0, sd))
        elif kind == 1:                               # MA(1)
            e = rng.normal(0.0, rng.uniform(1.0, 30.0), length + 1)
            y = rng.uniform(50.0, 400.0) + e[1:] \
                + rng.uniform(-0.9, 0.9) * e[:-1]
        elif kind == 2:                               # trend
            y = rng.uniform(1.0, 100.0) \
                + np.arange(length) * rng.uniform(-3.0, 3.0) \
                + rng.normal(0.0, rng.uniform(0.01, 5.0), length)
        elif kind == 3:                               # exponential gaps
            y = rng.exponential(rng.uniform(100.0, 2000.0), length)
        else:                                         # periodic
            period = rng.integers(2, 9)
            y = 200.0 + 50.0 * np.sin(2 * np.pi * np.arange(length) / period) \
                + rng.normal(0.0, rng.uniform(0.1, 10.0), length)
        rows[i, :length] = np.asarray(y, np.float32)
        lens[i] = length
    return rows, lens


@pytest.fixture(scope="module")
def bank(ref):
    rows, lens = _window_bank()
    return rows, lens, ref.fit(rows, lens), \
        fit_arima_grid(rows, lens, device="cpu")


def _bounds(want, got):
    """Which of the three bounds ``got`` keeps against ``want``, and the
    measured shares beyond each tolerance."""
    both = want.valid & got.valid
    with np.errstate(invalid="ignore"):
        d_aic = np.abs(want.aic - got.aic)[both]
    rel = lambda a, b: np.abs(a - b) / np.maximum(np.abs(a), 1e-6)
    d_pred = rel(want.pred, got.pred)[both]
    has = want.valid.any(1)
    aic_w = np.where(want.valid, want.aic, np.inf)[has]
    sel_w = aic_w.argmin(1)
    sel_g = np.where(got.valid, got.aic, np.inf)[has].argmin(1)
    two = np.sort(aic_w, 1)[:, :2]
    gap = two[:, 1] - two[:, 0]
    rows = np.arange(len(sel_w))
    d_sel = rel(want.pred[has][rows, sel_w], got.pred[has][rows, sel_w])
    out = dict(aic_share=float(np.mean(d_aic > AIC_TOL)),
               pred_share=float(np.mean(d_pred > PRED_TOL)),
               selected_pred_share=float(np.mean(d_sel > SELECTED_PRED_TOL)),
               orders_changed=int(np.sum((sel_w != sel_g)
                                         & (gap >= SELECTION_DELTA))))
    out["aic"] = out["aic_share"] <= SHARE
    out["pred"] = out["pred_share"] <= SHARE
    out["selection"] = out["orders_changed"] == 0 \
        and out["selected_pred_share"] <= SELECTED_SHARE
    return out


def test_fit_valid_equals_the_reference(bank):
    _, _, want, got = bank
    np.testing.assert_array_equal(got.valid, want.valid)
    assert want.valid.sum() > 3000


def test_fit_within_bounds_of_the_reference(bank):
    _, _, want, got = bank
    b = _bounds(want, got)
    assert b["aic"] and b["pred"] and b["selection"], b


@pytest.mark.parametrize("fault", ["one_lm_iteration_fewer",
                                   "start_0_dropped", "start_1_dropped",
                                   "start_2_dropped", "start_3_dropped"])
def test_bounds_catch_faults(bank, monkeypatch, fault):
    """Every bound fails a fit with one LM iteration fewer and a fit with
    one start dropped."""
    rows, lens, want, _ = bank
    if fault == "one_lm_iteration_fewer":
        monkeypatch.setattr(arima_batched, "_GN_ITERS",
                            arima_batched._GN_ITERS - 1)
    else:
        k = int(fault.split("_")[1])
        starts = arima_batched._STARTS
        monkeypatch.setattr(arima_batched, "_STARTS",
                            starts[:k] + starts[k + 1:])
    b = _bounds(want, fit_arima_grid(rows, lens, device="cpu"))
    assert not (b["aic"] or b["pred"] or b["selection"]), b


def _oracle_bank():
    rng = np.random.default_rng(17)
    ar1 = [50.0]
    for _ in range(40):
        ar1.append(50.0 + 0.75 * (ar1[-1] - 50.0) + rng.normal(0, 2.0))
    trend = np.arange(30) * 4.0 + 20.0 + rng.normal(0, 0.5, 30)
    periodic = 300.0 + 30.0 * np.sin(np.arange(48) * 0.9) \
        + rng.normal(0, 3.0, 48)
    return {"ar1": np.asarray(ar1), "trend": trend, "periodic": periodic}


def test_batched_fit_tracks_scipy_oracle():
    """The reference's bounds against the constrained scipy CSS oracle
    (``tests/arima_oracle.py``): per-order AIC within 4.0 of its optimum,
    12.0 for the two four-coefficient orders, and the selected order's
    AIC within 4.0 of the oracle's best."""
    pytest.importorskip("scipy")
    from arima_oracle import fit_css_oracle

    for name, y in _oracle_bank().items():
        row = np.zeros((1, MAX_OBS), np.float32)
        row[0, :len(y)] = y
        fit = fit_arima_grid(row, [len(y)], device="cpu")
        checked = 0
        best_batched = best_oracle = np.inf
        for i, order in enumerate(ORDER_GRID):
            if not bool(fit.valid[0, i]):
                continue
            oracle = fit_css_oracle(y, order)
            if oracle is None:
                continue
            p, _, q = order
            tol = 4.0 if p + q <= 3 else 12.0
            assert float(fit.aic[0, i]) <= oracle[0] + tol, \
                f"{name} order {order}: batched AIC " \
                f"{float(fit.aic[0, i]):.3f} vs oracle {oracle[0]:.3f}"
            best_batched = min(best_batched, float(fit.aic[0, i]))
            best_oracle = min(best_oracle, oracle[0])
            checked += 1
        assert checked >= 10, f"{name}: too few valid fits ({checked})"
        assert best_batched <= best_oracle + 4.0, \
            f"{name}: selected-order AIC {best_batched:.3f} vs oracle " \
            f"best {best_oracle:.3f}"


# --------------------------------------------------------------------------
# Hybrid + ARIMA runs against the reference
# --------------------------------------------------------------------------


def _is_forecast_window(pre, keep, margin):
    """(prewarm, keep-alive) in arima_window's shape, (1 - m) : 2m."""
    return np.isclose(keep * (1.0 - margin), pre * 2.0 * margin, rtol=1e-9,
                      atol=0.0) & (pre > 0)


def _reference_case(ref, case):
    if case.startswith("seed"):
        rtrace = ref.gt.coarse_twoweek(n_apps=12, seed=int(case[4:]))
        rcfg = ref.HybridConfig(histogram=ref.gt.CFG48.histogram,
                                use_arima=True, cv_threshold=1.9)
    else:
        make, cfg = ref.gt.GOLDEN_TRACES[case]
        rtrace, rcfg = make(), dataclasses.replace(cfg, use_arima=True)
    return rtrace, ref.E.HybridSpec.from_config(rcfg)


@pytest.mark.parametrize("case", ["seed3", "seed11", "seed29", *GOLDENS])
def test_hybrid_arima_runs_match_the_reference(ref, case):
    """Cold counts and invocations equal the reference's; final windows
    too, except where both final windows are forecasts within
    RUN_FORECAST_TOL (the fit's float32 rounding; ROADMAP Queue C lists
    each such app). Waste follows the windows (within 1%). The apps of
    MID_TRACE_APPS are held to the reference's scalar engine."""
    rtrace, rspec = _reference_case(ref, case)
    want = ref.E.run(rtrace, rspec, engine="fused")
    if case in MID_TRACE_APPS:
        oracle = ref.E.run(rtrace, rspec, engine="scalar")
        moved = np.zeros(len(want.cold), bool)
        for f in RUN_FIELDS:
            moved |= getattr(oracle, f) != getattr(want, f)
        assert np.nonzero(moved)[0].tolist() == MID_TRACE_APPS[case]
        assert int((oracle.cold != want.cold).sum()) == 14
        for f in RUN_FIELDS:
            getattr(want, f)[moved] = getattr(oracle, f)[moved]
    spec = E.HybridSpec(**{k: v for k, v in vars(rspec).items()})
    got = E.run(_port_trace(rtrace), spec, engine="fused",
                options=E.EngineOptions(**CPU))
    np.testing.assert_array_equal(got.invocations, want.invocations)
    np.testing.assert_array_equal(got.cold, want.cold)
    differ = (got.final_prewarm != want.final_prewarm) \
        | (got.final_keep_alive != want.final_keep_alive)
    m = spec.arima_margin
    forecast = _is_forecast_window(got.final_prewarm, got.final_keep_alive,
                                   m) \
        & _is_forecast_window(want.final_prewarm, want.final_keep_alive, m)
    rel = np.abs(got.final_prewarm - want.final_prewarm) \
        / np.maximum(want.final_prewarm, 1e-9)
    bad = differ & ~(forecast & (rel <= RUN_FORECAST_TOL))
    assert not bad.any(), (case, np.nonzero(bad)[0])
    np.testing.assert_allclose(got.wasted_minutes, want.wasted_minutes,
                               rtol=1e-2)
