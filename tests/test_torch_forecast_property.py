"""Property tests of the port's batched ARIMA grid fit, the counterparts
of ``tests/test_forecast_property.py`` with the reference's assertions.

Requires hypothesis (dev-only, like scipy); the module skips without it.
The contracts: every fitted AR/MA pair lies in the shrunken stationarity /
invertibility triangle; the batched optimum is never materially worse
than the triangle-constrained scipy Nelder-Mead oracle
(``tests/arima_oracle.py``); NaN and too-short series invalidate every
order, while a zero-variance series stays valid and forecasts the
constant. Two of them fail in the reference itself (ROADMAP, Known state
of the reference); they keep the reference's assertions here.
"""
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.forecast import (MAX_OBS, ORDER_GRID, fit_arima_grid,
                                  fit_window)

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import (HealthCheck, example, given, settings,  # noqa
                        strategies as st)

CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The fit's many small elementwise operations gain nothing from
    intra-op threads and lose badly when test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

RELAXED = settings(max_examples=25, deadline=None,
                   suppress_health_check=[HealthCheck.too_slow])


def _seeded_series(seed: int) -> np.ndarray:
    """A deterministic series keyed by one integer: AR, drift,
    periodicity and scale."""
    rng = np.random.default_rng(seed)
    length = int(rng.integers(5, MAX_OBS + 1))
    base = rng.uniform(1.0, 400.0)
    phi = rng.uniform(-0.8, 0.9)
    drift = rng.uniform(-2.0, 2.0)
    y = [base]
    for t in range(length - 1):
        y.append(base + phi * (y[-1] - base) + drift * t
                 + rng.normal(0.0, rng.uniform(0.01, 5.0)))
    return np.asarray(y, np.float32)


def _roots_inside_unit_circle(c1: float, c2: float) -> bool:
    return bool(np.all(np.abs(np.roots([1.0, -c1, -c2])) < 1.0))


@RELAXED
@given(st.integers(0, 2 ** 31 - 1))
def test_fitted_models_are_stationary_and_invertible(seed):
    fit = fit_window(_seeded_series(seed), device=CPU)
    for i in range(len(ORDER_GRID)):
        if not bool(fit.valid[0, i]):
            continue
        a1, a2, b1, b2 = (float(c) for c in fit.coef[0, i])
        assert abs(a2) <= 0.98 + 1e-6 and abs(b2) <= 0.98 + 1e-6
        assert _roots_inside_unit_circle(a1, a2), (ORDER_GRID[i], a1, a2)
        assert _roots_inside_unit_circle(b1, b2), (ORDER_GRID[i], b1, b2)


@settings(max_examples=8, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.integers(0, 2 ** 31 - 1))
@example(255)
def test_batched_aic_tracks_scipy_oracle(seed):
    """The reference's assertion (AIC within 4.0 of the constrained scipy
    optimum, 12.0 for the two four-coefficient orders). The reference
    fails it at seed 255, order (0, 0, 2), AIC 41.74 against scipy's
    36.94; the port, a faithful copy of the fit, fails it there the same
    way (ROADMAP Queue C), so that example is always run."""
    pytest.importorskip("scipy")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from arima_oracle import fit_css_oracle

    y = _seeded_series(seed)
    fit = fit_window(y, device=CPU)
    for i, order in enumerate(ORDER_GRID):
        if not bool(fit.valid[0, i]):
            continue
        oracle = fit_css_oracle(np.asarray(y, float), order)
        if oracle is None:
            continue
        p, _, q = order
        tol = 4.0 if p + q <= 3 else 12.0
        assert float(fit.aic[0, i]) <= oracle[0] + tol, \
            f"order {order}: batched {float(fit.aic[0, i])} vs " \
            f"oracle {oracle[0]}"


@RELAXED
@given(st.integers(0, 2 ** 31 - 1), st.integers(0, MAX_OBS - 1))
def test_nan_poisoned_series_invalidates_every_order(seed, nan_at):
    y = _seeded_series(seed)
    y[nan_at % len(y)] = np.nan
    fit = fit_window(y, device=CPU)
    assert not fit.valid.any()
    assert np.all(np.isinf(fit.aic))


@given(st.integers(0, 2))
@settings(max_examples=3, deadline=None)
def test_short_series_invalidates_every_order(length):
    fit = fit_window([100.0] * length, device=CPU)
    assert not fit.valid.any()


@RELAXED
@given(st.floats(0.5, 1e4, allow_nan=False),
       st.integers(4, MAX_OBS))
@example(4682.111328125, 7)
def test_zero_variance_series_forecasts_the_constant(value, length):
    """Perfectly periodic timers forecast their period exactly (the
    reference's assertion). The reference fails it by one ulp (its float32
    window mean of a constant is not the constant); the port, a faithful
    copy of the fit, fails it the same way, e.g. MA(2) forecasts 4682.1118
    for seven copies of 4682.1113 (ROADMAP Queue C), so that example is
    always run."""
    v32 = np.float32(value)
    fit = fit_window([float(v32)] * length, device=CPU)
    for i, (p, d, q) in enumerate(ORDER_GRID):
        if not bool(fit.valid[0, i]):
            continue
        assert float(fit.pred[0, i]) == float(v32), (ORDER_GRID[i],)
    assert fit.valid.any()


def test_batched_rows_independent_of_neighbors():
    """A NaN row does not poison its batch neighbours."""
    good = _seeded_series(123)
    rows = np.zeros((2, MAX_OBS), np.float32)
    rows[0, :len(good)] = good
    rows[1, :4] = [1.0, np.nan, 3.0, 4.0]
    fit = fit_arima_grid(rows, [len(good), 4], device=CPU)
    alone = fit_arima_grid(rows[:1], [len(good)], device=CPU)
    np.testing.assert_array_equal(fit.aic[0], alone.aic[0])
    assert not fit.valid[1].any()
