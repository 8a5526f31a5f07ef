"""The port's forecasting subsystem (``repro_torch.forecast``) on its own
and against the reference's helpers.

The counterparts of ``tests/test_forecast.py`` and
``tests/test_forecast_property.py``: the grid fit's batch-size, chunk and
padding invariance (bit for bit, on the CPU here; the ``gpu`` tests hold
the same on the card), its input checks, the trailing window, the order
grid, the streaming forecaster (abstention, the constant series, the
rolling window, the cadence round trip of ``state_dict`` and checkpoints
that hold only observations), and the fit's properties. The host helpers
that decide from a fit (``select_order_step``, ``arima_window``) are held
exactly equal to the reference's on the same inputs. The fit itself is
held to the reference within stated bounds in
``tests/test_torch_forecast_conformance.py``; the fit's properties are in
``tests/test_torch_forecast_property.py``.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.core import policy_math
from repro_torch.core.policy import HybridConfig, HybridHistogramPolicy
from repro_torch.forecast import (ArimaForecaster, DEFAULT_REFIT_EVERY,
                                  MAX_OBS, ORDER_GRID, fit_arima_grid,
                                  fit_window, select_order_step)
from repro_torch.forecast import arima_batched
from repro_torch.forecast.forecaster import _first_wins_argmin

CPU = "cpu"


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
        import repro.forecast
        from repro.core import policy as rpolicy
        from repro.core import policy_math as rpm
        from repro.forecast import forecaster as rforecaster
        yield type("Ref", (), dict(forecast=repro.forecast, pm=rpm,
                                   forecaster=rforecaster,
                                   policy=rpolicy))


def _series_bank(n=8, seed=7):
    """AR(1), trend, periodic and noisy rows with ragged lengths."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        length = int(rng.integers(4, MAX_OBS + 1))
        kind = i % 4
        if kind == 0:
            y = [10.0]
            for _ in range(length - 1):
                y.append(0.7 * y[-1] + 3.0 + rng.normal(0, 0.5))
            y = np.asarray(y)
        elif kind == 1:
            y = np.arange(length) * 2.5 + 5.0 + rng.normal(0, 0.1, length)
        elif kind == 2:
            y = 60.0 + 10.0 * np.sin(np.arange(length) * 0.7) \
                + rng.normal(0, 1.0, length)
        else:
            y = rng.uniform(1.0, 500.0, length)
        out.append(y.astype(np.float32))
    return out


def _pad_rows(series, width=MAX_OBS):
    rows = np.zeros((len(series), width), np.float32)
    lens = np.zeros(len(series), np.int32)
    for i, y in enumerate(series):
        rows[i, :len(y)] = y
        lens[i] = len(y)
    return rows, lens


def _assert_fits_equal(a, b, err=""):
    for field in a._fields:
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field),
                                      err_msg=f"{err} {field}")


# --------------------------------------------------------------------------
# Grid fit: batch-size / chunk / padding bit-invariance
# --------------------------------------------------------------------------


def test_fit_is_batch_size_invariant():
    """Rows are fitted independently: an [8, 64] batch, eight [1, 64]
    batches and chunks of 3 agree bit for bit on every GridFit field."""
    series = _series_bank()
    rows, lens = _pad_rows(series)
    full = fit_arima_grid(rows, lens, device=CPU)
    _assert_fits_equal(full, fit_arima_grid(rows, lens, device=CPU,
                                            chunk_rows=3), "chunks of 3")
    for i in range(len(series)):
        single = fit_arima_grid(rows[i:i + 1], lens[i:i + 1], device=CPU)
        for field in full._fields:
            np.testing.assert_array_equal(
                getattr(full, field)[i], getattr(single, field)[0],
                err_msg=f"row {i} field {field}")


def test_fit_is_padding_invariant():
    """Narrow rows pad to MAX_OBS: a [B, 40] array equals the pre-padded
    [B, 64] one."""
    series = [y[:40] for y in _series_bank(n=4, seed=11)]
    narrow_rows, lens = _pad_rows(series, width=40)
    wide_rows, _ = _pad_rows(series, width=MAX_OBS)
    _assert_fits_equal(fit_arima_grid(narrow_rows, lens, device=CPU),
                       fit_arima_grid(wide_rows, lens, device=CPU))


def test_fit_chunks_group_rows_by_length():
    lens = np.asarray([40, 3, 64, 9, 5, 33, 16, 17])
    chunks = arima_batched.fit_chunks(lens, chunk_rows=2)
    assert sorted(np.concatenate(chunks).tolist()) == list(range(8))
    spans = [{arima_batched._pow2(x) for x in lens[c]} for c in chunks]
    assert all(len(s) == 1 for s in spans)
    assert all(len(c) <= 2 for c in chunks)
    # the default size follows the memory budget of the device type
    big = arima_batched.fit_chunks(np.full(10, 64))
    assert len(big) == 1


def test_fit_input_validation():
    with pytest.raises(ValueError, match="batch, obs"):
        fit_arima_grid(np.zeros(8, np.float32), [8], device=CPU)
    with pytest.raises(ValueError, match="one int per series row"):
        fit_arima_grid(np.zeros((2, 8), np.float32), [8], device=CPU)
    with pytest.raises(ValueError, match="MAX_OBS"):
        fit_arima_grid(np.zeros((1, MAX_OBS + 1), np.float32),
                       [MAX_OBS + 1], device=CPU)


def test_fit_window_truncates_to_trailing_window():
    long = list(np.linspace(1.0, 400.0, MAX_OBS + 20, dtype=np.float32))
    a = fit_window(long, device=CPU)
    b = fit_window(long[-MAX_OBS:], device=CPU)
    np.testing.assert_array_equal(a.aic, b.aic)
    np.testing.assert_array_equal(a.pred, b.pred)


def test_grid_matches_the_reference_enumeration(ref):
    assert len(ORDER_GRID) == 17
    assert (0, 0, 0) not in ORDER_GRID
    assert ORDER_GRID[0] == (0, 0, 1)
    assert all(p <= 2 and d <= 1 and q <= 2 for p, d, q in ORDER_GRID)
    assert ORDER_GRID == ref.forecast.ORDER_GRID
    assert MAX_OBS == ref.forecast.MAX_OBS
    assert DEFAULT_REFIT_EVERY == ref.forecast.DEFAULT_REFIT_EVERY


def test_fit_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        fit_window([1.0, 2.0, 3.0, 4.0])


def test_log_is_correctly_rounded_where_float64_says_so():
    """The AIC's log (float64 series, rounded once) against numpy's
    float64 log rounded to float32, over eighteen decades and at 1."""
    rng = np.random.default_rng(0)
    x = np.concatenate([np.float32(10.0) ** rng.uniform(-12, 6, 20000),
                        [1.0, 0.5, 2.0, 1e-12]]).astype(np.float32)
    got = arima_batched._log_f32(torch.from_numpy(x)).numpy()
    want = np.log(x.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(got, want)
    special = torch.tensor([0.0, -1.0, math.inf, math.nan])
    out = arima_batched._log_f32(special)
    assert out[0] == -math.inf and torch.isnan(out[1]) \
        and out[2] == math.inf and torch.isnan(out[3])


def test_solve4_matches_float64_solve():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(4, 4, 300)).astype(np.float32)
    a[0, 0] = 1e-3                         # forces a pivot
    b = rng.normal(size=(4, 300)).astype(np.float32)
    x = arima_batched._solve4([[torch.from_numpy(a[i, j]) for j in range(4)]
                               for i in range(4)],
                              [torch.from_numpy(b[i]) for i in range(4)])
    want = np.linalg.solve(a.transpose(2, 0, 1).astype(np.float64),
                           b.T.astype(np.float64)[..., None])[..., 0].T
    got = torch.stack(x).numpy()
    cond = np.linalg.cond(a.transpose(2, 0, 1).astype(np.float64))
    ok = cond < 1e3
    np.testing.assert_allclose(got[:, ok], want[:, ok], rtol=2e-3, atol=2e-4)


# --------------------------------------------------------------------------
# Order selection and the forecast window: exact against the reference
# --------------------------------------------------------------------------


def _selection_rows(seed, n=400):
    rng = np.random.default_rng(seed)
    aic = rng.normal(50.0, 5.0, (n, len(ORDER_GRID))).astype(np.float32)
    aic[rng.random(aic.shape) < 0.1] = np.float32(48.0)   # ties
    valid = rng.random(aic.shape) > 0.3
    valid[::37] = False                                    # no usable fit
    pred = rng.normal(100.0, 80.0, aic.shape).astype(np.float32)
    pred[rng.random(aic.shape) < 0.05] = np.nan
    return np.where(valid, aic, np.inf).astype(np.float32), valid, pred


@pytest.mark.parametrize("refit_every", [1, 3, DEFAULT_REFIT_EVERY])
def test_select_order_step_is_exact(ref, refit_every):
    aic, valid, pred = _selection_rows(refit_every)
    state, rstate = (None, 0), (None, 0)
    for i in range(len(aic)):
        assert _first_wins_argmin(aic[i], valid[i]) == \
            ref.forecaster._first_wins_argmin(aic[i], valid[i])
        state, got = select_order_step(state, aic[i], valid[i], pred[i],
                                       refit_every)
        rstate, want = ref.forecaster.select_order_step(
            rstate, aic[i], valid[i], pred[i], refit_every)
        assert state == rstate and got == want, i


def test_arima_window_is_exact(ref):
    rng = np.random.default_rng(4)
    for pred in list(rng.uniform(0.5, 2000.0, 500)) + [0.5, 1.0, 240.0]:
        for margin in (0.15, 0.1, 0.37, 0.0):
            assert policy_math.arima_window(float(pred), margin) == \
                ref.pm.arima_window(float(pred), margin)


# --------------------------------------------------------------------------
# Streaming forecaster
# --------------------------------------------------------------------------


def test_forecaster_abstains_below_min_obs():
    f = ArimaForecaster(device=CPU)
    assert f.forecast() is None
    f.observe(100.0)
    f.observe(101.0)
    assert f.forecast() is None


def test_forecaster_constant_series_predicts_the_constant():
    f = ArimaForecaster(device=CPU)
    for _ in range(12):
        f.observe(300.0)
    assert f.forecast() == pytest.approx(300.0, rel=0.01)


def test_forecaster_rolls_obs_window():
    f = ArimaForecaster(device=CPU)
    for i in range(MAX_OBS + 10):
        f.observe(float(i))
    assert f.n_obs == MAX_OBS


def test_state_dict_roundtrip_preserves_cadence():
    """A restored forecaster produces the identical forecast sequence: the
    cadence (refit_every, fits since the last selection, the order)
    round-trips."""
    rng = np.random.default_rng(3)
    a = ArimaForecaster(refit_every=3, device=CPU)
    for _ in range(7):
        a.observe(float(rng.uniform(100.0, 400.0)))
        a.forecast()
    state = a.state_dict()
    assert state["refit_every"] == 3
    assert state["since_auto"] == a._since_auto
    assert state["order"] == a._order
    b = ArimaForecaster(device=CPU)
    b.load_state_dict(state)
    assert b._refit_every == 3
    future = [float(rng.uniform(100.0, 400.0)) for _ in range(9)]
    seq_a, seq_b = [], []
    for x in future:
        a.observe(x)
        seq_a.append(a.forecast())
        b.observe(x)
        seq_b.append(b.forecast())
    assert seq_a == seq_b


def test_state_dict_accepts_obs_only_checkpoints():
    f = ArimaForecaster(refit_every=5, device=CPU)
    f.load_state_dict({"obs": [10.0, 20.0, 30.0, 40.0]})
    assert f.n_obs == 4
    assert f._refit_every == DEFAULT_REFIT_EVERY
    assert f.forecast() is not None


def test_state_dict_layout_is_the_reference_layout(ref):
    """A reference forecaster's checkpoint loads into the port and back."""
    rng = np.random.default_rng(8)
    obs = [float(x) for x in rng.uniform(100.0, 400.0, 12)]
    r = ref.forecaster.ArimaForecaster(refit_every=4)
    for x in obs:
        r.observe(x)
        r.forecast()
    f = ArimaForecaster(device=CPU)
    f.load_state_dict(r.state_dict())
    assert f.state_dict() == r.state_dict()


# --------------------------------------------------------------------------
# The hybrid policy's ARIMA branch and checkpoint
# --------------------------------------------------------------------------


def _drive(policy, its):
    out = [policy.on_invocation("a", None)]
    out += [policy.on_invocation("a", it) for it in its]
    return out


def test_policy_forecasts_oob_heavy_apps():
    """Idle times past the 240-minute range: after arima_min_samples the
    windows are the forecast's, in arima_window's shape."""
    rng = np.random.default_rng(2)
    its = [float(x) for x in rng.uniform(300.0, 360.0, 12)]
    cfg = HybridConfig()
    ws = _drive(HybridHistogramPolicy(cfg, device=CPU), its)
    assert ws[1] == ws[0] == HybridHistogramPolicy(cfg)._standard()
    last = ws[-1]
    pred = last.prewarm / (1.0 - cfg.arima_margin)
    assert 250.0 < pred < 450.0
    assert last.keep_alive == pytest.approx(2 * cfg.arima_margin * pred,
                                            rel=1e-9)
    off = _drive(HybridHistogramPolicy(HybridConfig(use_arima=False)), its)
    assert off[-1] == HybridHistogramPolicy(cfg)._standard()


def test_policy_needs_no_card_until_it_forecasts(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    policy = HybridHistogramPolicy(HybridConfig())
    for it in (None, 5.0, 6.0, 5.0):        # in bounds: no forecast
        policy.on_invocation("a", it)
    with pytest.raises(RuntimeError, match="is_available"):
        _drive(HybridHistogramPolicy(HybridConfig()), [300.0] * 6)


def test_policy_state_dict_roundtrip_and_reference_checkpoint(ref):
    """The port's checkpoint restores its own forecasts exactly, and a
    reference policy's checkpoint (the "arima" entry included) loads into
    the port in the same layout."""
    rng = np.random.default_rng(6)
    its = [float(x) for x in rng.uniform(250.0, 500.0, 10)]
    more = [float(x) for x in rng.uniform(250.0, 500.0, 6)]
    a = HybridHistogramPolicy(HybridConfig(), device=CPU)
    _drive(a, its)
    b = HybridHistogramPolicy(HybridConfig(), device=CPU)
    b.load_state_dict(a.state_dict())
    assert [a.on_invocation("a", x) for x in more] == \
        [b.on_invocation("a", x) for x in more]

    r = ref.policy.HybridHistogramPolicy(ref.policy.HybridConfig())
    _drive(r, its)
    state = r.state_dict()
    assert state["arima"]
    c = HybridHistogramPolicy(HybridConfig(), device=CPU)
    c.load_state_dict(state)
    assert c.state_dict() == state
    assert c._arima["a"].state_dict() == state["arima"]["a"]


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_card_fit_is_batch_size_invariant(cuda):
    """On the card: a 64-row batch, chunks of 5 and rows one at a time
    agree bit for bit; and the card's fit equals the CPU's (the fit is
    elementwise IEEE arithmetic with a log of its own)."""
    series = _series_bank(n=64, seed=21)
    rows, lens = _pad_rows(series)
    full = fit_arima_grid(rows, lens, device=cuda)
    _assert_fits_equal(full, fit_arima_grid(rows, lens, device=cuda,
                                            chunk_rows=5), "chunks of 5")
    for i in range(0, 64, 9):
        single = fit_window(series[i], device=cuda)
        for field in full._fields:
            np.testing.assert_array_equal(getattr(full, field)[i],
                                          getattr(single, field)[0],
                                          err_msg=f"row {i} {field}")
    _assert_fits_equal(full, fit_arima_grid(rows, lens, device=CPU),
                       "card vs CPU")


@pytest.mark.gpu
def test_card_replay_equals_scalar_oracle(cuda):
    """run(HybridSpec()) on the card (the rescan through the step kernel)
    equals simulate_scalar with the forecasters on the card."""
    from repro_torch.core.experiment import EngineOptions, HybridSpec, run
    from repro_torch.core.simulator import simulate_scalar
    from repro_torch.core.workload_spec import timer_heavy
    from repro_torch.kernels import histogram as H
    trace = timer_heavy(40, days=1.0, seed=5).materialize()
    spec = HybridSpec(cv_threshold=1.9)
    launches = H.LAUNCHES
    got = run(trace, spec, engine="kernel",
              options=EngineOptions(device=cuda))
    assert H.LAUNCHES > launches
    oracle = simulate_scalar(trace, spec.build(device=cuda))
    for f in ("cold", "final_prewarm", "final_keep_alive",
              "wasted_minutes"):
        np.testing.assert_array_equal(getattr(got, f), getattr(oracle, f),
                                      err_msg=f)
