"""Batched time-series forecasting, in PyTorch (the port of
``repro/forecast``).

* :mod:`repro_torch.forecast.arima_batched` — the batched fixed-order CSS
  ARIMA fit over (window, order grid, start), float32, bit-identical at
  every batch size on one device.
* :mod:`repro_torch.forecast.forecaster` — the scalar streaming front-end
  (:class:`ArimaForecaster`) and the shared order-selection/cadence step.
* :mod:`repro_torch.forecast.replay` — the replay of the hybrid policy's
  per-event residency bounds with ARIMA overrides for OOB-heavy apps (the
  engines' post-pass): a rescan through the sweep-step kernel, one
  batched fit of every forecaster window, the cadence on the host.
"""
from .arima_batched import (GridFit, MAX_OBS, ORDER_GRID, fit_arima_grid,
                            fit_window)
from .forecaster import (ArimaForecaster, DEFAULT_REFIT_EVERY,
                         select_order_step)

__all__ = [
    "ArimaForecaster", "DEFAULT_REFIT_EVERY", "GridFit", "MAX_OBS",
    "ORDER_GRID", "fit_arima_grid", "fit_window", "select_order_step",
]
