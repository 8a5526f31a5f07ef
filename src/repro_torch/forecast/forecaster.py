"""Scalar streaming front-end over the batched ARIMA grid fit.

The port of ``repro/forecast/forecaster.py``. :class:`ArimaForecaster`
keeps the reference's surface (``observe`` / ``forecast`` /
``state_dict``) used by the scalar hybrid policy, and fits through
:mod:`repro_torch.forecast.arima_batched` at batch size 1 — the same
per-row program the vectorised replay runs over thousands of windows, so
scalar and batched forecasts agree bit for bit on one device.

Order selection and the refit cadence live in :func:`select_order_step`, a
pure host function shared by this class and by
:mod:`repro_torch.forecast.replay`.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple, Union

import torch

from .arima_batched import MAX_OBS, ORDER_GRID, fit_window

__all__ = ["ArimaForecaster", "SelectionState", "select_order_step",
           "DEFAULT_REFIT_EVERY", "MIN_FORECAST_OBS", "FORECAST_FLOOR"]

DEFAULT_REFIT_EVERY = 8
#: Below this many observations the forecaster abstains.
MIN_FORECAST_OBS = 3
#: Forecasts are clamped to at least this many minutes (a sub-30 s idle
#: prediction would unload at once and thrash).
FORECAST_FLOOR = 0.5

#: (selected order index or None, fits since the last auto-selection).
SelectionState = Tuple[Optional[int], int]


def select_order_step(state: SelectionState, aic_row, valid_row, pred_row,
                      refit_every: int) -> Tuple[SelectionState,
                                                 Optional[float]]:
    """One forecaster call: advance the refit cadence and pick a forecast.

    Every ``refit_every`` fits (and on the first) the order is re-selected
    as the first-wins AIC argmin over the valid grid entries; in between,
    the stored order is reused (its forecast still comes from the fresh fit
    of the current window). Returns the new state and the clamped forecast,
    or ``None`` when no usable fit exists."""
    order, since = state
    if order is None or since >= refit_every:
        order = _first_wins_argmin(aic_row, valid_row)
        since = 0
    else:
        since += 1
    pred: Optional[float] = None
    if order is not None and bool(valid_row[order]):
        raw = float(pred_row[order])
        if math.isfinite(raw):
            pred = max(raw, FORECAST_FLOOR)
    return (order, since), pred


def _first_wins_argmin(aic_row, valid_row) -> Optional[int]:
    """Earliest grid index attaining the minimal AIC among valid fits."""
    best: Optional[int] = None
    best_aic = math.inf
    for i in range(len(ORDER_GRID)):
        if bool(valid_row[i]) and float(aic_row[i]) < best_aic:
            best = i
            best_aic = float(aic_row[i])
    return best


class ArimaForecaster:
    """Streaming next-idle-time forecaster for one app.

    Keeps a rolling window of the last :data:`MAX_OBS` inter-arrival times;
    ``forecast()`` grid-fits the window on ``device`` (the card unless told
    otherwise; resolved at the first fit, so building one needs no card)
    and applies the shared selection/cadence step. The cadence state —
    ``refit_every``, fits since the last auto-selection, the selected order
    — round-trips through ``state_dict()`` in the reference's layout."""

    def __init__(self, refit_every: int = DEFAULT_REFIT_EVERY, *,
                 device: Union[None, str, torch.device] = None) -> None:
        self._obs: List[float] = []
        self._refit_every = int(refit_every)
        self._since_auto = 0
        self._order: Optional[int] = None
        self._dirty = True
        self._cached: Optional[float] = None
        self.device = device

    @property
    def n_obs(self) -> int:
        return len(self._obs)

    def observe(self, idle_minutes: float) -> None:
        self._obs.append(float(idle_minutes))
        if len(self._obs) > MAX_OBS:
            self._obs = self._obs[-MAX_OBS:]
        self._dirty = True

    def forecast(self) -> Optional[float]:
        """Predicted next idle time in minutes, or ``None`` if unusable."""
        if len(self._obs) < MIN_FORECAST_OBS:
            return None
        if self._dirty:
            fit = fit_window(self._obs, device=self.device)
            state, pred = select_order_step(
                (self._order, self._since_auto),
                fit.aic[0], fit.valid[0], fit.pred[0], self._refit_every)
            self._order, self._since_auto = state
            self._cached = pred
            self._dirty = False
        return self._cached

    def state_dict(self) -> Dict[str, object]:
        return {
            "obs": list(self._obs),
            "refit_every": self._refit_every,
            "since_auto": self._since_auto,
            "order": None if self._order is None else int(self._order),
        }

    def load_state_dict(self, state: Dict[str, object]) -> None:
        self._obs = [float(x) for x in state["obs"]]
        # checkpoints that hold only the observations default the cadence
        self._refit_every = int(state.get("refit_every",
                                          DEFAULT_REFIT_EVERY))
        self._since_auto = int(state.get("since_auto", 0))
        order = state.get("order")
        self._order = None if order is None else int(order)
        self._dirty = True
        self._cached = None
