"""Deprecation shims over :mod:`repro_torch.forecast` (the batched ARIMA
engine): the port of ``repro/core/arima.py``.

Fitting runs through the batched grid fit of
:mod:`repro_torch.forecast.arima_batched`; the streaming front-end lives in
:mod:`repro_torch.forecast.forecaster`. Every public name here is a
:class:`DeprecationWarning` shim that names its replacement:

  * :func:`fit_arima` / :func:`auto_arima` fit through the batched grid
    (the trailing ``MAX_OBS``-observation window, like the forecaster) on
    ``device`` (the card unless told otherwise) and re-package the
    selected order as a legacy :class:`ArimaModel`;
  * :class:`ArimaForecaster` is an alias of
    :class:`repro_torch.forecast.forecaster.ArimaForecaster`.

Import from :mod:`repro_torch.forecast` instead.
"""
from __future__ import annotations

import math
import warnings
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = ["fit_arima", "ArimaModel", "ArimaForecaster", "auto_arima"]

_MAX_OBS = 64  # re-exported legacy constant (== repro_torch.forecast.MAX_OBS)

_DEPRECATED = {
    "fit_arima": "repro_torch.forecast.fit_arima_grid",
    "auto_arima": "repro_torch.forecast.fit_window + select_order_step",
    "ArimaModel": "repro_torch.forecast.GridFit",
    "ArimaForecaster": "repro_torch.forecast.ArimaForecaster",
}


class _ArimaModel:
    """Legacy fitted-model container (deprecated; see module docstring).

    Rebuilt from one row/order of the batched :class:`GridFit`: the
    coefficients are the fit's projected optimum, the intercept keeps the
    legacy ``c = mu * (1 - sum(ar))`` convention, and :meth:`forecast`
    replays the zero-pre-sample CSS recursion with the stored coefficients
    on whatever series it is handed (float64, on the host).
    """

    def __init__(self, order: Tuple[int, int, int], ar: np.ndarray,
                 ma: np.ndarray, c: float, sigma2: float, aic: float,
                 mu: float = 0.0):
        self.order = order
        self.ar = ar
        self.ma = ma
        self.c = c
        self.sigma2 = sigma2
        self.aic = aic
        self.mu = mu

    def forecast(self, y_orig: Sequence[float]) -> float:
        """One-step-ahead forecast given the original (undifferenced)
        series — the centred-series recursion the batched fit uses."""
        p, d, q = self.order
        if d > 1:
            raise NotImplementedError("d > 1 not supported")
        y = np.asarray(y_orig, float)[-_MAX_OBS:]
        w = np.diff(y, n=d) if d > 0 else y
        wc = w - self.mu
        ar = np.zeros(2)
        ar[:len(self.ar)] = self.ar
        ma = np.zeros(2)
        ma[:len(self.ma)] = self.ma
        w1 = w2 = e1 = e2 = 0.0
        for x in wc:
            e = x - (ar[0] * w1 + ar[1] * w2 + ma[0] * e1 + ma[1] * e2)
            w1, w2 = x, w1
            e1, e2 = e, e1
        pred_w = self.mu + ar[0] * w1 + ar[1] * w2 + ma[0] * e1 + ma[1] * e2
        return float(y[-1] + pred_w) if d == 1 else float(pred_w)


def _model_from_fit(fit, row: int, idx: int) -> Optional[_ArimaModel]:
    from ..forecast.arima_batched import ORDER_GRID

    if not bool(fit.valid[row, idx]):
        return None
    p, d, q = ORDER_GRID[idx]
    coef = np.asarray(fit.coef[row, idx], float)
    ar = coef[:2][:p]
    ma = coef[2:][:q]
    mu = float(fit.mu[row, idx])
    aic = float(fit.aic[row, idx])
    return _ArimaModel((p, d, q), ar, ma, mu * (1.0 - float(np.sum(ar))),
                       math.nan, aic, mu=mu)


def _fit_arima(y: Sequence[float], order: Tuple[int, int, int], *,
               device: Union[None, str, torch.device] = None
               ) -> Optional[_ArimaModel]:
    """CSS fit of one ARIMA(p,d,q) order via the batched grid on ``device``
    (deprecated). Fits the trailing ``MAX_OBS`` observations — the
    streaming forecaster's window. Returns ``None`` when the batched fit
    marks the (series, order) pair unusable (too short, non-finite input,
    zero variance)."""
    from ..forecast.arima_batched import ORDER_GRID, fit_window

    p, d, q = (int(v) for v in order)
    try:
        idx = ORDER_GRID.index((p, d, q))
    except ValueError:
        raise ValueError(f"order {(p, d, q)} outside the supported grid "
                         f"(p <= 2, d <= 1, q <= 2, not all zero)")
    y = np.asarray(y, float)
    fit = fit_window(y, device=device)
    m = _model_from_fit(fit, 0, idx)
    if m is not None:
        # the legacy sigma2 field from the AIC definition
        # (aic = n*log(sigma2) + 2k over the differenced length)
        n = min(len(y), _MAX_OBS) - d
        m.sigma2 = math.exp((m.aic - 2.0 * (p + q + 1)) / max(n, 1))
    return m


def _auto_arima(y: Sequence[float], max_p: int = 2, max_d: int = 1,
                max_q: int = 2, *,
                device: Union[None, str, torch.device] = None
                ) -> Optional[_ArimaModel]:
    """Small-grid AIC search via one batched grid fit on ``device``
    (deprecated): the first-wins argmin over the valid grid entries within
    the order bounds, the tie-breaking of ``select_order_step``."""
    from ..forecast.arima_batched import ORDER_GRID, fit_window

    fit = fit_window(np.asarray(y, float), device=device)
    best: Optional[int] = None
    best_aic = math.inf
    for i, (p, d, q) in enumerate(ORDER_GRID):
        if p > max_p or d > max_d or q > max_q:
            continue
        if bool(fit.valid[0, i]) and float(fit.aic[0, i]) < best_aic:
            best = i
            best_aic = float(fit.aic[0, i])
    return None if best is None else _model_from_fit(fit, 0, best)


def __getattr__(name: str):
    if name in _DEPRECATED:
        warnings.warn(
            f"repro_torch.core.arima.{name} is deprecated; use "
            f"{_DEPRECATED[name]} (repro_torch.core.arima is a shim over "
            f"the batched forecast subsystem and will be removed)",
            DeprecationWarning, stacklevel=2)
        if name == "ArimaForecaster":
            from ..forecast.forecaster import ArimaForecaster
            return ArimaForecaster
        return {"fit_arima": _fit_arima, "auto_arima": _auto_arima,
                "ArimaModel": _ArimaModel}[name]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
