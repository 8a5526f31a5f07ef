"""Cold-start management policies (paper §4), scalar control-plane form.

A *policy* governs, per application, two windows measured from the end of
the last execution: ``prewarm`` (wait before re-loading the image; 0 means
"do not unload") and ``keep_alive`` (time the image stays loaded after the
(re)load). An invocation with idle time IT is warm iff it lands while the
image is resident; loaded-but-idle time is the wasted memory the provider
pays.

  * :class:`FixedKeepAlivePolicy` — the state of practice: prewarm 0,
    constant keep-alive.
  * :class:`NoUnloadingPolicy` — infinite keep-alive.
  * :class:`HybridHistogramPolicy` — the paper's histogram policy with its
    CV representativeness gate and, for apps whose idle times are mostly
    out of bounds, an ARIMA forecast of the next idle time
    (:class:`~repro_torch.forecast.forecaster.ArimaForecaster`, fitted on
    the policy's ``device``).
  * :class:`SpesPolicy` — a SPES-style next-idle predictor: an EW point
    forecast with a band that widens with the residual variance.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from . import policy_math
from ..forecast.forecaster import ArimaForecaster
from .histogram import AppHistogram, HistogramConfig

__all__ = [
    "PolicyWindows",
    "Policy",
    "FixedKeepAlivePolicy",
    "NoUnloadingPolicy",
    "HybridConfig",
    "HybridHistogramPolicy",
    "SpesConfig",
    "SpesPolicy",
    "is_warm",
    "loaded_idle_time",
]

INF = float("inf")


@dataclasses.dataclass(frozen=True)
class PolicyWindows:
    prewarm: float       # minutes
    keep_alive: float    # minutes


def is_warm(it: float, w: PolicyWindows) -> bool:
    """Whether an invocation with idle time ``it`` (minutes) hits warm."""
    load_at, unload_at = policy_math.window_bounds(w.prewarm, w.keep_alive)
    return bool(policy_math.warm_from_bounds(it, load_at, unload_at))


def loaded_idle_time(it: float, w: PolicyWindows) -> float:
    """Memory-time (minutes) the image sat loaded-but-idle during a gap of
    length ``it`` under windows ``w`` (execution time counts as 0)."""
    load_at, unload_at = policy_math.window_bounds(w.prewarm, w.keep_alive)
    return float(policy_math.idle_from_bounds(it, load_at, unload_at))


class Policy:
    """Scalar policy interface (one instance manages the whole fleet)."""

    name = "base"

    def windows(self, app_id: str) -> PolicyWindows:
        raise NotImplementedError

    def on_invocation(self, app_id: str,
                      idle_time: Optional[float]) -> PolicyWindows:
        """Record an invocation (``idle_time`` None for the first ever) and
        return the windows that govern the *next* gap."""
        raise NotImplementedError


class FixedKeepAlivePolicy(Policy):
    def __init__(self, keep_alive_minutes: float = 10.0):
        self.keep_alive = float(keep_alive_minutes)
        self.name = f"fixed-{keep_alive_minutes:g}m"

    def windows(self, app_id: str) -> PolicyWindows:
        return PolicyWindows(0.0, self.keep_alive)

    def on_invocation(self, app_id: str,
                      idle_time: Optional[float]) -> PolicyWindows:
        return self.windows(app_id)


class NoUnloadingPolicy(Policy):
    name = "no-unloading"

    def windows(self, app_id: str) -> PolicyWindows:
        return PolicyWindows(0.0, INF)

    def on_invocation(self, app_id: str,
                      idle_time: Optional[float]) -> PolicyWindows:
        return self.windows(app_id)


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    histogram: HistogramConfig = HistogramConfig()
    cv_threshold: float = 2.0        # paper: CV=2 default (Fig. 17)
    min_samples: int = 5             # "not enough ITs" -> standard keep-alive
    oob_fraction_threshold: float = 0.5   # "most ITs OOB" -> ARIMA
    arima_min_samples: int = 4       # need a few ITs before ARIMA can fit
    arima_margin: float = 0.15       # paper: 15% margin
    use_arima: bool = True

    @property
    def standard_keep_alive(self) -> float:
        # Paper: fall back to prewarm=0, keep-alive = histogram range.
        return self.histogram.range_minutes


@dataclasses.dataclass(frozen=True)
class SpesConfig:
    """Knobs of the SPES-style next-idle predictor policy: a streaming EW
    point forecast of each app's next idle interval with a confidence band
    that widens with the EW residual variance (the paper's §4.3 idea of
    pre-warming just before the predicted arrival, without the histogram).
    """
    alpha: float = 0.3               # EW smoothing weight per observation
    band_margin: float = 0.10        # relative half-band around the forecast
    band_sigma: float = 1.0          # residual-std multiplier for the band
    min_samples: int = 4             # ITs before the forecast governs
    standard_keep_alive: float = 240.0   # fallback until warmed up


class SpesPolicy(Policy):
    """SPES-style next-idle predictor (scalar control-plane path).

    State per app is the float32 ``(mean, var, n_obs)`` that
    :func:`~repro_torch.core.policy_math.spes_update` maintains; windows
    come from :func:`~repro_torch.core.policy_math.spes_window_from_counts`
    — the helpers the sweep engine scans, so verdicts are bit-identical
    across engines."""

    def __init__(self, cfg: SpesConfig = SpesConfig()):
        self.cfg = cfg
        self.name = f"spes-{cfg.alpha:g}"
        self._knobs = policy_math.SpesStepConfig.from_host(
            alpha=cfg.alpha, band_margin=cfg.band_margin,
            band_sigma=cfg.band_sigma, min_samples=cfg.min_samples,
            standard_keep=cfg.standard_keep_alive)
        self._state: Dict[str, Tuple[np.float32, np.float32, int]] = {}
        self._windows: Dict[str, PolicyWindows] = {}

    def _standard(self) -> PolicyWindows:
        return PolicyWindows(0.0, float(self.cfg.standard_keep_alive))

    def windows(self, app_id: str) -> PolicyWindows:
        w = self._windows.get(app_id)
        return w if w is not None else self._standard()

    def on_invocation(self, app_id: str,
                      idle_time: Optional[float]) -> PolicyWindows:
        k = self._knobs
        mean, var, n_obs = self._state.get(
            app_id, (np.float32(0.0), np.float32(0.0), 0))
        if idle_time is not None and idle_time >= 0:
            mean, var, n_obs = policy_math.spes_update(
                # repro-lint: ignore[x64-discipline] -- idle_time is an
                # inter-arrival gap, not an absolute clock; the single f32
                # quantization IS the cross-engine decision contract
                mean, var, n_obs, np.float32(idle_time), True, k.alpha,
                k.om_alpha)
            self._state[app_id] = (np.float32(mean), np.float32(var),
                                   int(n_obs))
        lo, hi = policy_math.spes_window_from_counts(
            mean, var, n_obs, k.min_samples, k.band_margin, k.band_sigma,
            k.standard_keep)
        # keep-alive as the float64 bound difference, as the engines
        # recover it
        w = PolicyWindows(float(lo), float(hi) - float(lo))
        self._windows[app_id] = w
        return w

    # -- checkpointing -------------------------------------------------------

    def state_dict(self) -> dict:
        return {
            "cfg": dataclasses.asdict(self.cfg),
            "state": {k: (float(m), float(v), int(n))
                      for k, (m, v, n) in self._state.items()},
            "windows": {k: (w.prewarm, w.keep_alive)
                        for k, w in self._windows.items()},
        }

    def load_state_dict(self, state: dict) -> None:
        for k, (m, v, n) in state.get("state", {}).items():
            self._state[k] = (np.float32(m), np.float32(v), int(n))
        for k, (p, ka) in state.get("windows", {}).items():
            self._windows[k] = PolicyWindows(p, ka)


class HybridHistogramPolicy(Policy):
    """The paper's hybrid histogram policy (scalar control-plane path).

    Decision per app (Figure 10): too few ITs, or a CV of bin counts below
    the threshold -> standard keep-alive (prewarm 0, keep-alive = range);
    mostly out-of-bounds ITs -> the ARIMA forecast of the next IT (prewarm
    ``(1 - arima_margin) * pred``, keep-alive ``2 * arima_margin * pred``),
    or the standard keep-alive while it abstains or ``use_arima`` is off;
    otherwise the histogram's head/tail percentile windows with the margin.
    The forecasters fit on ``device`` (the card unless told otherwise;
    nothing is fitted, and no card is needed, until an app takes the ARIMA
    branch).
    """

    def __init__(self, cfg: HybridConfig = HybridConfig(), *,
                 device: Union[None, str, torch.device] = None):
        self.cfg = cfg
        self.device = device
        self.name = f"hybrid-{cfg.histogram.range_minutes:g}m"
        self._hist: Dict[str, AppHistogram] = {}
        self._arima: Dict[str, ArimaForecaster] = {}
        self._windows: Dict[str, PolicyWindows] = {}

    def _standard(self) -> PolicyWindows:
        return PolicyWindows(0.0, self.cfg.standard_keep_alive)

    def _decide(self, app_id: str) -> PolicyWindows:
        cfg = self.cfg
        h = self._hist.get(app_id)
        if h is None or (h.total + h.oob) < cfg.min_samples:
            return self._standard()
        if policy_math.oob_heavy(h.total, h.oob, cfg.oob_fraction_threshold):
            # the histogram cannot represent this app: the time-series path
            # (or the standard keep-alive while ARIMA abstains or is off)
            if cfg.use_arima:
                fc = self._arima.get(app_id)
                if fc is not None and fc.n_obs >= cfg.arima_min_samples:
                    pred = fc.forecast()
                    if pred is not None and math.isfinite(pred) and pred > 0:
                        return PolicyWindows(*policy_math.arima_window(
                            pred, cfg.arima_margin))
            return self._standard()
        if not policy_math.use_histogram_gate(
                h.total, h.oob, h._cv_sum, h._cv_sum_sq, cfg.histogram.n_bins,
                cfg.min_samples, cfg.cv_threshold, cfg.oob_fraction_threshold):
            # too new or too uniform
            return self._standard()
        return PolicyWindows(*h.windows())

    def windows(self, app_id: str) -> PolicyWindows:
        w = self._windows.get(app_id)
        return w if w is not None else self._standard()

    def on_invocation(self, app_id: str,
                      idle_time: Optional[float]) -> PolicyWindows:
        cfg = self.cfg
        if app_id not in self._hist:
            self._hist[app_id] = AppHistogram(cfg.histogram)
            if cfg.use_arima:
                self._arima[app_id] = ArimaForecaster(device=self.device)
        if idle_time is not None and idle_time >= 0:
            self._hist[app_id].record(idle_time)
            if cfg.use_arima:
                self._arima[app_id].observe(idle_time)
        w = self._decide(app_id)
        self._windows[app_id] = w
        return w

    # -- checkpointing (the serving fleet persists learned windows) ----------

    def state_dict(self) -> dict:
        """The learned state, in the reference's layout."""
        return {
            "cfg": dataclasses.asdict(self.cfg),
            "hist": {
                k: {"counts": h.counts.tolist(), "oob": h.oob,
                    "total": h.total, "cv_sum": h._cv_sum,
                    "cv_sum_sq": h._cv_sum_sq}
                for k, h in self._hist.items()
            },
            "arima": {k: f.state_dict() for k, f in self._arima.items()},
            "windows": {k: (w.prewarm, w.keep_alive)
                        for k, w in self._windows.items()},
        }

    def load_state_dict(self, state: dict) -> None:
        for k, hs in state["hist"].items():
            h = AppHistogram(self.cfg.histogram)
            h.counts = np.asarray(hs["counts"], np.int64)
            h.oob = int(hs["oob"])
            h.total = int(hs["total"])
            h._cv_sum = float(hs["cv_sum"])
            h._cv_sum_sq = float(hs["cv_sum_sq"])
            self._hist[k] = h
        for k, fs in state.get("arima", {}).items():
            f = ArimaForecaster(device=self.device)
            f.load_state_dict(fs)
            self._arima[k] = f
        for k, (p, ka) in state.get("windows", {}).items():
            self._windows[k] = PolicyWindows(p, ka)
