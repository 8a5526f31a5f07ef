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
    CV representativeness gate. Its ARIMA path for out-of-bounds apps is not
    ported yet (ROADMAP Queue A item 7): ``use_arima=True`` raises.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from . import policy_math
from .histogram import AppHistogram, HistogramConfig

__all__ = [
    "PolicyWindows",
    "Policy",
    "FixedKeepAlivePolicy",
    "NoUnloadingPolicy",
    "HybridConfig",
    "HybridHistogramPolicy",
    "is_warm",
    "loaded_idle_time",
    "ARIMA_NOT_PORTED",
]

INF = float("inf")

ARIMA_NOT_PORTED = (
    "the hybrid policy's ARIMA path (use_arima=True) is not ported to "
    "repro_torch yet (ROADMAP Queue A item 7, forecast/); pass "
    "use_arima=False")


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


class HybridHistogramPolicy(Policy):
    """The paper's hybrid histogram policy (scalar control-plane path).

    Decision per app (Figure 10): too few ITs, mostly out-of-bounds ITs, or
    a CV of bin counts below the threshold -> standard keep-alive (prewarm
    0, keep-alive = range); otherwise the head/tail percentile windows with
    the margin.
    """

    def __init__(self, cfg: HybridConfig = HybridConfig()):
        if cfg.use_arima:
            raise NotImplementedError(ARIMA_NOT_PORTED)
        self.cfg = cfg
        self.name = f"hybrid-{cfg.histogram.range_minutes:g}m"
        self._hist: Dict[str, AppHistogram] = {}
        self._windows: Dict[str, PolicyWindows] = {}

    def _standard(self) -> PolicyWindows:
        return PolicyWindows(0.0, self.cfg.standard_keep_alive)

    def _decide(self, app_id: str) -> PolicyWindows:
        cfg = self.cfg
        h = self._hist.get(app_id)
        if h is None or (h.total + h.oob) < cfg.min_samples:
            return self._standard()
        if not policy_math.use_histogram_gate(
                h.total, h.oob, h._cv_sum, h._cv_sum_sq, cfg.histogram.n_bins,
                cfg.min_samples, cfg.cv_threshold, cfg.oob_fraction_threshold):
            # too new, too uniform, or mostly out of bounds
            return self._standard()
        return PolicyWindows(*h.windows())

    def windows(self, app_id: str) -> PolicyWindows:
        w = self._windows.get(app_id)
        return w if w is not None else self._standard()

    def on_invocation(self, app_id: str,
                      idle_time: Optional[float]) -> PolicyWindows:
        if app_id not in self._hist:
            self._hist[app_id] = AppHistogram(self.cfg.histogram)
        if idle_time is not None and idle_time >= 0:
            self._hist[app_id].record(idle_time)
        w = self._decide(app_id)
        self._windows[app_id] = w
        return w
