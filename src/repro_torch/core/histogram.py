"""Range-limited idle-time (IT) histograms (paper §4.2): the configuration
and the scalar per-app histogram of the control-plane path.

The fleet-wide state of the engines is the cumulative ``[S, n_apps,
n_bins]`` int32 tensor the sweep step carries (see
:mod:`repro_torch.kernels.histogram`); :class:`AppHistogram` is its scalar
twin, used by the ``"scalar"`` oracle and by the kernel parity tests. All
decision formulas live in :mod:`repro_torch.core.policy_math`.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from . import policy_math

__all__ = ["HistogramConfig", "AppHistogram"]


@dataclasses.dataclass(frozen=True)
class HistogramConfig:
    """Configuration of the range-limited histogram policy component."""

    bin_minutes: float = 1.0          # paper: 1-minute bins
    range_minutes: float = 240.0      # paper: 4-hour default range
    head_percentile: float = 5.0      # paper: 5th percentile -> pre-warm
    tail_percentile: float = 99.0     # paper: 99th percentile -> keep-alive
    margin: float = 0.10              # paper: 10% margin both sides

    @property
    def n_bins(self) -> int:
        return int(round(self.range_minutes / self.bin_minutes))


class AppHistogram:
    """Scalar per-application histogram (control-plane / reference path)."""

    def __init__(self, cfg: HistogramConfig):
        self.cfg = cfg
        self.counts = np.zeros(cfg.n_bins, np.int64)
        self.oob = 0
        self.total = 0
        self._cv_sum = 0.0
        self._cv_sum_sq = 0.0

    def record(self, it_minutes: float) -> None:
        safe, in_b, oob_hit = policy_math.classify_idle_time(
            float(it_minutes), True, self.cfg.bin_minutes, self.cfg.n_bins)
        if oob_hit:
            self.oob += 1
            return
        if not in_b:
            return
        b = int(safe)
        old = self.counts[b]
        self.counts[b] += 1
        self.total += 1
        cvs, cvss = policy_math.welford_update(
            self._cv_sum, self._cv_sum_sq, True, old)
        self._cv_sum, self._cv_sum_sq = float(cvs), float(cvss)

    def windows(self) -> Tuple[float, float]:
        """(prewarm, keep_alive) from the head/tail percentile bins. The
        bounds are float32; the keep-alive *length* is their exact float64
        difference, so ``prewarm + keep_alive`` rebuilds the float32 unload
        bound bit for bit."""
        cfg = self.cfg
        if self.total == 0:
            return 0.0, cfg.range_minutes
        cum = np.cumsum(self.counts)
        head_bin = int(policy_math.first_bin_ge_scaled(
            cum, policy_math.percentile_threshold_scaled(
                self.total, cfg.head_percentile), gather=False))
        tail_bin = int(policy_math.first_bin_ge_scaled(
            cum, policy_math.percentile_threshold_scaled(
                self.total, cfg.tail_percentile), gather=False)) + 1
        load_at, unload_at = policy_math.window_values(
            head_bin, tail_bin, cfg.bin_minutes, cfg.range_minutes, cfg.margin)
        return float(load_at), float(unload_at) - float(load_at)
