"""Range-limited idle-time (IT) histograms (paper §4.2), batched over
applications: the port of ``repro/core/histogram.py``.

For each app a histogram of observed idle times with 1-minute bins up to a
configurable range (default 240 bins); ITs past the range count as
out-of-bounds (OOB). The pre-warm window is the head percentile's bin
lower edge less a margin, the keep-alive window covers up to the tail
percentile's bin upper edge plus the margin.

Batched state is a :class:`HistogramState` of ``[n_apps, n_bins]`` /
``[n_apps]`` tensors on an explicit device (:func:`init_state`), updated
for the whole fleet at once (:func:`record_idle_times`); the engines carry
*cumulative* counts instead (:func:`cum_record_idle_times`, and the
``[S, n_apps, n_bins]`` state of :mod:`repro_torch.kernels.histogram`).
:class:`AppHistogram` is the scalar twin of the control-plane path, used
by the ``"scalar"`` oracle and by the kernel parity tests. All decision
formulas live in :mod:`repro_torch.core.policy_math`.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from . import policy_math

__all__ = [
    "HistogramConfig",
    "HistogramState",
    "init_state",
    "record_idle_times",
    "percentile_windows",
    "find_first_ge",
    "cum_record_idle_times",
    "AppHistogram",
]


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


class HistogramState(NamedTuple):
    """Batched per-app histogram state (every tensor has leading dim
    n_apps, all on one device)."""

    counts: torch.Tensor       # [n_apps, n_bins] int32 in-bounds IT counts
    oob: torch.Tensor          # [n_apps] int32 count of out-of-bounds ITs
    total: torch.Tensor        # [n_apps] int32 count of in-bounds ITs
    cv_sum: torch.Tensor       # [n_apps] f32 Welford sum of bin counts
    cv_sum_sq: torch.Tensor    # [n_apps] f32 Welford sum of squared counts


def init_state(n_apps: int, cfg: HistogramConfig, *,
               device: Union[None, str, torch.device] = None
               ) -> HistogramState:
    """Empty state for ``n_apps`` apps on ``device`` (the card unless told
    otherwise; raises without one)."""
    dev = resolve_device(device)
    zeros = lambda shape, dt: torch.zeros(shape, dtype=dt, device=dev)
    return HistogramState(
        counts=zeros((n_apps, cfg.n_bins), torch.int32),
        oob=zeros((n_apps,), torch.int32),
        total=zeros((n_apps,), torch.int32),
        cv_sum=zeros((n_apps,), torch.float32),
        cv_sum_sq=zeros((n_apps,), torch.float32))


def record_idle_times(state: HistogramState, it_minutes: torch.Tensor,
                      active: torch.Tensor,
                      cfg: HistogramConfig) -> HistogramState:
    """Record one idle time per app (vectorized): ``it_minutes`` [n_apps]
    float, ``active`` [n_apps] bool (the apps that observed an IT)."""
    n_bins = cfg.n_bins
    safe, in_bounds, oob_hit = policy_math.classify_idle_time(
        it_minutes, active, cfg.bin_minutes, n_bins)
    hit = torch.nn.functional.one_hot(safe.long(), n_bins).to(torch.int32)
    hit = hit * in_bounds.to(torch.int32)[:, None]
    old_count = torch.gather(state.counts, 1, safe.long()[:, None])[:, 0]
    cv_sum, cv_sum_sq = policy_math.welford_update(
        state.cv_sum, state.cv_sum_sq, in_bounds, old_count)
    return HistogramState(
        counts=state.counts + hit,
        oob=state.oob + oob_hit.to(torch.int32),
        total=state.total + in_bounds.to(torch.int32),
        cv_sum=cv_sum,
        cv_sum_sq=cv_sum_sq)


def _weighted_percentile_bins(counts: torch.Tensor, total: torch.Tensor,
                              pct: float, round_up: bool) -> torch.Tensor:
    """Smallest bin b such that cumsum(counts)[b] >= pct% of total: the
    bin's lower edge index (``round_up`` False, the head rounds down) or
    index+1 (its upper edge, the tail rounds up), in bin units; ``n_bins``
    (+1 for round_up) when total == 0 — callers mask on total > 0."""
    cum = torch.cumsum(counts, dim=-1).to(torch.int32)
    thr = policy_math.percentile_threshold_scaled(total, pct)
    idx = policy_math.first_bin_ge_scaled(cum, thr, gather=True)
    return idx + (1 if round_up else 0)


def percentile_windows(state: HistogramState, cfg: HistogramConfig
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pre-warm, keep-alive) windows in minutes for every app, float32:
    pre-warm is the head bin's lower edge x (1 - margin); keep-alive the
    window *length* up to the tail bin's upper edge x (1 + margin). Apps
    with no in-bounds samples get (0, range)."""
    head_bin = _weighted_percentile_bins(
        state.counts, state.total, cfg.head_percentile, round_up=False)
    tail_bin = _weighted_percentile_bins(
        state.counts, state.total, cfg.tail_percentile, round_up=True)
    load_at, unload_at = policy_math.window_values(
        head_bin, tail_bin, cfg.bin_minutes, cfg.range_minutes, cfg.margin)
    keep_alive = unload_at - load_at
    has_data = state.total > 0
    prewarm = torch.where(has_data, load_at, 0.0)
    keep_alive = torch.where(has_data, keep_alive, cfg.range_minutes)
    return prewarm, keep_alive


# --- Incremental cumulative-count representation -----------------------------
#
# The engines carry *cumulative* bin counts: recording an idle time in bin b
# is a suffix add over [b, n_bins), and the percentile windows read straight
# off the maintained prefix sums — no per-step fleet-wide cumsum.


def cum_record_idle_times(
    cum: torch.Tensor, it_minutes: torch.Tensor, active: torch.Tensor,
    cfg: HistogramConfig,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Record one IT per app into cumulative counts ``cum`` [n_apps,
    n_bins] (left as it was). Returns (new_cum, old_count_at_bin,
    in_bounds, oob_hit); ``old_count`` is the pre-update raw count of the
    hit bin (the Welford CV update's input)."""
    safe, in_bounds, oob_hit = policy_math.classify_idle_time(
        it_minutes, active, cfg.bin_minutes, cum.shape[-1])
    old = policy_math.raw_count_at(cum, safe, gather=True)
    new_cum = policy_math.suffix_add(cum, safe, in_bounds)
    return new_cum, old, in_bounds, oob_hit


def find_first_ge(cum: torch.Tensor, threshold) -> torch.Tensor:
    """First bin index where row-wise nondecreasing ``cum`` >=
    ``threshold`` (a raw count); ``n_bins`` when no bin qualifies. A binary
    search: O(log n_bins) gathers per app."""
    return policy_math.first_bin_ge_scaled(
        cum, policy_math.scale_raw_threshold(threshold), gather=True)


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

    @property
    def cv(self) -> float:
        # float64 for reporting; the decision gate re-derives the float32
        # value through policy_math.use_histogram_gate.
        return float(policy_math.bin_count_cv(
            self._cv_sum, self._cv_sum_sq, self.cfg.n_bins, np.float64))

    @property
    def oob_fraction(self) -> float:
        seen = self.total + self.oob
        return self.oob / seen if seen else 0.0

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
