"""Single source of the hybrid keep-alive policy math (paper §4), in PyTorch.

The counterpart of ``repro/core/policy_math.py``: every engine of this
package — the scalar control-plane policy (:class:`~repro_torch.core.policy.
HybridHistogramPolicy` / ``AppHistogram``), the float64 ``"fused"`` engine
and the plain version of the CUDA sweep-step kernel — computes its decisions
through the helpers below, and ``tests/test_torch_policy_math.py`` holds each
helper equal to its JAX namesake on seeded random state.

Dtype discipline (what makes a float32 step — the TPU kernel's — bit-match
the float64 oracle where its idle times are exact), as in the reference:

  * the *decision layer* is dtype-invariant: percentile thresholds are exact
    int32 arithmetic, CV and the window values are float32 computed from
    exactly-representable integer state;
  * the *time layer* (inter-arrival times, waste) stays in the step's
    dtype; this package's engines keep it in float64.

Helpers are polymorphic over host values (python/numpy scalars and arrays —
the scalar policy pays no tensor overhead) and ``torch.Tensor`` s on any
device. Helpers with a row-wise lookup take a ``gather`` flag: ``True`` uses
``torch.gather`` (binary search for the percentile bin), ``False`` masked
reductions; both give identical results.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

__all__ = [
    "PCT_SCALE",
    "MAX_SCALED_COUNT",
    "pct_numer",
    "margin_factors",
    "window_bounds",
    "warm_from_bounds",
    "idle_from_bounds",
    "classify_idle_time",
    "suffix_add",
    "suffix_add_",
    "raw_count_at",
    "welford_update",
    "bin_count_cv",
    "percentile_threshold_scaled",
    "percentile_threshold_scaled_numer",
    "first_bin_ge_scaled",
    "window_values",
    "window_values_from_factors",
    "standard_window_bounds",
    "use_histogram_gate",
    "use_histogram_gate_from_cv",
    "oob_heavy",
    "HybridStepConfig",
    "fused_hybrid_step_math",
]

# Percentiles are quantized to 1/100 of a percent and compared in exact
# integer arithmetic: ``cum >= ceil(total*pct/100)`` iff
# ``cum*PCT_SCALE >= total*pct_numer``.
PCT_SCALE = 10_000

#: Largest per-app cumulative count whose scaled compare (``cum *
#: PCT_SCALE``) still fits int32 (``simulator._check_scan_width`` guards it).
# repro-lint: ignore[single-source-decision-math] -- the port's single
# source of this math, held equal to repro/core/policy_math.py by
# tests/test_torch_policy_math.py
MAX_SCALED_COUNT = (2 ** 31 - 1) // PCT_SCALE

_TORCH_DTYPE = {np.float32: torch.float32, np.float64: torch.float64}


def _is_t(*xs) -> bool:
    return any(isinstance(x, torch.Tensor) for x in xs)


def _f32(x):
    """Exact float32 view of a config knob, host or tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return np.float32(x)


def _like(x, ref: torch.Tensor, dtype=None) -> torch.Tensor:
    """``x`` as a tensor on ``ref``'s device (for binary torch ops that take
    no python scalar)."""
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(dtype)
    return torch.as_tensor(x, dtype=dtype or ref.dtype, device=ref.device)


# --------------------------------------------------------------------------
# Warm/cold + waste verdicts (§4.1)
# --------------------------------------------------------------------------


def _both_float(a, b) -> bool:
    return isinstance(a, (float, int)) and isinstance(b, (float, int))


def window_bounds(prewarm, keep_alive):
    """(load_at, unload_at) residency offsets from the last execution end;
    ``prewarm <= 0`` keeps the image resident on ``[0, keep_alive]``."""
    if _both_float(prewarm, keep_alive):
        load_at = prewarm if prewarm > 0.0 else 0.0
        return load_at, load_at + keep_alive
    if _is_t(prewarm, keep_alive):
        load_at = torch.where(prewarm > 0.0, prewarm, 0.0)
    else:
        load_at = np.where(prewarm > 0.0, prewarm, 0.0)
    return load_at, load_at + keep_alive


def warm_from_bounds(it, load_at, unload_at):
    """Warm iff the invocation arrives while the image is resident."""
    # repro-lint: ignore[single-source-decision-math] -- this module is the
    # port's single source of the verdict, held equal to
    # repro/core/policy_math.py by tests/test_torch_policy_math.py
    return (it >= load_at) & (it <= unload_at)


def idle_from_bounds(it, load_at, unload_at):
    """Loaded-but-idle memory time during a gap of length ``it`` (>= 0)."""
    if _both_float(it, load_at) and _both_float(it, unload_at):
        return max(min(it, unload_at) - load_at, 0.0)
    if _is_t(it, load_at, unload_at):
        ref = next(x for x in (it, load_at, unload_at)
                   if isinstance(x, torch.Tensor))
        return torch.clamp(torch.minimum(_like(it, ref), _like(unload_at, ref))
                           - load_at, min=0.0)
    return np.maximum(np.minimum(it, unload_at) - load_at, 0.0)


# --------------------------------------------------------------------------
# Histogram update (§4.2)
# --------------------------------------------------------------------------


def classify_idle_time(it, active, bin_minutes, n_bins):
    """Bin an idle time: (clipped_bin, in_bounds, oob_hit).

    The tensor path clamps the float bin index to ``[-1, n_bins]`` before
    the int32 conversion: ``it`` is ``+inf`` on inactive rows, and casting a
    non-finite or huge float to an integer is undefined in C (PyTorch gives
    INT_MIN on the CPU). The clamp keeps every predicate and the clipped bin
    of the reference's saturating conversion."""
    if isinstance(it, float):          # scalar control-plane fast path
        bin_idx = math.floor(it / bin_minutes)
        in_bounds = bool(active) and 0 <= bin_idx < n_bins
        oob_hit = bool(active) and bin_idx >= n_bins
        return min(max(bin_idx, 0), n_bins - 1), in_bounds, oob_hit
    if not _is_t(it):
        bin_idx = np.floor(it / bin_minutes).astype(np.int32)
        in_bounds = active & (bin_idx >= 0) & (bin_idx < n_bins)
        oob_hit = active & (bin_idx >= n_bins)
        return np.clip(bin_idx, 0, n_bins - 1), in_bounds, oob_hit
    q = torch.floor(it / _like(bin_minutes, it)).clamp(min=-1.0)
    nb = _like(n_bins, q, torch.int32)
    bin_idx = torch.minimum(q, nb.to(q.dtype)).to(torch.int32)
    in_bounds = active & (bin_idx >= 0) & (bin_idx < nb)
    oob_hit = active & (bin_idx >= nb)
    safe = torch.minimum(bin_idx.clamp(min=0), nb - 1)
    return safe, in_bounds, oob_hit


def _bin_iota(cum: torch.Tensor) -> torch.Tensor:
    return torch.arange(cum.shape[-1], dtype=torch.int32, device=cum.device)


def suffix_add_(cum, safe_bin, in_bounds):
    """Record a hit at ``safe_bin`` into cumulative counts ``cum`` IN PLACE:
    one observation is a +1 over the suffix ``[safe_bin, n_bins)``."""
    hit = (_bin_iota(cum) >= safe_bin[..., None]) & in_bounds[..., None]
    return cum.add_(hit.to(cum.dtype))


def suffix_add(cum, safe_bin, in_bounds):
    """:func:`suffix_add_` on a copy (``cum`` is left as it was)."""
    return suffix_add_(cum.clone(), safe_bin, in_bounds)


def raw_count_at(cum, safe_bin, *, gather: bool):
    """Pre-update raw count of ``safe_bin`` read off cumulative counts
    (int32). ``gather=True`` indexes each row; ``gather=False`` uses masked
    sums. Both return the same values."""
    if gather:
        def take(idx):
            return torch.gather(cum, -1, idx[..., None].long())[..., 0] \
                .to(torch.int32)
        cum_at = take(safe_bin)
        cum_below = torch.where(safe_bin > 0,
                                take(torch.clamp(safe_bin - 1, min=0)), 0)
        return (cum_at - cum_below).to(torch.int32)
    iota = _bin_iota(cum)
    zero = torch.zeros((), dtype=cum.dtype, device=cum.device)
    cum_at = torch.where(iota == safe_bin[..., None], cum, zero).sum(-1)
    cum_below = torch.where(iota == (safe_bin - 1)[..., None], cum,
                            zero).sum(-1)
    return (cum_at - cum_below).to(torch.int32)


def welford_update(cv_sum, cv_sum_sq, in_bounds, old_count):
    """O(1) update of the bin-count sum / sum-of-squares accumulators: a bin
    going ``old -> old+1`` adds ``2*old + 1`` to the sum of squares. The
    accumulator dtype is kept (float64 oracle, float32 kernel)."""
    if isinstance(cv_sum, float):      # scalar control-plane fast path
        inb = 1.0 if in_bounds else 0.0
        return cv_sum + inb, cv_sum_sq + inb * (2.0 * float(old_count) + 1.0)
    if _is_t(cv_sum):
        inb = in_bounds.to(cv_sum.dtype)
        old = old_count.to(cv_sum.dtype)
    else:
        dt = cv_sum.dtype if hasattr(cv_sum, "dtype") else np.float64
        inb = np.asarray(in_bounds, dt)
        old = np.asarray(old_count, dt)
    return cv_sum + inb, cv_sum_sq + inb * (2.0 * old + 1.0)


# --------------------------------------------------------------------------
# Representativeness (CV of bin counts, §4.2)
# --------------------------------------------------------------------------


def bin_count_cv(cv_sum, cv_sum_sq, n_bins, dtype=np.float32):
    """Coefficient of variation of the bin counts from the accumulators.

    The gate evaluates it in float32 in every engine; every op rounds once
    (``cvss/n_bins - mean*mean`` must not contract into a fused
    multiply-subtract, or the ``>= cv_threshold`` compare can flip)."""
    if isinstance(cv_sum, float):              # scalar control-plane paths
        if dtype is np.float64:
            mean = cv_sum / n_bins
            if mean <= 0.0:
                return 0.0
            var = max(cv_sum_sq / n_bins - mean * mean, 0.0)
            return math.sqrt(var) / max(mean, 1e-9)
        mean = np.float32(cv_sum) / np.float32(n_bins)
        if not mean > 0:
            return np.float32(0.0)
        var = np.float32(cv_sum_sq) / np.float32(n_bins) - mean * mean
        if var < 0:
            var = np.float32(0.0)
        return np.sqrt(var) / max(mean, np.float32(1e-9))
    if not _is_t(cv_sum, cv_sum_sq):
        cvs = np.asarray(cv_sum, dtype)
        cvss = np.asarray(cv_sum_sq, dtype)
        mean = cvs / n_bins
        var = np.maximum(cvss / n_bins - mean * mean, dtype(0.0))
        return np.where(mean > 0, np.sqrt(var) / np.maximum(mean, dtype(1e-9)),
                        dtype(0.0))
    tdt = _TORCH_DTYPE[dtype]
    cvs, cvss = cv_sum.to(tdt), cv_sum_sq.to(tdt)
    nb = _like(n_bins, cvs, tdt)   # a device tensor: CUDA divides by a
    mean = cvs / nb                # python scalar via its reciprocal
    var = torch.clamp(cvss / nb - mean * mean, min=0.0)
    floor = float(dtype(1e-9))
    return torch.where(mean > 0, _sqrt_rn(var) / torch.clamp(mean, min=floor),
                       0.0)


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root. PyTorch's vectorized float32 sqrt on
    the CPU is not (it is off by one ulp for some inputs); the float64 root
    rounded once to float32 is, since 53 >= 2 * 24 + 2 bits."""
    if x.dtype == torch.float32:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


# --------------------------------------------------------------------------
# Percentile windows (§4.2)
# --------------------------------------------------------------------------


def pct_numer(pct: float) -> int:
    """Percentile as an exact integer numerator over PCT_SCALE."""
    # repro-lint: ignore[single-source-decision-math] -- the port's single
    # source of this math, held equal to repro/core/policy_math.py by
    # tests/test_torch_policy_math.py
    return int(round(pct * (PCT_SCALE / 100.0)))


def percentile_threshold_scaled(total, pct: float):
    """Scaled percentile threshold: ``cum`` hits the pct-percentile iff
    ``cum * PCT_SCALE >= threshold`` (floor of one sample). Integer math."""
    return percentile_threshold_scaled_numer(total, pct_numer(pct))


def percentile_threshold_scaled_numer(total, numer):
    """:func:`percentile_threshold_scaled` from an integer numerator, which
    may be a per-config int32 tensor (the sweep's percentile axis)."""
    if isinstance(total, int) and isinstance(numer, (int, np.integer)):
        return max(total * int(numer), PCT_SCALE)
    if not _is_t(total, numer):
        return np.maximum(np.int64(total) * numer, PCT_SCALE)
    ref = total if isinstance(total, torch.Tensor) else numer
    # int32 like the reference (callers guard widths with MAX_SCALED_COUNT)
    prod = _like(total, ref, torch.int32) * _like(numer, ref, torch.int32)
    return torch.clamp(prod, min=PCT_SCALE)


def first_bin_ge_scaled(cum, thr_scaled, *, gather: bool):
    """First bin index where ``cum * PCT_SCALE >= thr_scaled``; ``n_bins``
    when no bin qualifies. ``gather=True`` runs an O(log n_bins) binary
    search, ``gather=False`` a masked min over the bin index. Identical
    results on nondecreasing rows."""
    n_bins = cum.shape[-1]
    if not _is_t(cum, thr_scaled):
        cum = np.asarray(cum, np.int64)
        if cum.ndim == 1 and np.ndim(thr_scaled) == 0:
            # host fast path: cum*S >= thr iff cum >= ceil(thr/S)
            # repro-lint: ignore[single-source-decision-math] -- the port's single
            # source of this math, held equal to repro/core/policy_math.py by
            # tests/test_torch_policy_math.py
            need = -(-int(thr_scaled) // PCT_SCALE)
            return int(np.searchsorted(cum, need, side="left"))
        iota = np.broadcast_to(np.arange(n_bins), cum.shape)
        # repro-lint: ignore[single-source-decision-math] -- the port's single
        # source of this math, held equal to repro/core/policy_math.py by
        # tests/test_torch_policy_math.py
        hit = cum * PCT_SCALE >= np.asarray(thr_scaled)[..., None]
        return np.min(np.where(hit, iota, n_bins), axis=-1)
    thr = _like(thr_scaled, cum, torch.int32)
    if not gather:
        iota = _bin_iota(cum)
        # repro-lint: ignore[single-source-decision-math] -- the port's single
        # source of this math, held equal to repro/core/policy_math.py by
        # tests/test_torch_policy_math.py
        hit = cum.to(torch.int32) * PCT_SCALE >= thr[..., None]
        return torch.where(hit, iota, n_bins).amin(-1).to(torch.int32)
    rows_shape = torch.broadcast_shapes(cum.shape[:-1], thr.shape)
    thr = thr.expand(rows_shape)
    cum = cum.expand(rows_shape + (n_bins,))
    lo = torch.zeros(rows_shape, dtype=torch.int32, device=cum.device)
    hi = torch.full(rows_shape, n_bins, dtype=torch.int32, device=cum.device)
    # search space is [0, n_bins] — n_bins + 1 candidate answers
    for _ in range(int(np.ceil(np.log2(n_bins + 1)))):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        probe = torch.clamp(mid, max=n_bins - 1)[..., None].long()
        v = torch.gather(cum, -1, probe)[..., 0].to(torch.int32)
        # repro-lint: ignore[single-source-decision-math] -- the port's single
        # source of this math, held equal to repro/core/policy_math.py by
        # tests/test_torch_policy_math.py
        ge = (v * PCT_SCALE >= thr) & (mid < n_bins)
        hi = torch.where(ge, mid, hi)
        lo = torch.where(ge, lo, torch.minimum(mid + 1, hi))
    return hi


def margin_factors(margin: float) -> Tuple[np.float32, np.float32]:
    """The float32 margin factors (``1 ± margin`` rounds once, in float64,
    before the float32 cast)."""
    # repro-lint: ignore[single-source-decision-math] -- this module is the
    # port's single source of the margin factors, held equal to
    # repro/core/policy_math.py by tests/test_torch_policy_math.py
    lo = 1.0 - margin
    # repro-lint: ignore[single-source-decision-math] -- as above: the port's
    # single source, tested against the reference
    hi = 1.0 + margin
    return np.float32(lo), np.float32(hi)


def window_values(head_bin, tail_bin, bin_minutes: float,
                  range_minutes: float, margin: float):
    """(load_at, unload_at) in minutes from percentile bin indices, always
    float32: load_at = head lower edge x (1 - margin); unload_at = tail upper
    edge (clamped to the range) x (1 + margin), never below load_at."""
    lo, hi = margin_factors(margin)
    return window_values_from_factors(head_bin, tail_bin,
                                      np.float32(bin_minutes),
                                      np.float32(range_minutes), lo, hi)


def window_values_from_factors(head_bin, tail_bin, bin_f32, range_f32,
                               margin_lo, margin_hi):
    """:func:`window_values` from precomputed float32 knobs (scalars or
    per-config tensors). Products go left to right: ``head*bin*margin_lo``,
    then ``min(tail*bin, range)*margin_hi`` clamped to ``>= load_at``."""
    if not _is_t(head_bin, tail_bin, bin_f32, margin_lo):
        f = np.float32
        head = np.asarray(head_bin, f)
        tail = np.asarray(tail_bin, f)
        load_at = head * bin_f32 * margin_lo
        unload_at = np.minimum(tail * bin_f32, range_f32) * margin_hi
        return load_at, np.maximum(unload_at, load_at)
    ref = next(x for x in (head_bin, tail_bin, bin_f32, margin_lo)
               if isinstance(x, torch.Tensor))
    f = torch.float32
    head = _like(head_bin, ref, f)
    tail = _like(tail_bin, ref, f)
    load_at = head * _f32(bin_f32) * _f32(margin_lo)
    unload_at = torch.minimum(tail * _f32(bin_f32),
                              _like(range_f32, ref, f)) * _f32(margin_hi)
    return load_at, torch.maximum(unload_at, load_at)


def standard_window_bounds(standard_keep):
    """The fallback windows: never unload early, keep for the full range."""
    return np.float32(0.0), _f32(standard_keep)


# --------------------------------------------------------------------------
# Decision gates (Fig. 10)
# --------------------------------------------------------------------------


def oob_heavy(total, oob, oob_fraction_threshold):
    """Mostly-out-of-bounds check (routes an app to the time-series path)."""
    f = np.float32
    if isinstance(total, int):             # scalar control-plane fast path
        return bool(f(oob) > f(oob_fraction_threshold) * f(max(total + oob, 1)))
    if not _is_t(total, oob):
        return np.asarray(oob).astype(f) > _f32(oob_fraction_threshold) * \
            np.maximum(total + oob, 1).astype(f)
    return oob.to(torch.float32) > _f32(oob_fraction_threshold) * \
        torch.clamp(total + oob, min=1).to(torch.float32)


def use_histogram_gate(total, oob, cv_sum, cv_sum_sq, n_bins,
                       min_samples, cv_threshold, oob_fraction_threshold):
    """Whether the histogram windows govern the next gap (else the standard
    keep-alive). Evaluated in int/float32 so every engine takes the same
    branch."""
    if isinstance(total, int):             # scalar control-plane fast path
        return bool(
            total + oob >= min_samples and total > 0
            and not oob_heavy(total, oob, oob_fraction_threshold)
            and bin_count_cv(float(cv_sum), float(cv_sum_sq), n_bins,
                             np.float32) >= np.float32(cv_threshold))
    cv = bin_count_cv(cv_sum, cv_sum_sq, n_bins, np.float32)
    return use_histogram_gate_from_cv(total, oob, cv, min_samples,
                                      cv_threshold, oob_fraction_threshold)


def use_histogram_gate_from_cv(total, oob, cv, min_samples, cv_threshold,
                               oob_fraction_threshold):
    """The gate from a precomputed float32 CV (tensor path)."""
    seen = total + oob
    return (seen >= min_samples) & (cv >= _f32(cv_threshold)) \
        & (total > 0) & ~oob_heavy(total, oob, oob_fraction_threshold)


# --------------------------------------------------------------------------
# The fused simulator step (one invocation column for the whole fleet)
# --------------------------------------------------------------------------


class HybridStepConfig(NamedTuple):
    """One hybrid-policy configuration in the exact dtypes the decision
    layer consumes. Leaves are python/numpy scalars (single config) or
    ``[S, 1]`` tensors broadcast against the app axis (the sweep's config
    axis)."""
    n_bins: object        # i32 — effective bin count (<= allocated bins)
    head_numer: object    # i32 — head percentile numerator over PCT_SCALE
    tail_numer: object    # i32 — tail percentile numerator over PCT_SCALE
    margin_lo: object     # f32 — (1 - margin), rounded once on the host
    margin_hi: object     # f32 — (1 + margin)
    bin_minutes: object   # engine time dtype — IT binning divisor
    bin_f32: object       # f32 — bin width as the window values consume it
    range_f32: object     # f32 — histogram range for the window clamp
    cv_threshold: object  # f32
    min_samples: object   # i32
    oob_threshold: object  # f32
    standard_keep: object  # f32 — fallback keep-alive (== range)

    @classmethod
    def from_host(cls, *, n_bins: int, head_pct: float, tail_pct: float,
                  margin: float, bin_minutes: float, range_minutes: float,
                  cv_threshold: float, min_samples: int, oob_threshold: float,
                  standard_keep: float) -> "HybridStepConfig":
        lo, hi = margin_factors(margin)
        return cls(
            n_bins=int(n_bins), head_numer=pct_numer(head_pct),
            tail_numer=pct_numer(tail_pct), margin_lo=lo, margin_hi=hi,
            bin_minutes=float(bin_minutes), bin_f32=np.float32(bin_minutes),
            range_f32=np.float32(range_minutes),
            cv_threshold=np.float32(cv_threshold),
            min_samples=int(min_samples),
            oob_threshold=np.float32(oob_threshold),
            standard_keep=np.float32(standard_keep))


def fused_hybrid_step_math(t_now, prev_t, cum, oob, cv_sum, cv_sum_sq,
                           prewarm, unload_at, cold, waste, *,
                           cfg: HybridStepConfig, gather: bool):
    """One fused hybrid-policy step: warm/cold + waste verdict under the
    carried windows, histogram suffix-add, Welford CV update, and the
    percentile-window decision for the next gap.

    ``cum`` is updated IN PLACE (it is the one large state: ``[S, n,
    n_bins]``) and returned as the second output; the other eight outputs
    are new tensors. The time dtype (float64 or float32) is ``t_now``'s; the
    decision layer is int32/float32 whatever it is.
    """
    wdtype = t_now.dtype
    valid = torch.isfinite(t_now)
    first = ~torch.isfinite(prev_t)
    it = t_now - prev_t

    # Verdict for the gap that just closed.
    is_cold = valid & (first | ~warm_from_bounds(it, prewarm, unload_at))
    gap_waste = torch.where(valid & ~first,
                            idle_from_bounds(it, prewarm, unload_at), 0.0)

    # Histogram + CV update on the cumulative representation.
    rec = valid & ~first
    safe, in_b, oob_hit = classify_idle_time(it, rec, cfg.bin_minutes,
                                             cfg.n_bins)
    old = raw_count_at(cum, safe, gather=gather)
    suffix_add_(cum, safe, in_b)
    # the last prefix sum is the in-bounds total (cum is nondecreasing)
    total = (cum[..., -1] if gather else cum.amax(-1)).to(torch.int32)
    oob = oob + oob_hit.to(torch.int32)
    cv_sum, cv_sum_sq = welford_update(cv_sum, cv_sum_sq, in_b, old)

    # Decision layer (int/float32 — dtype-invariant across engines).
    head_thr = percentile_threshold_scaled_numer(total, cfg.head_numer)
    tail_thr = percentile_threshold_scaled_numer(total, cfg.tail_numer)
    head_bin = first_bin_ge_scaled(cum, head_thr, gather=gather)
    tail_bin = first_bin_ge_scaled(cum, tail_thr, gather=gather) + 1
    new_load, new_unload = window_values_from_factors(
        head_bin, tail_bin, cfg.bin_f32, cfg.range_f32, cfg.margin_lo,
        cfg.margin_hi)
    use_hist = use_histogram_gate(total, oob, cv_sum, cv_sum_sq, cfg.n_bins,
                                  cfg.min_samples, cfg.cv_threshold,
                                  cfg.oob_threshold)
    std_load, std_unload = standard_window_bounds(cfg.standard_keep)
    new_load = torch.where(use_hist, new_load, _like(std_load, new_load))
    new_unload = torch.where(use_hist, new_unload,
                             _like(std_unload, new_unload))

    # Windows decided now govern the next gap of apps that saw an event.
    prewarm = torch.where(valid, new_load.to(wdtype), prewarm)
    unload_at = torch.where(valid, new_unload.to(wdtype), unload_at)
    prev_t = torch.where(valid, t_now, prev_t)
    return (prev_t, cum, oob, cv_sum, cv_sum_sq, prewarm, unload_at,
            cold + is_cold.to(cold.dtype), waste + gap_waste)
