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

:func:`fused_hybrid_sweep_step_math` is the sweep step, factored as the
reference's: the histogram state is carried once per distinct histogram
shape (group layer), the percentile windows computed once per distinct
window variant, the gate once per distinct gate variant, and each of the S
configs selects its (window, gate) pair (:class:`HybridSweepBlock`).
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
    "scale_raw_threshold",
    "margin_factors",
    "window_bounds",
    "warm_from_bounds",
    "idle_from_bounds",
    "classify_idle_time",
    "suffix_add",
    "raw_count_at",
    "welford_update",
    "bin_count_cv",
    "percentile_threshold_scaled",
    "percentile_threshold_scaled_numer",
    "first_bin_ge_scaled",
    "first_bin_ge_scaled_grouped",
    "window_values",
    "window_values_from_factors",
    "standard_window_bounds",
    "use_histogram_gate",
    "use_histogram_gate_from_cv",
    "oob_heavy",
    "arima_window",
    "SpesStepConfig",
    "spes_update",
    "spes_window_from_counts",
    "fused_spes_step_math",
    "HybridStepConfig",
    "HybridSweepBlock",
    "SweepIdentities",
    "fused_hybrid_step_math",
    "hybrid_sweep_decide",
    "fused_hybrid_sweep_step_math",
    # the port's own: the in-place suffix add its steps use
    "suffix_add_",
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


def _f64(x):
    """float64 view of a value, host or tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64)
    return np.float64(x)


def _i32(x):
    """int32 view of a config knob, host or tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int32)
    return np.int32(x)


def _where(cond, a, b):
    """``np.where`` on host values, ``torch.where`` once a tensor is
    involved (host operands become tensors on its device)."""
    if not _is_t(cond, a, b):
        return np.where(cond, a, b)
    ref = next(x for x in (cond, a, b) if isinstance(x, torch.Tensor))
    as_t = lambda x: x if isinstance(x, torch.Tensor) else torch.as_tensor(
        x, device=ref.device)
    return torch.where(as_t(cond), as_t(a), as_t(b))


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


def scale_raw_threshold(threshold):
    """Lift a raw *count* threshold into the scaled domain of
    :func:`first_bin_ge_scaled`: ``threshold * PCT_SCALE``, in the int32
    the scaled compare runs in (callers guard widths with
    :data:`MAX_SCALED_COUNT`, so this never overflows)."""
    if not _is_t(threshold):
        # repro-lint: ignore[single-source-decision-math] -- the port's single
        # source of this math, held equal to repro/core/policy_math.py by
        # tests/test_torch_core_rest.py
        return np.int64(threshold) * PCT_SCALE
    # repro-lint: ignore[single-source-decision-math] -- as above: the port's
    # single source, tested against the reference
    return threshold.to(torch.int32) * PCT_SCALE


def first_bin_ge_scaled_grouped(gcum, group, thr_scaled):
    """Per-variant percentile search over *grouped* cumulative rows.

    ``gcum`` is [G, n_apps, n_bins] (one histogram state per distinct
    histogram shape); ``group`` [W] maps each window variant to its group;
    ``thr_scaled`` is [W, n_apps]. Returns the bins of
    ``first_bin_ge_scaled(gcum[group], thr_scaled, gather=True)`` without
    materialising the [W, n_apps, n_bins] gather: each binary-search probe
    reads one [W, n_apps] slice straight out of the group state."""
    n_bins = gcum.shape[-1]
    dev = gcum.device
    thr = _like(thr_scaled, gcum, torch.int32)
    cols = torch.arange(thr.shape[-1], device=dev)[None, :]
    g = _like(group, gcum, torch.int64)[:, None]
    lo = torch.zeros(thr.shape, dtype=torch.int32, device=dev)
    hi = torch.full(thr.shape, n_bins, dtype=torch.int32, device=dev)
    for _ in range(int(np.ceil(np.log2(n_bins + 1)))):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        v = gcum[g, cols, torch.clamp(mid, max=n_bins - 1).long()] \
            .to(torch.int32)
        # repro-lint: ignore[single-source-decision-math] -- the port's single
        # source of this math, held equal to repro/core/policy_math.py by
        # tests/test_torch_core_rest.py
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
# The reference's pre-sweep float32 engine, as XLA compiles it
# --------------------------------------------------------------------------
#
# That engine (engine="reference") traces every knob as a compile-time
# constant, and XLA's CPU compiler then rewrites a division by a constant
# into a product with its float32 reciprocal, reassociates a product of
# constants, and contracts a multiply-subtract into a fused multiply-add.
# The helpers below spell those programs out, so that the port's
# "reference" engine reproduces the reference's float32 numbers bit for bit
# (a CV of exactly 2.0 there computes as 1.9999999). Each float32 operation
# is its own rounded op; the fused multiply-add is computed in float64,
# where the product of two float32 values is exact, and rounded once, so the
# card and the CPU agree.


def _recip32(c) -> np.float32:
    """The float32 reciprocal a constant divisor becomes."""
    return np.float32(1.0) / np.float32(c)


def folded_idle_bins(it, active, bin_minutes, n_bins):
    """:func:`classify_idle_time` with ``it / bin_minutes`` compiled as
    ``it * (1 / bin_minutes)``."""
    return classify_idle_time(it * _like(_recip32(bin_minutes), it), active,
                              1.0, n_bins)


def folded_bin_count_cv(cv_sum, cv_sum_sq, n_bins):
    """:func:`bin_count_cv` (float32) with the divisions by ``n_bins``
    compiled as products with its reciprocal ``r`` and the variance as
    ``fma(sum_sq, r, -(mean * mean))``."""
    f = torch.float32
    r = _recip32(n_bins)
    cvs, cvss = cv_sum.to(f), cv_sum_sq.to(f)
    mean = cvs * _like(r, cvs)
    mm = mean * mean
    # repro-lint: ignore[single-source-decision-math] -- the port's single
    # source of the reference engine's compiled CV, held equal to the
    # reference's engine="reference" by tests/test_torch_reference_engine.py
    var = (cvss.double() * float(r) - mm.double()).to(f)
    var = torch.clamp(var, min=0.0)
    floor = float(np.float32(1e-9))
    return torch.where(mean > 0, _sqrt_rn(var) / torch.clamp(mean, min=floor),
                       0.0)


def folded_window_values(head_bin, tail_bin, bin_minutes: float,
                         range_minutes: float, margin: float):
    """:func:`window_values` with the head's constant product
    reassociated: ``head * (bin * (1 - margin))``."""
    lo, hi = margin_factors(margin)
    bin_f32 = np.float32(bin_minutes)
    f = torch.float32
    head = head_bin.to(f)
    tail = tail_bin.to(f)
    load_at = head * _like(bin_f32 * lo, head)
    unload_at = torch.minimum(tail * _like(bin_f32, tail),
                              _like(np.float32(range_minutes), tail)) \
        * _like(hi, tail)
    return load_at, torch.maximum(unload_at, load_at)


def arima_window(predicted_it: float, margin: float) -> Tuple[float, float]:
    """§4.3: (prewarm, keep_alive) around a forecast idle time — pre-warm
    just before the prediction, keep alive across a 2-margin band."""
    # repro-lint: ignore[single-source-decision-math] -- the port's single
    # source of this math, held equal to repro/core/policy_math.py by
    # tests/test_torch_forecast.py
    return predicted_it * (1.0 - margin), 2.0 * margin * predicted_it


# --------------------------------------------------------------------------
# SPES-style next-idle predictor (the PolicySpec predictor family)
# --------------------------------------------------------------------------


class SpesStepConfig(NamedTuple):
    """One SPES-predictor configuration in the dtypes the decision layer
    consumes. Leaves are host scalars (the scalar policy) or ``[S, 1]``
    tensors broadcast against the app axis (the sweep's config axis)."""
    alpha: object          # f32 — exponential smoothing weight
    om_alpha: object       # f32 — (1 - alpha), rounded once on the host
    band_margin: object    # f32 — relative half-band around the forecast
    band_sigma: object     # f32 — residual-std multiplier widening the band
    min_samples: object    # i32 — observed ITs before the forecast governs
    standard_keep: object  # f32 — fallback keep-alive until warmed up

    @classmethod
    def from_host(cls, *, alpha: float, band_margin: float,
                  band_sigma: float, min_samples: int,
                  standard_keep: float) -> "SpesStepConfig":
        return cls(alpha=np.float32(alpha), om_alpha=np.float32(1.0 - alpha),
                   band_margin=np.float32(band_margin),
                   band_sigma=np.float32(band_sigma),
                   min_samples=np.int32(min_samples),
                   standard_keep=np.float32(standard_keep))


def spes_update(mean, var, n_obs, it32, active, alpha, om_alpha):
    """One exponentially-weighted update of the next-idle forecast state.

    State is ``(mean, var, n_obs)``: the EW mean of the observed idle
    times, the EW variance of the one-step forecast residuals (West's
    update ``var' = (1 - a) * (var + a * err^2)``) and the observation
    count. The carried state is float32, a decision input every engine
    holds identically; the update is computed in float64, one operation
    at a time, and rounded ONCE to float32, so no engine's choice to fuse
    a multiply and an add can move it. The first observation seeds
    ``mean`` with zero variance; ``active`` masks padding and first
    events."""
    first = n_obs == 0
    m, v = _f64(mean), _f64(var)
    err = _f64(it32) - m
    incr = _f64(alpha) * err
    upd_mean = _where(first, _f64(it32), m + incr)
    upd_var = _where(first, np.float64(0.0), _f64(om_alpha) * (v + err * incr))
    new_mean = _f32(_where(active, upd_mean, m))
    new_var = _f32(_where(active, upd_var, v))
    return new_mean, new_var, n_obs + active


def spes_window_from_counts(mean, var, n_obs, min_samples, band_margin,
                            band_sigma, standard_keep):
    """(load_at, unload_at) residency bounds from the forecast state.

    The point forecast of the next idle time is the EW ``mean``; the band
    around it is a relative margin plus ``band_sigma`` residual standard
    deviations. Below ``min_samples`` observations the standard keep-alive
    governs. Computed in float64 from the float32 state and rounded once
    to float32 (as :func:`spes_update`)."""
    m = _f64(mean)
    sd = torch.sqrt(_f64(var)) if _is_t(var) else np.sqrt(_f64(var))
    half = _f64(band_margin) * m + _f64(band_sigma) * sd
    if _is_t(m, half):
        load = torch.clamp(m - half, min=0.0)
        unload = torch.maximum(m + half, load)
    else:
        load = np.maximum(m - half, np.float64(0.0))
        unload = np.maximum(m + half, load)
    ready = n_obs >= _i32(min_samples)
    std_load, std_unload = standard_window_bounds(standard_keep)
    return (_where(ready, _f32(load), std_load),
            _where(ready, _f32(unload), std_unload))


def fused_spes_step_math(t_now, prev_t, mean, var, n_obs, load_at,
                         unload_at, cold, waste, *, cfg: SpesStepConfig):
    """One fused SPES-predictor step over a column of events: the warm/cold
    and waste verdict under the previously decided bounds, the EW
    forecast-state update, and the banded window decision for the next
    gap.

    The clock ``prev_t`` [n] and the observation count ``n_obs`` [n] are
    config-independent; ``mean``/``var`` (float32) and the bounds, cold
    and waste are ``[S, n]`` against ``[S, 1]`` knob leaves. Bounds and
    waste stay in the time dtype (``t_now``'s)."""
    wdtype = t_now.dtype
    valid = torch.isfinite(t_now)
    first = ~torch.isfinite(prev_t)
    it = t_now - prev_t

    # Verdict for the gap that just closed.
    is_cold = valid & (first | ~warm_from_bounds(it, load_at, unload_at))
    gap_waste = torch.where(valid & ~first,
                            idle_from_bounds(it, load_at, unload_at), 0.0)

    # Forecast-state update (float32 decision layer).
    rec = valid & ~first
    mean, var, n_obs = spes_update(mean, var, n_obs, it.to(torch.float32),
                                   rec, cfg.alpha, cfg.om_alpha)
    new_load, new_unload = spes_window_from_counts(
        mean, var, n_obs, cfg.min_samples, cfg.band_margin, cfg.band_sigma,
        cfg.standard_keep)

    # Windows decided now govern the next gap of apps that saw an event.
    load_at = torch.where(valid, new_load.to(wdtype), load_at)
    unload_at = torch.where(valid, new_unload.to(wdtype), unload_at)
    prev_t = torch.where(valid, t_now, prev_t)
    return (prev_t, mean, var, n_obs, load_at, unload_at,
            cold + is_cold.to(cold.dtype), waste + gap_waste)


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


# --------------------------------------------------------------------------
# The sweep step: S configurations over one trace column, factored
# --------------------------------------------------------------------------


class HybridSweepBlock(NamedTuple):
    """A whole hybrid-policy grid, factored into its distinct layers (the
    reference's block, leaf for leaf: the same names, shapes and dtypes).

      * group layer ``[G, ...]`` — distinct (bin_minutes, n_bins): the
        histogram state (cumulative counts, OOB count, Welford sums) is
        carried and updated once per group;
      * window layer ``[W, ...]`` — distinct (group, percentiles, margin,
        range): the percentile searches and window values once per variant;
      * gate layer ``[T, ...]`` — distinct (group, min_samples,
        cv_threshold, oob_threshold): the gate once per variant;
      * standard-keep layer ``[D, 1]`` — the fallback windows;
      * config layer ``[S]`` — every config only selects its (window, gate,
        standard-keep) rows; its own state is the carried bounds, the cold
        count and the waste.

    Index leaves are int32 ``[layer]`` tensors; knob leaves are ``[layer,
    1]`` tensors (so they broadcast against ``[layer, n_apps]`` state) in
    the dtypes of :class:`HybridStepConfig`."""
    # group layer
    g_bin_minutes: object   # [G, 1] time dtype
    g_n_bins: object        # [G, 1] i32 (effective bins; allocation is max)
    # window-variant layer
    w_group: object         # [W] i32 — variant -> group row
    w_head_numer: object    # [W, 1] i32
    w_tail_numer: object    # [W, 1] i32
    w_bin_f32: object       # [W, 1] f32
    w_range_f32: object     # [W, 1] f32
    w_margin_lo: object     # [W, 1] f32
    w_margin_hi: object     # [W, 1] f32
    # gate-variant layer
    t_group: object         # [T] i32 — variant -> group row
    t_min_samples: object   # [T, 1] i32
    t_cv_threshold: object  # [T, 1] f32
    t_oob_threshold: object  # [T, 1] f32
    # standard-keep layer (fallback windows, one per distinct keep-alive)
    d_standard_keep: object  # [D, 1] f32
    # config layer
    c_window: object        # [S] i32 — config -> window variant
    c_gate: object          # [S] i32 — config -> gate variant
    c_std: object           # [S] i32 — config -> standard-keep row


class SweepIdentities(NamedTuple):
    """Host-side structure flags of a :class:`HybridSweepBlock`: each says
    that a selector is the identity map, so the layers skip that gather.
    For a single config every selector is the identity. Results are the
    same either way."""
    w: bool = False        # window variant w reads group w
    t: bool = False        # gate variant t reads group t
    c_window: bool = False  # config s uses window variant s
    c_gate: bool = False   # config s uses gate variant s
    c_std: bool = False    # config s uses standard-keep row s


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` of ``x`` (a gather along the layer axis)."""
    return x.index_select(0, idx)


def _sweep_decision_layers(gcum, goob, gcv_sum, gcv_sum_sq,
                           blk: HybridSweepBlock, ids: SweepIdentities):
    """The shared decision layers from the current group state: the
    window variants' float32 bounds ``(w_load, w_unload)`` ``[W, n]`` and
    the per-config gate verdict ``use_c`` ``[S, n]`` (percentile searches
    once per window variant, the CV once per group, the gate once per gate
    variant, then a gather per config unless ``ids`` proves it the
    identity)."""
    gtotal = gcum[..., -1].to(torch.int32)
    total_w = gtotal if ids.w else _take(gtotal, blk.w_group)
    head_thr = percentile_threshold_scaled_numer(total_w, blk.w_head_numer)
    tail_thr = percentile_threshold_scaled_numer(total_w, blk.w_tail_numer)
    if ids.w:
        head_bin = first_bin_ge_scaled(gcum, head_thr, gather=True)
        tail_bin = first_bin_ge_scaled(gcum, tail_thr, gather=True) + 1
    else:
        head_bin = first_bin_ge_scaled_grouped(gcum, blk.w_group, head_thr)
        tail_bin = first_bin_ge_scaled_grouped(gcum, blk.w_group,
                                               tail_thr) + 1
    w_load, w_unload = window_values_from_factors(
        head_bin, tail_bin, blk.w_bin_f32, blk.w_range_f32, blk.w_margin_lo,
        blk.w_margin_hi)

    gcv = bin_count_cv(gcv_sum, gcv_sum_sq, blk.g_n_bins, np.float32)
    sel_t = (lambda x: x) if ids.t else (lambda x: _take(x, blk.t_group))
    use_hist = use_histogram_gate_from_cv(
        sel_t(gtotal), sel_t(goob), sel_t(gcv),
        blk.t_min_samples, blk.t_cv_threshold, blk.t_oob_threshold)
    return w_load, w_unload, (use_hist if ids.c_gate
                              else _take(use_hist, blk.c_gate))


def hybrid_sweep_decide(gcum, goob, gcv_sum, gcv_sum_sq,
                        blk: HybridSweepBlock,
                        ids: SweepIdentities = SweepIdentities()):
    """Per-config residency bounds from the current group state: float32
    ``(load_at, unload_at)``, each ``[S, n_apps]``. The decision inputs
    change only at an app's events, so the bounds an app carries between
    events equal a fresh decide from the same state."""
    w_load, w_unload, use_c = _sweep_decision_layers(
        gcum, goob, gcv_sum, gcv_sum_sq, blk, ids)
    std_load, std_unload = standard_window_bounds(
        blk.d_standard_keep if ids.c_std
        else _take(blk.d_standard_keep, blk.c_std))
    load_c = torch.where(use_c, w_load if ids.c_window
                         else _take(w_load, blk.c_window),
                         _like(std_load, w_load))
    unload_c = torch.where(use_c, w_unload if ids.c_window
                           else _take(w_unload, blk.c_window), std_unload)
    return load_c, unload_c


def fused_hybrid_sweep_step_math(t_now, prev_t, gcum, goob, gcv_sum,
                                 gcv_sum_sq, load_c, unload_c, cold,
                                 waste, *, blk: HybridSweepBlock,
                                 ids: SweepIdentities = SweepIdentities()):
    """One sweep step: S configurations advance together over one trace
    column, sharing the time layer and the per-group histogram update.

    Shapes: ``t_now``/``prev_t`` ``[n]`` (the clock is shared by the whole
    grid); group state ``gcum`` ``[G, n, n_bins]`` int32 (updated IN
    PLACE and returned second, as in :func:`fused_hybrid_step_math`),
    ``goob`` int32 and the Welford sums ``[G, n]``; per-config state
    ``[S, n]``: the carried bounds ``(load_c, unload_c)`` in the time
    dtype, ``cold`` int32 and ``waste``. The step verdicts the closing gap
    under the carried bounds, updates the group state, then re-decides
    from the post-update state (:func:`hybrid_sweep_decide`); apps without
    an event keep their bounds. The initial carry must be decide(zero
    state) = ``(0, standard_keep)``. Every value a config sees is the
    primitive sequence the single-config step computes — the layers only
    deduplicate and gather — so sweep rows equal single-config runs bit
    for bit."""
    wdtype = t_now.dtype
    valid = torch.isfinite(t_now)        # [n] — shared across the grid
    first = ~torch.isfinite(prev_t)
    it = t_now - prev_t
    account = valid & ~first             # gaps that actually closed

    # Verdict for the gap that just closed, under the carried windows.
    is_cold = valid & (first | ~warm_from_bounds(it, load_c, unload_c))
    gap_waste = torch.where(account, idle_from_bounds(it, load_c, unload_c),
                            0.0)

    # Group layer: one histogram + CV update per distinct histogram shape.
    safe, in_b, oob_hit = classify_idle_time(it, account, blk.g_bin_minutes,
                                             blk.g_n_bins)
    old = raw_count_at(gcum, safe, gather=True)
    suffix_add_(gcum, safe, in_b)
    goob = goob + oob_hit.to(torch.int32)
    gcv_sum, gcv_sum_sq = welford_update(gcv_sum, gcv_sum_sq, in_b, old)

    # Windows governing the next gap, from the post-update state.
    new_load, new_unload = hybrid_sweep_decide(gcum, goob, gcv_sum,
                                               gcv_sum_sq, blk, ids)
    load_c = torch.where(valid, new_load.to(wdtype), load_c)
    unload_c = torch.where(valid, new_unload.to(wdtype), unload_c)
    prev_t = torch.where(valid, t_now, prev_t)
    return (prev_t, gcum, goob, gcv_sum, gcv_sum_sq, load_c, unload_c,
            cold + is_cold.to(cold.dtype), waste + gap_waste)
