"""Declarative workload scenarios: ``WorkloadSpec`` -> one vectorized engine.

A numpy copy of ``repro/core/workload_spec.py`` without the JAX pytree
registration: the same spec gives the same padded arrays, bit for bit
(``tests/test_torch_workload.py`` holds the two equal). A
:class:`WorkloadSpec` is a frozen dataclass of :class:`Cohort` population
components (the paper's §3 rate, pattern and trigger distributions) plus
modulation knobs (diurnal amplitude, weekend dip, flash crowd);
``materialize()`` samples it into a :class:`~repro_torch.core.workload.Trace`.

Generation is seed-deterministic and chunk-size-invariant: apps are
generated in fixed index blocks, each with an independent counter-style RNG
keyed on ``(seed, block_start, cohort)``. ``max_events`` caps the per-app
event budget (apps above it are rate-capped by stretching their periods);
pattern-mode events are capped at one per minute-bin, the released
dataset's granularity.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import workload as _wl
from .workload import MINUTES_PER_DAY, PATTERNS, AppSpec, Trace

__all__ = [
    "Cohort", "WorkloadSpec", "SCENARIOS", "scenario", "azure_like",
    "diurnal", "bursty", "timer_heavy", "flash_crowd", "weekend_dip",
    "materialize_loop", "population_columns",
]

GENERATORS = ("patterns", "uniform")

# Pattern indices (into workload.PATTERNS): timers are wall-clock and are
# never modulated; poisson/bursty traffic is human/event driven and gets the
# diurnal/weekly/flash intensity warp (matching the legacy generator, which
# thinned exactly these two classes).
_PERIODIC, _MULTI_TIMER, _REGULAR, _POISSON, _BURSTY = range(5)
_WARPED = (_POISSON, _BURSTY)

_PATTERN_MATRIX = np.asarray([_wl._PATTERN_PROBS_LOW, _wl._PATTERN_PROBS_MID,
                              _wl._PATTERN_PROBS_HIGH], np.float64)

# Fixed generation-block sizing: blocks are a pure memory knob (frame is
# ~[block, max_events] floats); the block GRID is aligned to absolute app
# indices so materialization batching can never change the trace.
_EVENT_BUDGET = 1 << 21
_MIN_BLOCK, _MAX_BLOCK = 256, 32768
# Domain-separation tag for the per-block counter RNG.
_RNG_TAG = 0x57F1


def _block_size(max_ev: int) -> int:
    return int(np.clip(_EVENT_BUDGET // max_ev, _MIN_BLOCK, _MAX_BLOCK))


@dataclasses.dataclass(frozen=True)
class Cohort:
    """One population component: a rate-band/pattern/trigger slice of the
    fleet, sampled from the paper's §3 distributions (optionally truncated
    or re-weighted).

    ``pattern_probs=None`` uses the paper's rate-conditioned pattern mix
    (low-rate apps are mostly bursty HTTP, high-rate apps are machine
    traffic — Sections 3.2-3.3); ``trigger_probs=None`` uses the Fig. 3(b)
    trigger-combination shares. Rates come from the Fig. 5(a) CDF restricted
    to ``[10**rate_log10_min, 10**rate_log10_max]`` invocations/day and
    scaled by ``rate_scale``; memory/exec-time/function-count marginals are
    always the paper's fits (Burr XII / lognormal / Fig. 1 CDF).
    """
    name: str = "azure"
    weight: float = 1.0
    rate_log10_min: float = -1.0
    rate_log10_max: float = 7.0
    rate_scale: float = 1.0
    pattern_probs: Optional[Tuple[float, ...]] = None
    trigger_probs: Optional[Tuple[float, ...]] = None


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """A declarative workload scenario: population mix + modulation knobs.

    ``materialize()`` runs the vectorized engine (see module docstring);
    ``run()``/``sweep()`` in :mod:`repro_torch.core.experiment` accept a spec
    anywhere a :class:`~repro_torch.core.workload.Trace` is accepted, and
    ``sweep(traces=[...], specs=[...])`` makes scenarios a sweep axis.

    ``max_events=None`` means "uncapped": the budget falls back to the
    minute-bin bound (one event per minute of the window) — the right
    setting for eager/cluster-sim traces; fleet-scale padded traces should
    keep an explicit cap (64-256) to bound device memory.
    """
    n_apps: int = 1000
    days: float = 7.0
    seed: int = 0
    cohorts: Tuple[Cohort, ...] = (Cohort(),)
    max_events: Optional[int] = 64
    min_events: int = 0             # 1 => every app has >= 1 invocation
    diurnal_amplitude: float = 0.45  # Fig. 4: ~55% baseline + day cycle
    weekend_factor: float = 1.0      # intensity multiplier on days 5-6
    flash_start: Optional[float] = None   # flash-crowd window start (min)
    flash_duration: float = 120.0
    flash_factor: float = 1.0
    generator: str = "patterns"      # "patterns" | "uniform" (legacy)
    label: Optional[str] = None

    # -- identity ------------------------------------------------------------

    @property
    def name(self) -> str:
        return self.label or (f"{self.generator}-{self.n_apps}apps-"
                              f"{self.days:g}d-seed{self.seed}")

    @property
    def duration_minutes(self) -> float:
        return self.days * MINUTES_PER_DAY

    # -- constructors --------------------------------------------------------

    @classmethod
    def mix(cls, cohorts: Sequence[Cohort], **kw) -> "WorkloadSpec":
        """Compose population components into one scenario. Cohort weights
        are relative; apps are allocated by largest remainder, so the
        realized split is exact to +-1 app."""
        return cls(cohorts=tuple(cohorts), **kw)

    @classmethod
    def uniform(cls, n_apps: int, days: float = 1.0, seed: int = 0,
                max_events: int = 64, min_events: int = 0,
                label: Optional[str] = None) -> "WorkloadSpec":
        """The legacy scaling workload (formerly ``Trace.synthesize``):
        Fig. 5(a) rates, Poisson event counts, sorted-uniform times, float32,
        no patterns or modulation. Kept for throughput benchmarking
        continuity; prefer :func:`azure_like` for anything that should look
        like §3."""
        return cls(n_apps=n_apps, days=days, seed=seed, max_events=max_events,
                   min_events=min_events, diurnal_amplitude=0.0,
                   generator="uniform",
                   label=label or f"uniform-{n_apps}apps-{days:g}d")

    # -- validation ----------------------------------------------------------

    def validate(self) -> None:
        if self.n_apps < 0:
            raise ValueError(f"n_apps must be >= 0, got {self.n_apps}")
        if not self.days > 0:
            raise ValueError(f"days must be > 0, got {self.days}")
        if self.seed < 0:
            raise ValueError(f"seed must be >= 0, got {self.seed}")
        if self.max_events is not None and self.max_events < 1:
            raise ValueError(f"max_events must be >= 1, got {self.max_events}")
        if self.min_events not in (0, 1):
            raise ValueError(f"min_events must be 0 or 1, got {self.min_events}")
        if self.generator not in GENERATORS:
            raise ValueError(f"unknown generator {self.generator!r}; expected "
                             f"one of {GENERATORS}")
        if not self.cohorts:
            raise ValueError("a WorkloadSpec needs at least one Cohort")
        if not 0.0 <= self.diurnal_amplitude <= 1.0:
            raise ValueError("diurnal_amplitude must be in [0, 1], got "
                             f"{self.diurnal_amplitude}")
        if not self.weekend_factor > 0 or not self.flash_factor > 0:
            raise ValueError("weekend_factor/flash_factor must be > 0")
        for c in self.cohorts:
            if not c.weight > 0:
                raise ValueError(f"cohort {c.name!r}: weight must be > 0")
            if not c.rate_log10_min < c.rate_log10_max:
                raise ValueError(f"cohort {c.name!r}: empty rate band")
            for probs, m in ((c.pattern_probs, len(PATTERNS)),
                             (c.trigger_probs, len(_wl._TRIGGER_COMBOS))):
                if probs is not None and (len(probs) != m
                                          or min(probs) < 0
                                          or sum(probs) <= 0):
                    raise ValueError(
                        f"cohort {c.name!r}: probability vector must have "
                        f"{m} non-negative entries with positive sum")

    # -- the engine ----------------------------------------------------------

    def materialize(self, eager: bool = False) -> Trace:
        """Generate the trace. ``eager=False`` (default) returns the padded
        fleet-scale form; ``eager=True`` also builds per-app ``AppSpec``
        objects and float64 time lists (cluster sim / dataset export)."""
        return _materialize(self, eager)


# ---------------------------------------------------------------------------
# Population sampling (vectorized §3-anchored samplers)
# ---------------------------------------------------------------------------


def _sample_rates_banded(rng, n: int, cohort: Cohort) -> np.ndarray:
    """Fig. 5(a) inverse-CDF sampling restricted to the cohort's band."""
    anchors = _wl._RATE_CDF
    u_lo = float(np.interp(cohort.rate_log10_min, anchors[:, 1], anchors[:, 0]))
    u_hi = float(np.interp(cohort.rate_log10_max, anchors[:, 1], anchors[:, 0]))
    u = rng.uniform(u_lo, u_hi, n)
    return 10.0 ** np.interp(u, anchors[:, 0], anchors[:, 1]) * cohort.rate_scale


def _sample_patterns(rng, rates: np.ndarray, cohort: Cohort) -> np.ndarray:
    n = len(rates)
    if cohort.pattern_probs is not None:
        p = np.asarray(cohort.pattern_probs, np.float64)
        cdf = np.broadcast_to(np.cumsum(p / p.sum()), (n, len(PATTERNS)))
    else:
        cls = np.digitize(rates, (24.0, MINUTES_PER_DAY), right=True)
        cdf = np.cumsum(_PATTERN_MATRIX, axis=1)[cls]
    u = rng.uniform(0.0, 1.0, n)
    return np.sum(u[:, None] > cdf[:, :-1], axis=1).astype(np.int32)


def _snap_timer_rates(rates: np.ndarray, pattern: np.ndarray) -> np.ndarray:
    """Timer apps fire at most 1/minute on round periods (Sec. 3.2)."""
    timer = pattern <= _MULTI_TIMER
    if not timer.any():
        return rates
    r = np.minimum(rates, MINUTES_PER_DAY)
    raw = MINUTES_PER_DAY / np.maximum(r, 1e-9)
    logp = np.log(_wl._ROUND_PERIODS)
    j = np.argmin(np.abs(logp[None, :] - np.log(raw)[:, None]), axis=1)
    return np.where(timer, MINUTES_PER_DAY / _wl._ROUND_PERIODS[j], rates)


def _sample_triggers(rng, n: int, cohort: Cohort) -> np.ndarray:
    p = np.asarray(cohort.trigger_probs if cohort.trigger_probs is not None
                   else _wl._TRIGGER_PROBS, np.float64)
    return rng.choice(len(_wl._TRIGGER_COMBOS), n, p=p / p.sum())


def _sample_population(rng, n: int, cohort: Cohort) -> Dict[str, np.ndarray]:
    """One cohort block's population arrays — no per-app objects."""
    rates = _sample_rates_banded(rng, n, cohort)
    pattern = _sample_patterns(rng, rates, cohort)
    rates = _snap_timer_rates(rates, pattern)
    period = np.maximum(MINUTES_PER_DAY / np.maximum(rates, 1e-9), 1.0)
    return dict(
        rates=rates, pattern=pattern, period=period,
        memory=_wl._sample_memory_mb(rng, n),
        execs=_wl._sample_exec_s(rng, n),
        nfunc=_wl._sample_n_functions(rng, n),
        trig=_sample_triggers(rng, n, cohort),
    )


# ---------------------------------------------------------------------------
# Modulation: inhomogeneous intensity via an inverse-CDF time warp
# ---------------------------------------------------------------------------


def _build_warp(spec: WorkloadSpec, duration: float):
    """Cumulative-intensity warp grid, or None when intensity is flat.

    Non-timer events are generated in operational (flat-intensity) time and
    mapped through the inverse cumulative intensity — the exact inverse
    transform for (conditioned) Poisson arrivals, and the standard
    time-change for renewal streams. Event counts are preserved (unlike the
    legacy thinning, which silently cut rates by the mean acceptance)."""
    flat = (spec.diurnal_amplitude == 0.0 and spec.weekend_factor == 1.0
            and (spec.flash_start is None or spec.flash_factor == 1.0))
    if flat:
        return None
    grid_t = np.linspace(0.0, duration, max(int(np.ceil(duration)) + 1, 2))
    a = spec.diurnal_amplitude
    phase = 2.0 * np.pi * (grid_t % MINUTES_PER_DAY) / MINUTES_PER_DAY
    intensity = (1.0 - a) + a * 0.5 * (1.0 + np.sin(phase - 0.5 * np.pi))
    if spec.weekend_factor != 1.0:
        day = (grid_t // MINUTES_PER_DAY).astype(np.int64) % 7
        intensity = intensity * np.where(day >= 5, spec.weekend_factor, 1.0)
    if spec.flash_start is not None and spec.flash_factor != 1.0:
        hot = ((grid_t >= spec.flash_start)
               & (grid_t < spec.flash_start + spec.flash_duration))
        intensity = intensity * np.where(hot, spec.flash_factor, 1.0)
    intensity = np.maximum(intensity, 1e-3)
    cum = np.concatenate([[0.0],
                          np.cumsum(0.5 * (intensity[1:] + intensity[:-1]))])
    return cum / cum[-1], grid_t


def _warp_rows(frame: np.ndarray, rows: np.ndarray, duration: float, warp):
    if warp is None or not len(rows):
        return
    cnorm, grid_t = warp
    sub = frame[rows]
    finite = np.isfinite(sub)
    x = np.clip(np.where(finite, sub, 0.0) / duration, 0.0, 1.0)
    frame[rows] = np.where(finite, np.interp(x, cnorm, grid_t), np.inf)


# ---------------------------------------------------------------------------
# Vectorized per-pattern event generation (one block)
# ---------------------------------------------------------------------------


def _minute_cap(frame: np.ndarray) -> None:
    """Greedy one-event-per-minute-bin cap, vectorized over apps.

    Column scan over the (sorted, +inf-padded) frame: an event survives iff
    it is >= 1 minute after the previously surviving one — the dataset's
    1-minute binning (see :mod:`repro_torch.core.workload`). Dropped events become
    +inf; rows are re-sorted (compacted) in place."""
    w = frame.shape[1]
    if w <= 1:
        return
    last = frame[:, 0].copy()
    for j in range(1, w):
        col = frame[:, j]
        keep = col >= last + 1.0          # inf rides through without NaNs
        frame[:, j] = np.where(keep, col, np.inf)
        last = np.where(keep, col, last)
    frame.sort(axis=1)


def _gen_patterns_block(rng, pop: Dict[str, np.ndarray], duration: float,
                        max_ev: int, warp, min_events: int):
    """Events for one block, every pattern vectorized over its group.

    Returns (frame [m, max_ev] float64 sorted +inf-padded, counts [m]).
    Expected counts above ``max_ev`` are rate-capped by period stretching so
    the pattern shape survives the event budget. RNG draw order is fixed
    (pattern groups in PATTERNS order, then the min_events fill) — the
    determinism tests pin it.
    """
    m = len(pop["rates"])
    days = duration / MINUTES_PER_DAY
    frame = np.full((m, max_ev), np.inf, np.float64)
    pattern, period = pop["pattern"], pop["period"]
    warp_rows = np.zeros(m, bool)

    for pid in range(len(PATTERNS)):
        idx = np.where(pattern == pid)[0]
        g = len(idx)
        if not g:
            continue
        per = period[idx]
        if pid == _PERIODIC:
            stretch = np.maximum(np.ceil((duration / per + 1.0) / max_ev), 1.0)
            per = per * stretch
            phase = rng.uniform(0.0, per)
            t = phase[:, None] + np.arange(max_ev)[None, :] * per[:, None]
            t[t >= duration] = np.inf
            frame[idx] = t
        elif pid == _MULTI_TIMER:
            per1 = 2.0 * per
            per2 = per1 * rng.uniform(1.2, 3.0, g)
            half = max_ev // 2 + 1
            # EACH timer owns `half` slots, so the stretch must fit the
            # FASTER timer's own count into its slot budget — guarding only
            # the combined estimate lets an asymmetric fast timer overrun
            # its half and silently go dark for the tail of the window.
            need = np.maximum(duration / per1, duration / per2) + 1.0
            stretch = np.maximum(np.ceil(need / half), 1.0)
            per1, per2 = per1 * stretch, per2 * stretch
            j = np.arange(half)[None, :]
            t = np.concatenate(
                [rng.uniform(0.0, per1)[:, None] + j * per1[:, None],
                 rng.uniform(0.0, per2)[:, None] + j * per2[:, None]], axis=1)
            t[t >= duration] = np.inf
            t.sort(axis=1)
            frame[idx] = t[:, :max_ev]
        elif pid == _REGULAR:
            # Erlang-4 IATs: CV = 0.5 machine traffic with jitter (Fig. 6)
            per = np.maximum(per, duration / max_ev)
            width = min(max_ev,
                        int(np.ceil(duration / per.min() * 1.5)) + 8)
            iats = rng.gamma(4.0, 1.0, (g, width)) * (per[:, None] / 4.0)
            t = np.cumsum(iats, axis=1)
            t[t >= duration] = np.inf
            frame[idx, :width] = t
        elif pid == _POISSON:
            lam = np.minimum(pop["rates"][idx] * days, float(max_ev))
            cnt = np.minimum(rng.poisson(lam), max_ev).astype(np.int64)
            width = max(int(cnt.max()), 1)
            t = rng.uniform(0.0, duration, (g, width))
            t[np.arange(width)[None, :] >= cnt[:, None]] = np.inf
            t.sort(axis=1)
            frame[idx, :width] = t
            warp_rows[idx] = True
        else:  # _BURSTY
            # Hyperexponential IAT mixture: runs of ~burst_mean closely
            # spaced calls separated by long gaps — CV >> 1 (Fig. 6) and the
            # ~1-cold-start-per-burst profile the paper observes. The gap
            # mean solves the mixture for the app's average rate.
            per = np.maximum(per, duration / max_ev)
            burst_mean = rng.uniform(6.0, 30.0, g)
            intra = rng.uniform(0.8, 2.5, g)
            dense = per <= 2.0            # continuous traffic: no bursts
            p_intra = np.where(dense, 0.0, 1.0 - 1.0 / burst_mean)
            gap = np.where(
                dense, per,
                (per - p_intra * intra) / np.maximum(1.0 - p_intra, 1e-9))
            gap = np.maximum(gap, per)
            width = min(max_ev, int(np.ceil(duration / per.min() * 1.6)) + 16)
            short = rng.uniform(0.0, 1.0, (g, width)) < p_intra[:, None]
            iats = (rng.exponential(1.0, (g, width))
                    * np.where(short, intra[:, None], gap[:, None]))
            t = (rng.uniform(0.0, gap)[:, None]
                 + np.cumsum(iats, axis=1) - iats[:, :1])
            t[t >= duration] = np.inf
            frame[idx, :width] = t
            warp_rows[idx] = True

    _warp_rows(frame, np.where(warp_rows)[0], duration, warp)
    _minute_cap(frame)
    counts = np.isfinite(frame).sum(axis=1).astype(np.int32)
    if min_events > 0:
        empty = np.where(counts == 0)[0]
        if len(empty):
            frame[empty, 0] = rng.uniform(0.0, duration, len(empty))
            counts[empty] = 1
    return frame, counts


def _gen_uniform_block(rng, m: int, duration: float, max_ev: int,
                       min_events: int, cohort: Cohort):
    """Legacy scaling workload: Poisson counts, sorted-uniform float32 times
    (the pre-spec scaling-trace semantics, minus the >=1 clamp)."""
    days = duration / MINUTES_PER_DAY
    rates = _sample_rates_banded(rng, m, cohort)
    lam = np.minimum(rates * days, float(max_ev))
    cnt = np.clip(rng.poisson(lam), min_events, max_ev).astype(np.int32)
    t = rng.uniform(0.0, duration, (m, max_ev)).astype(np.float32)
    t[np.arange(max_ev)[None, :] >= cnt[:, None]] = np.inf
    t.sort(axis=1)
    return t, cnt


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------


def _cohort_segments(n_apps: int, cohorts: Sequence[Cohort]):
    """Largest-remainder allocation of contiguous app-index segments."""
    w = np.asarray([c.weight for c in cohorts], np.float64)
    share = w / w.sum() * n_apps
    alloc = np.floor(share).astype(np.int64)
    for k in np.argsort(-(share - alloc))[: n_apps - int(alloc.sum())]:
        alloc[k] += 1
    segs, lo = [], 0
    for ci, cnt in enumerate(alloc):
        if cnt:
            segs.append((ci, lo, lo + int(cnt)))
        lo += int(cnt)
    return segs


def _block_rng(seed: int, block_lo: int, cohort_idx: int):
    return np.random.default_rng([_RNG_TAG, seed, block_lo, cohort_idx])


def _resolved_max_events(spec: WorkloadSpec, duration: float) -> int:
    if spec.max_events is not None:
        return int(spec.max_events)
    # uncapped: the minute-bin bound (at most one event per minute)
    return int(np.ceil(duration)) + 1


def _gen_blocks(spec: WorkloadSpec, duration: float):
    """Yield ``(cohort_idx, lo, hi, rng)`` for every generation block.

    The block boundaries (cohort segments, absolute-index alignment) and the
    counter RNG per block are what make generation chunk-size-invariant.
    """
    block = _block_size(_resolved_max_events(spec, duration))
    for ci, s_lo, s_hi in _cohort_segments(spec.n_apps, spec.cohorts):
        for blo in range((s_lo // block) * block, s_hi, block):
            lo, hi = max(blo, s_lo), min(blo + block, s_hi)
            if hi <= lo:
                continue
            yield ci, lo, hi, _block_rng(spec.seed, blo, ci)


def population_columns(spec: WorkloadSpec) -> Dict[str, np.ndarray]:
    """Per-app population columns of a ``'patterns'`` spec, without
    generating any events: the :func:`_sample_population` columns
    (``rates``, ``pattern``, ``period``, ``memory``, ``execs``, ``nfunc``,
    ``trig``) over the whole fleet. Each block draws its population before
    its events from the block's counter RNG, so replaying only that draw
    gives the values an eager ``materialize(eager=True)`` writes into its
    ``AppSpec`` objects (the cluster ``AppTable`` reads them from here)."""
    spec.validate()
    if spec.generator != "patterns":
        raise ValueError(
            "population_columns needs a 'patterns' spec (the 'uniform' "
            "generator draws no population; pass exec/memory columns to "
            "AppTable explicitly for uniform traces)")
    n = spec.n_apps
    out: Dict[str, np.ndarray] = {}
    for ci, lo, hi, rng in _gen_blocks(spec, spec.duration_minutes):
        pop = _sample_population(rng, hi - lo, spec.cohorts[ci])
        if not out:
            out = {k: np.empty(n, v.dtype) for k, v in pop.items()}
        for k, v in pop.items():
            out[k][lo:hi] = v
    return out


def _materialize(spec: WorkloadSpec, eager: bool) -> Trace:
    spec.validate()
    if eager and spec.generator == "uniform":
        raise ValueError(
            "generator='uniform' traces are padded-only (no patterns or "
            "AppSpecs to materialize); use a 'patterns' scenario such as "
            "azure_like() for eager traces")
    duration = spec.duration_minutes
    max_ev = _resolved_max_events(spec, duration)
    n = spec.n_apps
    warp = _build_warp(spec, duration) if spec.generator == "patterns" else None

    if eager:
        times: List[np.ndarray] = [None] * n
        specs: List[AppSpec] = [None] * n
    else:
        dtype = np.float32
        padded = np.full((n, max_ev), np.inf, dtype)
        counts_all = np.empty(n, np.int32)

    for ci, lo, hi, rng in _gen_blocks(spec, duration):
        cohort = spec.cohorts[ci]
        m = hi - lo
        if spec.generator == "uniform":
            frame, cnt = _gen_uniform_block(rng, m, duration, max_ev,
                                            spec.min_events, cohort)
            pop = None
        else:
            pop = _sample_population(rng, m, cohort)
            frame, cnt = _gen_patterns_block(rng, pop, duration, max_ev,
                                             warp, spec.min_events)
        if eager:
            for i in range(m):
                times[lo + i] = frame[i, : cnt[i]].astype(np.float64)
                specs[lo + i] = AppSpec(
                    app_id=f"app-{lo + i:06d}",
                    pattern=PATTERNS[int(pop["pattern"][i])],
                    rate_per_day=float(pop["rates"][i]),
                    period_minutes=float(pop["period"][i]),
                    exec_time_s=float(pop["execs"][i]),
                    memory_mb=float(pop["memory"][i]),
                    n_functions=int(pop["nfunc"][i]),
                    triggers=_wl._TRIGGER_COMBOS[int(pop["trig"][i])])
        else:
            padded[lo:hi, : frame.shape[1]] = frame.astype(dtype)
            counts_all[lo:hi] = cnt

    if eager:
        return Trace(specs=specs, times=times, duration_minutes=duration)
    width = max(int(counts_all.max()), 1) if n else 1
    return Trace(specs=None, times=None, duration_minutes=duration,
                 _padded=(np.ascontiguousarray(padded[:, :width]), counts_all))


def materialize_loop(spec: WorkloadSpec) -> Trace:
    """The pre-spec architecture: one Python iteration per app (per-app
    sampling, per-app pattern generators from :mod:`repro_torch.core.
    workload`, per-event minute cap). The baseline of the vectorised
    materialiser and a distributional cross-check of it — not a production
    path. Implements the default (azure-like) diurnal modulation only;
    scenario warp knobs are engine-only."""
    spec.validate()
    if spec.generator != "patterns":
        raise ValueError("materialize_loop only implements the 'patterns' "
                         "generator (the uniform path was never per-app)")
    duration = spec.duration_minutes
    max_ev = _resolved_max_events(spec, duration)
    n = spec.n_apps
    rng = np.random.default_rng([_RNG_TAG, spec.seed])
    padded = np.full((n, max_ev), np.inf, np.float32)
    counts = np.zeros(n, np.int32)
    for ci, s_lo, s_hi in _cohort_segments(n, spec.cohorts):
        cohort = spec.cohorts[ci]
        for i in range(s_lo, s_hi):
            pop = _sample_population(rng, 1, cohort)
            period = float(max(pop["period"][0], duration / max_ev))
            app = AppSpec(
                app_id=f"app-{i:06d}", pattern=PATTERNS[int(pop["pattern"][0])],
                rate_per_day=MINUTES_PER_DAY / period, period_minutes=period,
                exec_time_s=float(pop["execs"][0]),
                memory_mb=float(pop["memory"][0]),
                n_functions=int(pop["nfunc"][0]),
                triggers=_wl._TRIGGER_COMBOS[int(pop["trig"][0])])
            t = _wl.generate_invocations(app, duration, rng)[:max_ev]
            if len(t) == 0 and spec.min_events > 0:
                t = np.asarray([rng.uniform(0.0, duration)])
            padded[i, : len(t)] = t
            counts[i] = len(t)
    width = max(int(counts.max()), 1) if n else 1
    return Trace(specs=None, times=None, duration_minutes=duration,
                 _padded=(np.ascontiguousarray(padded[:, :width]), counts))


# ---------------------------------------------------------------------------
# Scenario library
# ---------------------------------------------------------------------------


def azure_like(n_apps: int = 100_000, days: float = 7.0, seed: int = 0,
               **kw) -> WorkloadSpec:
    """The paper's §3 fleet: full rate CDF, rate-conditioned pattern mix,
    Fig. 3(b) triggers, Fig. 4 diurnal cycle."""
    kw.setdefault("label", f"azure-like-{n_apps}")
    return WorkloadSpec(n_apps=n_apps, days=days, seed=seed, **kw)


def diurnal(n_apps: int = 100_000, days: float = 7.0, seed: int = 0,
            **kw) -> WorkloadSpec:
    """Strongly day-cycled human traffic (deep overnight trough)."""
    kw.setdefault("label", f"diurnal-{n_apps}")
    kw.setdefault("diurnal_amplitude", 0.9)
    kw.setdefault("cohorts", (Cohort(
        name="diurnal-http", pattern_probs=(0.05, 0.03, 0.07, 0.35, 0.50)),))
    return WorkloadSpec(n_apps=n_apps, days=days, seed=seed, **kw)


def bursty(n_apps: int = 100_000, days: float = 7.0, seed: int = 0,
           **kw) -> WorkloadSpec:
    """CV >> 1 dominated: the hardest regime for fixed keep-alives (every
    burst head is a cold start unless the histogram learns the gaps)."""
    kw.setdefault("label", f"bursty-{n_apps}")
    kw.setdefault("cohorts", (Cohort(
        name="bursty", pattern_probs=(0.04, 0.02, 0.04, 0.10, 0.80)),))
    return WorkloadSpec(n_apps=n_apps, days=days, seed=seed, **kw)


def timer_heavy(n_apps: int = 100_000, days: float = 7.0, seed: int = 0,
                **kw) -> WorkloadSpec:
    """Timer-triggered machine traffic (CV ~ 0): histograms should learn
    near-exact windows and pre-warming should eliminate most cold starts."""
    kw.setdefault("label", f"timer-heavy-{n_apps}")
    kw.setdefault("cohorts", (Cohort(
        name="timers", pattern_probs=(0.50, 0.20, 0.15, 0.10, 0.05),
        trigger_probs=(10.0, 45.0, 5.0, 15.0, 2.0, 2.0, 2.0, 10.0, 5.0,
                       1.0, 2.0, 1.0)),))
    kw.setdefault("diurnal_amplitude", 0.1)
    return WorkloadSpec(n_apps=n_apps, days=days, seed=seed, **kw)


def flash_crowd(n_apps: int = 100_000, days: float = 7.0, seed: int = 0,
                **kw) -> WorkloadSpec:
    """Azure-like fleet with a mid-trace flash crowd (12x intensity for two
    hours): stresses pre-warm scheduling and warm-pool churn."""
    kw.setdefault("label", f"flash-crowd-{n_apps}")
    kw.setdefault("flash_start", 0.5 * days * MINUTES_PER_DAY)
    kw.setdefault("flash_duration", 120.0)
    kw.setdefault("flash_factor", 12.0)
    return WorkloadSpec(n_apps=n_apps, days=days, seed=seed, **kw)


def weekend_dip(n_apps: int = 100_000, days: float = 14.0, seed: int = 0,
                **kw) -> WorkloadSpec:
    """Two business weeks with weekend traffic at 25%: keep-alive policies
    tuned on weekday gaps misfire across the weekend regime shift."""
    kw.setdefault("label", f"weekend-dip-{n_apps}")
    kw.setdefault("weekend_factor", 0.25)
    return WorkloadSpec(n_apps=n_apps, days=days, seed=seed, **kw)


SCENARIOS = {
    "azure_like": azure_like,
    "diurnal": diurnal,
    "bursty": bursty,
    "timer_heavy": timer_heavy,
    "flash_crowd": flash_crowd,
    "weekend_dip": weekend_dip,
}


def scenario(name: str, n_apps: int = 100_000, **kw) -> WorkloadSpec:
    """Look up a named scenario: ``scenario("bursty", 50_000, days=3.0)``."""
    try:
        builder = SCENARIOS[name]
    except KeyError:
        raise ValueError(f"unknown scenario {name!r}; expected one of "
                         f"{sorted(SCENARIOS)}") from None
    return builder(n_apps, **kw)
