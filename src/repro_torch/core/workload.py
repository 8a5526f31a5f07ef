"""Azure-Functions-like synthetic workload generation (numpy; a copy of
``repro/core/workload.py`` that needs no JAX).

The real trace is released at github.com/Azure/AzurePublicDataset; offline we
generate traces *from the paper's published distributions* so every figure of
Section 5 can be reproduced in trend:

  * invocations/day per app: 8-order-of-magnitude piecewise-log-linear CDF
    anchored at the paper's Fig. 5(a) markers (45% of apps <= 1/hour,
    81% <= 1/minute);
  * arrival patterns calibrated to the Fig. 6 CV classes: ~20% of apps
    CV ~ 0 (periodic timers), a band between 0 and 1 (multi-timer mixtures),
    a Poisson band (CV ~ 1), and ~40% with CV > 1 (bursty);
  * diurnal modulation with a ~50% constant baseline (Fig. 4);
  * execution times ~ lognormal(mu=-0.38, sigma=2.36) seconds (Fig. 7 MLE fit);
  * allocated memory ~ Burr XII (c=11.652, k=0.221, lambda=107.083) MB (Fig. 8);
  * functions per app from the Fig. 1 CDF (54% single-function,
    95% <= 10 functions);
  * trigger mix from Fig. 2/3.

Invocation times are produced in **minutes** (float). Apps whose average rate
exceeds 1/minute are capped to one invocation per minute-bin: the dataset
itself is 1-minute binned, and for cold-start simulation any such app is
permanently warm under every policy considered, so the cap changes no result
while bounding trace size.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["AppSpec", "Trace", "sample_apps", "generate_trace", "PATTERNS"]


MINUTES_PER_DAY = 1440.0

# Fig. 5(a) CDF anchors: (fraction of apps, log10(invocations/day)).
_RATE_CDF = np.array([
    (0.00, -1.00),   # ~1 invocation / 10 days
    (0.10, 0.00),    # 1 / day
    (0.45, np.log10(24.0)),     # 1 / hour   (paper: 45% of apps)
    (0.65, 2.30),
    (0.81, np.log10(1440.0)),   # 1 / minute (paper: 81% of apps)
    (0.92, 4.50),
    (0.98, 6.00),
    (1.00, 7.00),    # 1e7 / day — 8 orders of magnitude total
])

# Fig. 1 CDF anchors: (fraction of apps, log10(functions/app)).
_FUNC_CDF = np.array([
    (0.54, 0.0),                 # 54% single-function
    (0.80, np.log10(3.0)),
    (0.95, 1.0),                 # 95% <= 10 functions
    (0.9996, 2.0),               # 0.04% > 100
    (1.0, np.log10(2000.0)),
])

# Arrival pattern classes calibrated against Fig. 6:
#   periodic     CV ~ 0   (single timers; ~20% of all apps have CV ~ 0)
#   multi_timer  CV in (0, 1)  (merged timers)
#   regular      CV ~ 0.5 (Erlang IATs — sub-Poisson variability)
#   poisson      CV ~ 1
#   bursty       CV > 1   (~40% of apps; bursts of closely spaced calls)
# Pattern probabilities are conditioned on the app's rate class: low-rate
# apps are predominantly human/event driven (bursty HTTP), high-rate apps are
# machine generated (closer to Poisson), mirroring Sections 3.2-3.3.
PATTERNS = ("periodic", "multi_timer", "regular", "poisson", "bursty")
#                          periodic  multi  regular poisson bursty
_PATTERN_PROBS_LOW = (0.12, 0.06, 0.04, 0.12, 0.66)   # rate <= 1/hour
_PATTERN_PROBS_MID = (0.20, 0.10, 0.10, 0.15, 0.45)   # 1/hour - 1/minute
_PATTERN_PROBS_HIGH = (0.15, 0.05, 0.15, 0.40, 0.25)  # >= 1/minute

# Round timer periods, minutes (1 min ... 1 week).
_ROUND_PERIODS = np.array([1., 2., 5., 10., 15., 30., 60., 120., 240., 480.,
                           720., 1440., 2880., 10080.])

# Fig. 3(b): most common trigger combinations.
_TRIGGER_COMBOS = (
    ("http",), ("timer",), ("queue",), ("http", "timer"), ("http", "queue"),
    ("event",), ("storage",), ("timer", "queue"), ("http", "timer", "queue"),
    ("http", "other"), ("http", "storage"), ("http", "orchestration"),
)
_TRIGGER_PROBS = np.array([43.27, 13.36, 9.47, 4.59, 4.22, 3.01, 2.80, 2.57,
                           2.48, 1.69, 1.05, 1.03])

# Fig. 7 lognormal fit of average execution time (seconds, natural log).
EXEC_LOG_MEAN = -0.38
EXEC_LOG_SIGMA = 2.36

# Fig. 8 Burr XII fit of average allocated memory (MB).
MEM_BURR_C = 11.652
MEM_BURR_K = 0.221
MEM_BURR_LAMBDA = 107.083


@dataclasses.dataclass(frozen=True)
class AppSpec:
    app_id: str
    pattern: str                 # one of PATTERNS
    rate_per_day: float          # average invocations / day
    period_minutes: float        # base period for timer patterns
    exec_time_s: float           # average function execution time
    memory_mb: float             # average allocated memory
    n_functions: int
    triggers: Tuple[str, ...]


@dataclasses.dataclass
class Trace:
    specs: Optional[List[AppSpec]]
    times: Optional[List[np.ndarray]]  # per-app invocation times, minutes, sorted
    duration_minutes: float
    # Cached/primary padded representation. Fleet-scale generated traces
    # (``WorkloadSpec.materialize()``) carry ONLY this form — no per-app
    # python objects.
    _padded: Optional[Tuple[np.ndarray, np.ndarray]] = \
        dataclasses.field(default=None, repr=False)

    @property
    def n_apps(self) -> int:
        if self.times is not None:
            return len(self.times)
        return int(self._padded[0].shape[0])

    def app_id(self, i: int) -> str:
        return self.specs[i].app_id if self.specs is not None else f"app-{i:06d}"

    def events(self, i: int) -> np.ndarray:
        """Invocation times of app ``i`` (works for padded-only traces)."""
        if self.times is not None:
            return self.times[i]
        padded, counts = self._padded
        return padded[i, : int(counts[i])]

    def to_padded(self) -> Tuple[np.ndarray, np.ndarray]:
        """Return (times [n_apps, max_ev] padded with +inf, counts [n_apps]).

        The time dtype of the source arrays is preserved (float64 for
        generated traces) so the float64 simulator scans see full-precision
        inter-arrival times. List-backed traces build a fresh array per
        call (so ``times`` edits are always honored); padded-only traces
        (``WorkloadSpec.materialize()``) return their shared primary arrays —
        treat those as read-only, a fleet-scale trace cannot afford a copy
        per call.
        """
        if self._padded is not None:
            return self._padded
        counts = np.array([len(t) for t in self.times], np.int32)
        max_ev = max(int(counts.max()), 1) if len(counts) else 1
        dtype = self.times[0].dtype if self.times else np.float64
        out = np.full((self.n_apps, max_ev), np.inf, dtype)
        for i, t in enumerate(self.times):
            out[i, : len(t)] = t
        return out, counts

    def iats(self, i: int) -> np.ndarray:
        return np.diff(self.events(i))


def _inv_cdf(anchors: np.ndarray, u: np.ndarray) -> np.ndarray:
    """Piecewise-linear inverse CDF in the anchors' y-units."""
    return np.interp(u, anchors[:, 0], anchors[:, 1])


def _sample_rates(rng: np.random.Generator, n: int) -> np.ndarray:
    return 10.0 ** _inv_cdf(_RATE_CDF, rng.uniform(0.0, 1.0, n))


def _sample_n_functions(rng: np.random.Generator, n: int) -> np.ndarray:
    u = rng.uniform(0.0, 1.0, n)
    # below the first anchor everything is a single function
    vals = np.where(u <= _FUNC_CDF[0, 0], 0.0, _inv_cdf(_FUNC_CDF, u))
    return np.maximum(np.round(10.0 ** vals), 1).astype(np.int64)


def _sample_memory_mb(rng: np.random.Generator, n: int) -> np.ndarray:
    """Burr XII sampling by inverse CDF: F(x) = 1 - [1+(x/l)^c]^{-k}."""
    u = rng.uniform(0.0, 1.0, n)
    x = MEM_BURR_LAMBDA * ((1.0 - u) ** (-1.0 / MEM_BURR_K) - 1.0) ** (1.0 / MEM_BURR_C)
    return np.clip(x, 1.0, 16384.0)


def _sample_exec_s(rng: np.random.Generator, n: int) -> np.ndarray:
    return np.exp(rng.normal(EXEC_LOG_MEAN, EXEC_LOG_SIGMA, n))


def sample_apps(n_apps: int, seed: int = 0) -> List[AppSpec]:
    rng = np.random.default_rng(seed)
    rates = _sample_rates(rng, n_apps)
    mems = _sample_memory_mb(rng, n_apps)
    execs = _sample_exec_s(rng, n_apps)
    nfuncs = _sample_n_functions(rng, n_apps)
    trig_p = _TRIGGER_PROBS / _TRIGGER_PROBS.sum()
    trig_idx = rng.choice(len(_TRIGGER_COMBOS), n_apps, p=trig_p)
    specs = []
    for i in range(n_apps):
        rate = float(rates[i])
        if rate <= 24.0:
            probs = _PATTERN_PROBS_LOW
        elif rate <= MINUTES_PER_DAY:
            probs = _PATTERN_PROBS_MID
        else:
            probs = _PATTERN_PROBS_HIGH
        pattern = PATTERNS[rng.choice(len(PATTERNS), p=probs)]
        # timer apps: 95% fire at most once per minute (paper Sec. 3.2), and
        # real timers use round periods (1/5/15/30 min, hourly, daily...)
        if pattern in ("periodic", "multi_timer"):
            rate = min(rate, MINUTES_PER_DAY)  # at most 1/minute
            raw_period = MINUTES_PER_DAY / max(rate, 1e-9)
            snapped = _ROUND_PERIODS[np.argmin(np.abs(np.log(_ROUND_PERIODS)
                                                      - np.log(raw_period)))]
            rate = MINUTES_PER_DAY / snapped
        period = MINUTES_PER_DAY / max(rate, 1e-9)
        specs.append(AppSpec(
            app_id=f"app-{i:06d}",
            pattern=pattern,
            rate_per_day=rate,
            period_minutes=float(max(period, 1.0)),
            exec_time_s=float(execs[i]),
            memory_mb=float(mems[i]),
            n_functions=int(nfuncs[i]),
            triggers=_TRIGGER_COMBOS[trig_idx[i]],
        ))
    return specs


def _diurnal_accept(rng: np.random.Generator, t_minutes: np.ndarray) -> np.ndarray:
    """Thinning mask for the Fig. 4 shape: ~50% constant baseline + diurnal."""
    phase = 2.0 * np.pi * (t_minutes % MINUTES_PER_DAY) / MINUTES_PER_DAY
    p = 0.55 + 0.45 * 0.5 * (1.0 + np.sin(phase - 0.5 * np.pi))
    return rng.uniform(0.0, 1.0, len(t_minutes)) < p


def _gen_periodic(rng, spec: AppSpec, duration: float) -> np.ndarray:
    phase = rng.uniform(0.0, spec.period_minutes)
    return np.arange(phase, duration, spec.period_minutes)


def _gen_multi_timer(rng, spec: AppSpec, duration: float) -> np.ndarray:
    # two timers with co-prime-ish periods; combined CV lands in (0, 1)
    p1 = spec.period_minutes * 2.0
    p2 = p1 * rng.uniform(1.2, 3.0)
    t1 = np.arange(rng.uniform(0, p1), duration, p1)
    t2 = np.arange(rng.uniform(0, p2), duration, p2)
    return np.unique(np.concatenate([t1, t2]))


def _gen_poisson(rng, spec: AppSpec, duration: float) -> np.ndarray:
    mean_iat = spec.period_minutes
    n = int(duration / mean_iat * 2.5) + 16
    iats = rng.exponential(mean_iat / 0.775, n)  # 1/0.775 ~ mean diurnal accept
    t = np.cumsum(iats)
    t = t[t < duration]
    return t[_diurnal_accept(rng, t)]


def _gen_regular(rng, spec: AppSpec, duration: float) -> np.ndarray:
    """Erlang-4 IATs: CV = 0.5 — more regular than Poisson (Fig. 6 mid-band:
    machine traffic with some jitter, e.g. periodic sensors over a network)."""
    mean_iat = spec.period_minutes
    k = 4
    n = int(duration / mean_iat * 1.5) + 16
    iats = rng.gamma(k, mean_iat / k, n)
    t = np.cumsum(iats)
    return t[t < duration]


def _gen_bursty(rng, spec: AppSpec, duration: float) -> np.ndarray:
    """Explicit burst structure: runs of closely spaced invocations separated
    by long idle gaps. This is what produces CV >> 1 (Fig. 6) and, crucially,
    the paper's observed cold-start profile: an app averaging 1/hour that
    arrives in bursts of ~B calls suffers only ~1/B cold starts under a short
    keep-alive, unlike a Poisson app of equal rate."""
    mean_iat = spec.period_minutes
    if mean_iat <= 2.0:
        # effectively continuous traffic; bursts are meaningless
        return _gen_poisson(rng, spec, duration)
    burst_mean = rng.uniform(6.0, 30.0)           # mean invocations per burst
    intra_mean = rng.uniform(0.8, 2.5)            # minutes between calls in a burst
    cycle = burst_mean * mean_iat                 # preserve the average rate
    times = []
    t = rng.uniform(0.0, cycle)
    while t < duration:
        size = 1 + rng.poisson(burst_mean - 1.0)
        bt = t
        for _ in range(size):
            times.append(bt)
            bt += rng.exponential(intra_mean)
        gap = rng.exponential(max(cycle - size * intra_mean, mean_iat))
        t = bt + gap
    t_arr = np.asarray(times)
    t_arr = t_arr[t_arr < duration]
    return t_arr[_diurnal_accept(rng, t_arr)]


_GEN = {
    "periodic": _gen_periodic,
    "multi_timer": _gen_multi_timer,
    "regular": _gen_regular,
    "poisson": _gen_poisson,
    "bursty": _gen_bursty,
}


def generate_invocations(spec: AppSpec, duration_minutes: float,
                         rng: np.random.Generator) -> np.ndarray:
    t = _GEN[spec.pattern](rng, spec, duration_minutes)
    t = np.sort(t)
    if len(t) > 1:
        # cap at one invocation per minute-bin (dataset granularity; see module doc)
        keep = np.ones(len(t), bool)
        last = t[0]
        for i in range(1, len(t)):
            if t[i] - last < 1.0:
                keep[i] = False
            else:
                last = t[i]
        t = t[keep]
    return t.astype(np.float64)


def generate_trace(n_apps: int, days: float = 7.0, seed: int = 0,
                   specs: Optional[Sequence[AppSpec]] = None) -> Trace:
    """Eager §3-faithful trace: ``AppSpec`` objects + per-app float64 times.

    A thin wrapper over the vectorized scenario engine
    (:func:`repro_torch.core.workload_spec.azure_like` in eager mode) — one
    sampling pass per cohort block, no per-app generation loop. The paper's
    dataset guarantees every app at least one invocation, so ``min_events=1``
    and the event budget is left uncapped (minute-bin bound).

    Passing explicit ``specs`` keeps the legacy per-app path: arbitrary
    ``AppSpec`` lists are honored app-by-app via
    :func:`generate_invocations` (the callers that build custom specs are
    small-n tests and the cluster sim).
    """
    duration = days * MINUTES_PER_DAY
    if specs is not None:
        rng = np.random.default_rng(seed + 1)
        times = [generate_invocations(s, duration, rng) for s in specs]
        # Paper: every app in the dataset has at least one invocation.
        for i, t in enumerate(times):
            if len(t) == 0:
                times[i] = np.array([rng.uniform(0.0, duration)])
        return Trace(specs=list(specs), times=times, duration_minutes=duration)
    from .workload_spec import azure_like
    return azure_like(n_apps, days=days, seed=seed, max_events=None,
                      min_events=1).materialize(eager=True)
