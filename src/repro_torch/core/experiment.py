"""The experiment front door: declarative policy specs, one ``run()``, and a
vectorized ``sweep()`` that evaluates a whole policy grid in one pass.

    from repro_torch.core.experiment import FixedSpec, HybridSpec, sweep
    grid = [FixedSpec(ka) for ka in (10, 20, 60)] + [HybridSpec(use_arima=False)]
    result = sweep(trace, grid)                  # on the card by default
    for spec, row in zip(result.specs, result):
        print(spec.name, row.cold_pct_percentile(75), row.total_wasted)

Engines (``engine=`` on both ``run`` and ``sweep``):

  * ``"auto"``   — ``"kernel"`` on a CUDA device, ``"fused"`` on the CPU;
  * ``"scalar"`` — the float64 event-driven oracle, one config at a time;
  * ``"fused"``  — float64 time through the plain PyTorch step (the twin of
    the reference's ``"fused"``);
  * ``"kernel"`` — the CUDA sweep-step kernel (the twin of the reference's
    ``"pallas"``), in float64 time like ``"fused"``; on the CPU the
    kernel's plain version runs.

The fixed/no-unload family has no histogram state and runs its float64
loop under every engine. Rows are bit-identical on cold counts,
invocations and final windows to single-config ``run()`` and to the
scalar oracle. Everything runs on ``EngineOptions.device`` (``"cuda"`` by
default); pass ``device="cpu"`` to run on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence, Union

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from .histogram import HistogramConfig
from .policy import (ARIMA_NOT_PORTED, FixedKeepAlivePolicy, HybridConfig,
                     HybridHistogramPolicy, NoUnloadingPolicy)
from .simulator import (SimResult, _run_fixed_sweep, _run_hybrid_sweep,
                        simulate_scalar)
from .workload import Trace
from .workload_spec import WorkloadSpec

__all__ = [
    "ENGINES", "PolicySpec", "FixedSpec", "NoUnloadSpec", "HybridSpec",
    "EngineOptions", "SweepResult", "SweepGrid", "as_spec", "as_trace",
    "run", "sweep",
]

ENGINES = ("auto", "scalar", "fused", "kernel")


@dataclasses.dataclass(frozen=True)
class FixedSpec:
    """The provider state of practice: ``prewarm=0``, constant keep-alive."""
    keep_alive: float = 10.0
    label: Optional[str] = None

    @property
    def name(self) -> str:
        return self.label or f"fixed-{self.keep_alive:g}m"

    def build(self) -> FixedKeepAlivePolicy:
        return FixedKeepAlivePolicy(float(self.keep_alive))


@dataclasses.dataclass(frozen=True)
class NoUnloadSpec:
    """Infinite keep-alive: lower bound on cold starts, upper bound on
    waste (Fig. 14's right edge)."""
    label: Optional[str] = None

    @property
    def keep_alive(self) -> float:
        return float("inf")

    @property
    def name(self) -> str:
        return self.label or "no-unloading"

    def build(self) -> NoUnloadingPolicy:
        return NoUnloadingPolicy()


@dataclasses.dataclass(frozen=True)
class HybridSpec:
    """The paper's hybrid histogram policy, flattened to its knobs (same
    fields and defaults as the reference, including ``use_arima=True``,
    which this package does not run yet: pass ``use_arima=False``)."""
    bin_minutes: float = 1.0          # paper: 1-minute bins
    range_minutes: float = 240.0      # paper: 4-hour default range
    head_percentile: float = 5.0      # paper: 5th percentile -> pre-warm
    tail_percentile: float = 99.0     # paper: 99th percentile -> keep-alive
    margin: float = 0.10              # paper: 10% margin both sides
    cv_threshold: float = 2.0         # paper: CV=2 default (Fig. 17)
    min_samples: int = 5              # too few ITs -> standard keep-alive
    oob_fraction_threshold: float = 0.5   # most ITs OOB -> ARIMA
    arima_min_samples: int = 4
    arima_margin: float = 0.15        # paper: 15% margin
    use_arima: bool = True
    label: Optional[str] = None

    @property
    def name(self) -> str:
        return self.label or f"hybrid-{self.range_minutes:g}m"

    def to_config(self) -> HybridConfig:
        return HybridConfig(
            histogram=HistogramConfig(
                bin_minutes=float(self.bin_minutes),
                range_minutes=float(self.range_minutes),
                head_percentile=float(self.head_percentile),
                tail_percentile=float(self.tail_percentile),
                margin=float(self.margin)),
            cv_threshold=float(self.cv_threshold),
            min_samples=int(self.min_samples),
            oob_fraction_threshold=float(self.oob_fraction_threshold),
            arima_min_samples=int(self.arima_min_samples),
            arima_margin=float(self.arima_margin),
            use_arima=bool(self.use_arima))

    @classmethod
    def from_config(cls, cfg: HybridConfig,
                    label: Optional[str] = None) -> "HybridSpec":
        h = cfg.histogram
        return cls(bin_minutes=h.bin_minutes, range_minutes=h.range_minutes,
                   head_percentile=h.head_percentile,
                   tail_percentile=h.tail_percentile, margin=h.margin,
                   cv_threshold=cfg.cv_threshold,
                   min_samples=cfg.min_samples,
                   oob_fraction_threshold=cfg.oob_fraction_threshold,
                   arima_min_samples=cfg.arima_min_samples,
                   arima_margin=cfg.arima_margin, use_arima=cfg.use_arima,
                   label=label)

    def build(self) -> HybridHistogramPolicy:
        return HybridHistogramPolicy(self.to_config())


PolicySpec = Union[FixedSpec, NoUnloadSpec, HybridSpec]
_SPEC_TYPES = (FixedSpec, NoUnloadSpec, HybridSpec)


def as_spec(obj) -> PolicySpec:
    """Coerce a policy object or ``HybridConfig`` to its spec; raises
    ``TypeError`` for arbitrary policies (run those with
    ``simulate_scalar``)."""
    if isinstance(obj, _SPEC_TYPES):
        return obj
    if isinstance(obj, HybridConfig):
        return HybridSpec.from_config(obj)
    if isinstance(obj, HybridHistogramPolicy):
        return HybridSpec.from_config(obj.cfg)
    if isinstance(obj, FixedKeepAlivePolicy):
        return FixedSpec(obj.keep_alive)
    if isinstance(obj, NoUnloadingPolicy):
        return NoUnloadSpec()
    raise TypeError(
        f"cannot express {type(obj).__name__} as a PolicySpec; build a "
        f"FixedSpec/NoUnloadSpec/HybridSpec, or use simulate_scalar for "
        f"arbitrary Policy objects")


@dataclasses.dataclass(frozen=True)
class EngineOptions:
    """Execution knobs shared by ``run`` and ``sweep``."""
    include_trailing: bool = True     # account waste after the last event
    app_chunk: Optional[int] = None   # apps per device chunk (None: auto,
    #                                   scaled down by the config count)
    device: Union[str, torch.device] = DEFAULT_DEVICE   # "cuda" or "cpu"


@dataclasses.dataclass
class SweepResult:
    """S policy configurations evaluated over one trace (rows in spec
    order; ``row(s)`` is config ``s`` as a :class:`SimResult`)."""
    specs: List[PolicySpec]
    engine: str                    # the engine that ran ("auto" resolved)
    cold: np.ndarray               # [S, n_apps] int64
    invocations: np.ndarray        # [n_apps] int64 (trace property)
    wasted_minutes: np.ndarray     # [S, n_apps] float64
    final_prewarm: np.ndarray      # [S, n_apps] float64
    final_keep_alive: np.ndarray   # [S, n_apps] float64

    def __len__(self) -> int:
        return len(self.specs)

    def row(self, s: int) -> SimResult:
        return SimResult(self.cold[s], self.invocations,
                         self.wasted_minutes[s], self.final_prewarm[s],
                         self.final_keep_alive[s])

    def __iter__(self) -> Iterator[SimResult]:
        return (self.row(s) for s in range(len(self)))

    def points(self):
        """One :class:`~repro_torch.core.metrics.PolicyPoint` per spec."""
        from .metrics import evaluate
        return [evaluate(spec.name, self.row(s))
                for s, spec in enumerate(self.specs)]


@dataclasses.dataclass
class SweepGrid:
    """A (T, S) grid: S policy configurations over T workloads."""
    traces: List[object]
    results: List[SweepResult]

    @property
    def shape(self):
        return (len(self.results),
                len(self.results[0]) if self.results else 0)

    @property
    def specs(self) -> List[PolicySpec]:
        return self.results[0].specs if self.results else []

    def __len__(self) -> int:
        return len(self.results)

    def __getitem__(self, t: int) -> SweepResult:
        return self.results[t]

    def __iter__(self) -> Iterator[SweepResult]:
        return iter(self.results)

    def row(self, t: int, s: int) -> SimResult:
        return self.results[t].row(s)

    def trace_name(self, t: int) -> str:
        obj = self.traces[t]
        return obj.name if isinstance(obj, WorkloadSpec) else f"trace-{t}"

    def points(self):
        return [res.points() for res in self.results]


def as_trace(obj) -> Trace:
    """A ``Trace`` passes through; a ``WorkloadSpec`` is materialized."""
    if isinstance(obj, Trace):
        return obj
    if isinstance(obj, WorkloadSpec):
        return obj.materialize()
    raise TypeError(
        f"expected a Trace or WorkloadSpec, got {type(obj).__name__}")


def _sweep_one(trace: Trace, specs: Sequence, eng: str,
               opts: EngineOptions, device) -> SweepResult:
    n = trace.n_apps
    S = len(specs)
    cold = np.zeros((S, n), np.int64)
    waste = np.zeros((S, n), np.float64)
    pre = np.zeros((S, n), np.float64)
    keep = np.zeros((S, n), np.float64)
    inv: Optional[np.ndarray] = None

    def fill(rows, out):
        nonlocal inv
        if isinstance(out, SimResult):
            out = dataclasses.asdict(out)
        cold[rows] = out["cold"]
        waste[rows] = out["wasted_minutes"]
        pre[rows] = out["final_prewarm"]
        keep[rows] = out["final_keep_alive"]
        inv = out["invocations"]

    if eng == "scalar":
        for s, spec in enumerate(specs):
            fill([s], simulate_scalar(trace, spec.build(),
                                      opts.include_trailing))
        return SweepResult(specs, eng, cold, inv, waste, pre, keep)

    window_idx = [s for s, sp in enumerate(specs)
                  if isinstance(sp, (FixedSpec, NoUnloadSpec))]
    hybrid_idx = [s for s, sp in enumerate(specs)
                  if isinstance(sp, HybridSpec)]
    padded = trace.to_padded()     # once for every family and config
    if window_idx:
        fill(window_idx, _run_fixed_sweep(
            trace, [specs[s].keep_alive for s in window_idx],
            opts.include_trailing, padded=padded, device=device))
    if hybrid_idx:
        fill(hybrid_idx, _run_hybrid_sweep(
            trace, [specs[s].to_config() for s in hybrid_idx],
            opts.include_trailing, app_chunk=opts.app_chunk,
            use_kernel=(eng == "kernel"), padded=padded, device=device))
    return SweepResult(specs, eng, cold, inv, waste, pre, keep)


def sweep(trace=None, specs: Sequence = None, *, traces=None,
          engine: str = "auto", options: Optional[EngineOptions] = None):
    """Evaluate a policy grid over one workload — or a (T, S) grid.

    ``sweep(trace, specs)`` evaluates S configurations (families may mix)
    over one workload (``Trace`` or ``WorkloadSpec``) in one pass and
    returns a :class:`SweepResult`; ``sweep(traces=[...], specs=[...])``
    returns a :class:`SweepGrid`. Raises ``NotImplementedError`` for a
    ``HybridSpec`` with ``use_arima=True`` (not ported yet) and
    ``RuntimeError`` when the device is CUDA and there is none."""
    if specs is None:
        raise TypeError("sweep() requires specs (a list of PolicySpec)")
    specs = [as_spec(s) for s in specs]
    if not specs:
        raise ValueError("sweep() needs at least one PolicySpec")
    if (trace is None) == (traces is None):
        raise TypeError("pass exactly one of trace= or traces=")
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected one of "
                         f"{ENGINES}")
    if any(isinstance(s, HybridSpec) and s.use_arima for s in specs):
        raise NotImplementedError(ARIMA_NOT_PORTED)
    opts = options or EngineOptions()
    device = None if engine == "scalar" else resolve_device(opts.device)
    if engine == "auto":
        engine = "kernel" if device.type == "cuda" else "fused"
    if traces is None:
        return _sweep_one(as_trace(trace), specs, engine, opts, device)
    traces = list(traces)
    if not traces:
        raise ValueError("sweep() needs at least one trace")
    return SweepGrid(traces=traces,
                     results=[_sweep_one(as_trace(t), specs, engine, opts,
                                         device) for t in traces])


def run(trace, spec, *, engine: str = "auto",
        options: Optional[EngineOptions] = None) -> SimResult:
    """Evaluate one policy configuration (the S=1 sweep) over one
    workload."""
    return sweep(trace, [spec], engine=engine, options=options).row(0)
