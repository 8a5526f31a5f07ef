"""The policy simulator: policy math, workloads, engines and the front door
(:mod:`repro_torch.core.experiment`).

The package re-exports the names of the reference's ``repro.core``, so
``from repro_torch.core import run, HybridSpec, WorkloadSpec`` works as it
does there. The SPES family (``SpesSpec``, ``SpesConfig``, ``SpesPolicy``)
is in ``experiment`` and ``policy``, as in the reference, which does not
re-export it here either.
"""
from . import policy_math
from .histogram import AppHistogram, HistogramConfig, HistogramState, init_state
from .policy import (FixedKeepAlivePolicy, HybridConfig, HybridHistogramPolicy,
                     NoUnloadingPolicy, Policy, PolicyWindows, is_warm,
                     loaded_idle_time)
from .simulator import SimResult, simulate_scalar
from .workload import AppSpec, Trace, generate_trace, sample_apps
from .workload_spec import (SCENARIOS, Cohort, WorkloadSpec, azure_like,
                            bursty, diurnal, flash_crowd, scenario,
                            timer_heavy, weekend_dip)
from .experiment import (ENGINES, EngineOptions, FixedSpec, HybridSpec,
                         NoUnloadSpec, PolicySpec, SweepGrid, SweepResult,
                         as_spec, as_trace, run, sweep)
from .metrics import PolicyPoint, evaluate, normalize_waste, pareto_frontier

__all__ = [
    "policy_math",
    "AppHistogram", "HistogramConfig", "HistogramState", "init_state",
    "FixedKeepAlivePolicy", "HybridConfig", "HybridHistogramPolicy",
    "NoUnloadingPolicy", "Policy", "PolicyWindows", "is_warm",
    "loaded_idle_time", "SimResult", "simulate_scalar",
    "ENGINES", "EngineOptions", "FixedSpec", "HybridSpec", "NoUnloadSpec",
    "PolicySpec", "SweepGrid", "SweepResult", "as_spec", "as_trace", "run",
    "sweep",
    "AppSpec", "Trace", "generate_trace", "sample_apps",
    "SCENARIOS", "Cohort", "WorkloadSpec", "azure_like", "bursty", "diurnal",
    "flash_crowd", "scenario", "timer_heavy", "weekend_dip",
    "PolicyPoint", "evaluate", "normalize_waste", "pareto_frontier",
]
