"""Policy-evaluation metrics and Pareto utilities (paper Section 5)."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

from .simulator import SimResult

__all__ = ["PolicyPoint", "evaluate", "pareto_frontier", "normalize_waste"]


@dataclasses.dataclass(frozen=True)
class PolicyPoint:
    """One policy's position in the cold-start/memory trade-off (Fig. 15)."""

    name: str
    cold_pct_p75: float        # 75th-percentile app cold-start % (paper metric)
    wasted_memory: float       # total loaded-but-idle app-minutes
    always_cold_pct: float     # % of apps with 100% cold starts (Fig. 18)
    cold_pct_p50: float = 0.0
    cold_pct_p90: float = 0.0


def evaluate(name: str, result: SimResult) -> PolicyPoint:
    pct = result.cold_pct
    return PolicyPoint(
        name=name,
        cold_pct_p75=float(np.percentile(pct, 75)),
        wasted_memory=result.total_wasted,
        always_cold_pct=100.0 * result.always_cold_fraction,
        cold_pct_p50=float(np.percentile(pct, 50)),
        cold_pct_p90=float(np.percentile(pct, 90)),
    )


def normalize_waste(points: Sequence[PolicyPoint], baseline: str) -> Dict[str, float]:
    """Wasted memory normalized to a named baseline (paper: 10-min fixed)."""
    base = next(p for p in points if p.name == baseline).wasted_memory
    base = max(base, 1e-9)
    return {p.name: p.wasted_memory / base for p in points}


def pareto_frontier(points: Sequence[PolicyPoint]) -> List[PolicyPoint]:
    """Non-dominated points for (cold_pct_p75, wasted_memory), both minimized."""
    pts = sorted(points, key=lambda p: (p.wasted_memory, p.cold_pct_p75))
    frontier: List[PolicyPoint] = []
    best_cold = float("inf")
    for p in pts:
        if p.cold_pct_p75 < best_cold - 1e-12:
            frontier.append(p)
            best_cold = p.cold_pct_p75
    return frontier
