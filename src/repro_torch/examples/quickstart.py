"""Quickstart: reproduce the paper's headline result (the port of
``examples/quickstart.py``).

Generates an Azure-like FaaS trace from the paper's published
distributions, evaluates the policy grid — fixed keep-alives, the hybrid
histogram policy, and the no-unloading bound — with ONE ``sweep()`` call
(Fig. 15's Pareto comparison in one vectorized pass), then repeats the
comparison across workload *regimes* with the trace axis
(``sweep(traces=[...], specs=[...])``).

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import List, Sequence, Tuple

from ..core import generate_trace, pareto_frontier
from ..core.experiment import (EngineOptions, FixedSpec, HybridSpec,
                               NoUnloadSpec, sweep)
from ..core.workload_spec import azure_like, bursty, timer_heavy

__all__ = ["grid", "headline", "headline_lines", "regimes", "regime_lines",
           "main"]


def grid() -> list:
    """The headline policy grid: fixed keep-alives, the hybrid policy at
    two ranges, and the no-unloading bound."""
    return ([FixedSpec(float(ka)) for ka in (10, 60, 120)]
            + [HybridSpec(range_minutes=float(rng), use_arima=False)
               for rng in (120, 240)]
            + [NoUnloadSpec()])


def headline(n_apps: int = 400, days: float = 7.0, seed: int = 0, *,
             engine: str = "auto", device="cuda"):
    """The generated trace's app and invocation counts and one
    ``PolicyPoint`` per spec of :func:`grid`, on ``device``."""
    trace = generate_trace(n_apps=n_apps, days=days, seed=seed)
    n_inv = sum(len(t) for t in trace.times)
    points = sweep(trace, grid(), engine=engine,
                   options=EngineOptions(device=device)).points()
    return trace.n_apps, n_inv, points


def headline_lines(n_apps: int, n_inv: int, points) -> List[str]:
    """The reference script's printed lines for :func:`headline`."""
    lines = [f"  {n_apps} apps, {n_inv:,} invocations\n"]
    base = points[0].wasted_memory
    lines.append(f"{'policy':>14s} {'cold% (p75 app)':>16s} "
                 f"{'rel. memory':>12s}")
    for p in points:
        lines.append(f"{p.name:>14s} {p.cold_pct_p75:>15.1f}% "
                     f"{p.wasted_memory / base:>11.2f}x")
    frontier = {p.name for p in pareto_frontier(points)}
    lines.append(f"\nPareto-optimal policies: {sorted(frontier)}")
    hybrid = next(p for p in points if p.name == "hybrid-240m")
    fixed10 = points[0]
    lines.append(f"\nPaper's claim: the hybrid policy beats the 10-min fixed "
                 f"keep-alive on BOTH axes:\n"
                 f"  cold starts: {fixed10.cold_pct_p75:.1f}% -> "
                 f"{hybrid.cold_pct_p75:.1f}%   "
                 f"memory: 1.00x -> {hybrid.wasted_memory / base:.2f}x")
    return lines


def regimes(n_apps: int = 2000, days: float = 3.0, seed: int = 0,
            max_events: int = 48, *, engine: str = "auto",
            device="cuda") -> List[Tuple[str, float, float]]:
    """(scenario, fixed-10m p75 cold %, hybrid p75 cold %) for three
    workload regimes in one trace x policy sweep, on ``device``."""
    scenarios = [make(n_apps, days=days, seed=seed, max_events=max_events)
                 for make in (azure_like, bursty, timer_heavy)]
    res = sweep(traces=scenarios,
                specs=[FixedSpec(10.0), HybridSpec(use_arima=False)],
                engine=engine, options=EngineOptions(device=device))
    return [(res.trace_name(t), res.row(t, 0).cold_pct_percentile(75),
             res.row(t, 1).cold_pct_percentile(75))
            for t in range(len(res))]


def regime_lines(rows: Sequence[Tuple[str, float, float]]) -> List[str]:
    """The reference script's printed lines for :func:`regimes`."""
    lines = ["\nsame grid across workload scenarios (trace x policy sweep):",
             f"{'scenario':>22s} {'fixed-10m p75':>14s} {'hybrid p75':>11s}"]
    for name, f10, hyb in rows:
        lines.append(f"{name:>22s} {f10:>13.1f}% {hyb:>10.1f}%")
    return lines


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    print("generating 7-day trace (400 apps) from the paper's "
          "distributions...")
    for line in headline_lines(*headline(device=args.device)):
        print(line)
    for line in regime_lines(regimes(device=args.device)):
        print(line)


if __name__ == "__main__":
    main()
