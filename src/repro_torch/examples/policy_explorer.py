"""Policy design-space exploration (the port of
``examples/policy_explorer.py``): sweep the hybrid policy's knobs
(histogram range, CV threshold, cutoff percentiles) and print the Pareto
frontier — the tool for re-tuning the policy for a new fleet.

The design space is one declarative spec grid over ``experiment.sweep``:
the trace is prepared once for every configuration. ``--scenario`` swaps
the workload regime the frontier is tuned against (any name in
``workload_spec.SCENARIOS``); ``--scenario all`` explores every regime in
one trace x policy sweep.

  PYTHONPATH=src python -m repro_torch.examples.policy_explorer [--apps 500]
  PYTHONPATH=src python -m repro_torch.examples.policy_explorer --scenario all
"""
from __future__ import annotations

import argparse
from typing import List, Optional, Tuple

from ..core import generate_trace, pareto_frontier
from ..core.experiment import EngineOptions, FixedSpec, HybridSpec, sweep
from ..core.workload_spec import SCENARIOS

__all__ = ["build_grid", "explore", "frontier_lines", "main"]


def build_grid() -> list:
    grid = [FixedSpec(float(ka)) for ka in (10, 30, 60, 120, 240)]
    for rng in (60, 120, 240):
        for cv in (0.5, 2.0, 4.0):
            grid.append(HybridSpec(range_minutes=float(rng), cv_threshold=cv,
                                   use_arima=False,
                                   label=f"hyb-r{rng}-cv{cv:g}"))
    for head, tail in ((0, 100), (5, 99), (10, 95)):
        grid.append(HybridSpec(head_percentile=float(head),
                               tail_percentile=float(tail), use_arima=False,
                               label=f"hyb-cut[{head},{tail}]"))
    return grid


def explore(apps: int = 500, days: float = 7.0, seed: int = 1,
            scenario: Optional[str] = None, *, engine: str = "auto",
            device="cuda") -> List[Tuple[str, list]]:
    """(title, PolicyPoints of :func:`build_grid`) per explored workload,
    on ``device``: the eager ``generate_trace`` when ``scenario`` is None,
    else the named scenario (``"all"``: every one, in one sweep)."""
    grid = build_grid()
    opts = EngineOptions(device=device)
    if scenario is None:
        trace = generate_trace(apps, days=days, seed=seed)
        return [("generate_trace",
                 sweep(trace, grid, engine=engine, options=opts).points())]
    names = sorted(SCENARIOS) if scenario == "all" else [scenario]
    specs = [SCENARIOS[n](apps, days=days, seed=seed, max_events=64)
             for n in names]
    res = sweep(traces=specs, specs=grid, engine=engine, options=opts)
    return [(res.trace_name(t), pts) for t, pts in enumerate(res.points())]


def frontier_lines(points, title: str) -> List[str]:
    """The reference script's printed lines for one explored workload."""
    base = next(p for p in points if p.name == "fixed-10m").wasted_memory
    frontier = {p.name for p in pareto_frontier(points)}
    lines = [f"-- {title}",
             f"{'policy':>18s} {'cold% p75':>10s} {'rel.mem':>8s}  pareto"]
    for p in sorted(points, key=lambda p: p.wasted_memory):
        star = "  *" if p.name in frontier else ""
        lines.append(f"{p.name:>18s} {p.cold_pct_p75:>9.1f}% "
                     f"{p.wasted_memory / base:>7.2f}x{star}")
    return lines


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--apps", type=int, default=500)
    ap.add_argument("--days", type=float, default=7.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--scenario", default=None,
                    choices=sorted(SCENARIOS) + ["all"],
                    help="workload regime (default: the eager azure-like "
                         "generate_trace); 'all' sweeps every scenario")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    for title, points in explore(args.apps, args.days, args.seed,
                                 args.scenario, device=args.device):
        for line in frontier_lines(points, title):
            print(line)


if __name__ == "__main__":
    main()
