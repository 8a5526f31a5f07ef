"""Serving launcher: serverless model platform driven by a synthetic trace
(the port of ``repro/launch/serve.py``).

Example:
  PYTHONPATH=src python -m repro_torch.launch.serve --apps 40 --minutes 120 \
      --policy hybrid [--device cpu]

``--engine auto`` (default) runs the columnar fleet engine
(:mod:`repro.serving.cluster_vector`), which scales to millions of apps
and replays HBM evictions to a fixed point, bit-identical to the oracle
when the registry oversubscribes the worker budget. ``--engine scalar``
runs the per-event oracle. Phase B of the vector engine (the sweep-step
kernel) and the oracle's forecasters run on ``--device``: the card unless
``--device cpu``.
"""
from __future__ import annotations

import argparse

import numpy as np

from .. import configs
from ..core.experiment import FixedSpec, HybridSpec
from ..core.workload import generate_trace
from ..models import n_params
from ..runtime.straggler import HedgePolicy
from ..serving.apptable import AppTable
from ..serving.cluster_vector import ClusterSpec, run_cluster
from ..serving.registry import ModelEndpoint, Registry

__all__ = ["build_registry", "make_policy_spec", "main"]


def build_registry(n_apps: int, seed: int = 0,
                   hbm_budget_bytes: float = 16e9) -> Registry:
    """Endpoints cycle through the assigned architectures whose weights fit
    a single worker's HBM budget (a 145 GB model can never be resident in a
    16 GB worker -- those serve from multi-worker slices, out of scope for
    the single-worker pool), giving a realistic 0.3-13 GB cold-start
    spread."""
    reg = Registry()
    fitting = [a for a in configs.ARCHS
               if 2 * n_params(configs.get(a)) <= 0.8 * hbm_budget_bytes]
    rng = np.random.default_rng(seed)
    for i in range(n_apps):
        cfg = configs.get(fitting[i % len(fitting)])
        reg.register(ModelEndpoint(app_id=f"app-{i:06d}", cfg=cfg, seed=i,
                                   avg_request_s=float(rng.uniform(0.05, 2))))
    return reg


def make_policy_spec(name: str, keep_alive: float):
    if name == "hybrid":
        return HybridSpec()
    if name == "fixed":
        return FixedSpec(keep_alive)
    raise ValueError(name)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--apps", type=int, default=40)
    ap.add_argument("--minutes", type=float, default=240)
    ap.add_argument("--policy", default="hybrid", choices=["hybrid", "fixed"])
    ap.add_argument("--keep-alive", type=float, default=10.0)
    ap.add_argument("--workers", type=int, default=18)
    ap.add_argument("--hbm-gb", type=float, default=16.0)
    ap.add_argument("--hedge", action="store_true")
    ap.add_argument("--engine", default="auto",
                    choices=["auto", "vector", "scalar"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    trace = generate_trace(args.apps, days=args.minutes / 1440.0,
                           seed=args.seed)
    reg = build_registry(args.apps, args.seed, args.hbm_gb * 1e9)
    table = AppTable.from_trace(
        trace, weight_bytes=[reg.get(s.app_id).weight_bytes
                             for s in trace.specs])
    res = run_cluster(
        table, make_policy_spec(args.policy, args.keep_alive),
        ClusterSpec(n_workers=args.workers,
                    hbm_budget_bytes=args.hbm_gb * 1e9,
                    hedge=HedgePolicy() if args.hedge else None),
        engine=args.engine, device=args.device)
    print(f"policy={args.policy} apps={args.apps} minutes={args.minutes:g}")
    print(f"  cold-start p75 over apps: {res.cold_pct_p75:.1f}%")
    print(f"  latency p50/p95/p99: {res.latency_pct(50):.2f}/"
          f"{res.latency_pct(95):.2f}/{res.latency_pct(99):.2f} s")
    print(f"  wasted HBM: {res.wasted_gb_minutes:.1f} GB-minutes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
