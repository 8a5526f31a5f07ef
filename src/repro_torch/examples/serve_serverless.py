"""End-to-end serverless model serving (the port of
``examples/serve_serverless.py``): real PyTorch models behind a warm pool
driven by the hybrid histogram policy. Requests arrive on a generated
trace; a cold start initialises the endpoint's weights (once) and copies
them to the device, a warm request hits resident weights. Measures the
realised cold/warm latency gap and the policy's hit rate, then compares
against the fixed 10-minute keep-alive.

  PYTHONPATH=src python -m repro_torch.examples.serve_serverless [--minutes 90] [--apps 6]

The endpoints are reduced configs of the six architectures, served with
``use_kernels=False`` (the configs' default), as in the reference.
"""
from __future__ import annotations

import argparse
from typing import List, Tuple

import numpy as np
import torch

from ..configs import get, reduced
from ..core.experiment import FixedSpec, HybridSpec
from ..core.workload import AppSpec, Trace
from ..serving.engine import ServeEngine
from ..serving.registry import ModelEndpoint, Registry
from ..serving.warmpool import PoolStats, WarmPool

__all__ = ["ARCH_IDS", "build", "drive", "drive_lines", "saving_line",
           "main"]

MIN = 60.0
ARCH_IDS = ("smollm-135m", "mamba2-2.7b", "recurrentgemma-2b",
            "olmoe-1b-7b", "qwen2-7b", "seamless-m4t-medium")


def build(apps: int = 4, minutes: float = 600.0,
          seed: int = 0) -> Tuple[Registry, Trace]:
    """The endpoints (reduced configs, cycling over :data:`ARCH_IDS`) and
    their periodic request trace (period >> 10 min: the regime where the
    histogram policy's pre-warming beats any fixed keep-alive)."""
    registry = Registry()
    for i in range(apps):
        cfg = reduced(get(ARCH_IDS[i % len(ARCH_IDS)]))
        registry.register(ModelEndpoint(app_id=f"app-{i:06d}", cfg=cfg,
                                        seed=i, weight_bytes=int(50e6)))
    rng = np.random.default_rng(seed)
    specs, times = [], []
    for i in range(apps):
        period = float(rng.choice([15.0, 20.0, 30.0, 40.0]))
        t = np.arange(rng.uniform(0, 5), minutes, period)
        specs.append(AppSpec(app_id=f"app-{i:06d}", pattern="periodic",
                             rate_per_day=1440.0 / period,
                             period_minutes=period, exec_time_s=0.5,
                             memory_mb=100.0, n_functions=1,
                             triggers=("timer",)))
        times.append(t)
    return registry, Trace(specs=specs, times=times, duration_minutes=minutes)


def drive(policy_spec, trace: Trace, registry: Registry, *, device="cuda",
          max_events: int = 150) -> Tuple[PoolStats, List[float],
                                          List[float]]:
    """Serve the trace's first ``max_events`` requests through a
    ``ServeEngine`` on ``device`` behind a ``WarmPool`` running
    ``policy_spec``. Returns the pool's stats and the measured cold and
    warm request latencies (seconds)."""
    engine = ServeEngine(registry, device=device)
    policy = policy_spec.build(device=device) \
        if isinstance(policy_spec, HybridSpec) else policy_spec.build()
    pool = WarmPool(registry, policy)
    events = []
    for i, spec in enumerate(trace.specs):
        for t in trace.times[i]:
            events.append((t * MIN, spec.app_id))
    events.sort()
    events = events[:max_events]

    lat_cold, lat_warm = [], []
    toks = torch.zeros((1, 8), dtype=torch.long)
    for t, app in events:
        was_cold, _ = pool.on_request(app, t)
        if not engine.is_loaded(app):
            engine.load(app)
        _, wall = engine.generate(app, toks, max_new=4, max_len=16)
        (lat_cold if was_cold else lat_warm).append(wall)
        pool.on_request_end(app, t)
        # mirror the policy's decisions onto the engine
        if not pool.state[app].loaded:
            engine.unload(app)
    stats = pool.finalize(events[-1][0] if events else 0.0)
    return stats, lat_cold, lat_warm


def drive_lines(name: str, stats: PoolStats, lat_cold: List[float],
                lat_warm: List[float]) -> List[str]:
    """The reference script's printed lines for one :func:`drive`."""
    total = stats.cold_starts + stats.warm_starts
    lines = [f"[{name}] requests={total} "
             f"cold={stats.cold_starts} "
             f"({100 * stats.cold_starts / total:.1f}%) "
             f"prewarms={stats.prewarms} "
             f"resident GB-min="
             f"{stats.resident_byte_seconds / 1e9 / 60:.2f}"]
    if lat_cold and lat_warm:
        lines.append(f"   measured latency: cold p50 "
                     f"{np.median(lat_cold) * 1e3:.1f} ms"
                     f" vs warm p50 {np.median(lat_warm) * 1e3:.1f} ms")
    return lines


def saving_line(hybrid: PoolStats, fixed: PoolStats) -> str:
    saving = 100 * (1 - hybrid.resident_byte_seconds
                    / max(fixed.resident_byte_seconds, 1e-9))
    return (f"\nhybrid policy memory saving vs fixed-10m: {saving:.1f}% "
            f"(paper's OpenWhisk experiment: 15.6%)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--apps", type=int, default=4)
    ap.add_argument("--minutes", type=float, default=600.0,
                    help="simulated minutes (virtual time is free)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    registry, trace = build(args.apps, args.minutes, args.seed)
    print(f"serving {args.apps} endpoints over {args.minutes:g} simulated "
          f"minutes (real model executions)\n")
    stats = {}
    for spec in (HybridSpec(use_arima=False, label="hybrid"),
                 FixedSpec(10.0)):
        stats[spec.name] = out = drive(spec, trace, registry,
                                       device=args.device)
        for line in drive_lines(spec.name, *out):
            print(line)
    print(saving_line(stats["hybrid"][0], stats["fixed-10m"][0]))


if __name__ == "__main__":
    main()
