"""Serving-cluster discrete-event simulator (the §5.3 OpenWhisk analog).

Replays an invocation trace against a fleet of invoker workers, each with
an HBM budget and a warm pool driven by a cold-start policy. Includes
straggler mitigation (hedged requests, see
:mod:`repro_torch.runtime.straggler`) and
controller fault injection (the policy/warm-pool state is checkpointed and
restored mid-run, demonstrating that learned windows survive restarts).

Outputs the same metrics the paper reports: per-app cold-start %, wasted
(resident-idle) memory time, plus latency distributions from the cold-start
cost model. The port of ``repro/serving/cluster_sim.py``: pure Python over
the port's ``WarmPool``; each worker's policy is built for ``device``
(where a hybrid policy's ARIMA forecasters fit).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..core.experiment import HybridSpec
from ..runtime.straggler import HedgePolicy
from .apptable import fnv1a64
from .registry import Registry
from .warmpool import WarmPool

__all__ = ["MINUTE", "ClusterConfig", "ClusterResult", "ClusterSim"]

MINUTE = 60.0


@dataclasses.dataclass
class ClusterConfig:
    n_workers: int = 18                  # paper: 18 invoker VMs
    hbm_budget_bytes: float = 16e9       # per worker
    hedge: Optional[HedgePolicy] = None
    checkpoint_at_minute: Optional[float] = None   # controller fault injection
    balancing: str = "affinity"          # "affinity" | "hash"


@dataclasses.dataclass
class ClusterResult:
    cold_pct_per_app: np.ndarray
    latencies_s: np.ndarray
    wasted_gb_minutes: float
    stats_per_worker: List[dict]
    restored_mid_run: bool = False

    @property
    def cold_pct_p75(self) -> float:
        return float(np.percentile(self.cold_pct_per_app, 75))

    @property
    def evictions(self) -> int:
        """Total HBM-pressure evictions across the fleet."""
        return int(sum(s["evictions"] for s in self.stats_per_worker))

    @property
    def budget_overflows(self) -> int:
        """Loads that proceeded over budget (nothing left to evict)."""
        return int(sum(s.get("budget_overflows", 0)
                       for s in self.stats_per_worker))

    def latency_pct(self, q: float) -> float:
        return float(np.percentile(self.latencies_s, q))


class ClusterSim:
    """Controller + N invoker workers, each with its own warm pool.

    ``policy`` is a declarative PolicySpec
    (:mod:`repro_torch.core.experiment`) — every worker builds its own
    stateful policy from it, a hybrid one with its forecasters on
    ``device`` (the card unless told otherwise) — or a zero-arg factory
    returning ``Policy`` objects.
    """

    def __init__(self, registry: Registry, policy, cfg: ClusterConfig, *,
                 device: Union[None, str, torch.device] = None):
        if cfg.balancing not in ("affinity", "hash"):
            raise ValueError(f"unknown balancing {cfg.balancing!r}; "
                             "use 'affinity' or 'hash'")
        self.registry = registry
        self.cfg = cfg
        if callable(policy):
            make_policy = policy
        elif isinstance(policy, HybridSpec):
            make_policy = lambda: policy.build(device=device)
        else:
            make_policy = policy.build
        self.pools = [WarmPool(registry, make_policy(),
                               budget_bytes=cfg.hbm_budget_bytes)
                      for _ in range(cfg.n_workers)]
        self._assign: Dict[str, int] = {}
        # Incremental per-worker resident-app counters: every assigned app
        # immediately creates exactly one pool.state entry, so these equal
        # len(pool.state) at each assignment point without a per-event
        # list rebuild over every pool.
        self._loads = [0] * cfg.n_workers

    def _worker_for(self, app_id: str) -> int:
        # Affinity load-balancer: an app sticks to one worker (maximizes
        # warm hits), assigned by least-loaded-at-first-sight. Hash mode is
        # the stateless alternative (FNV-1a, no controller state).
        w = self._assign.get(app_id)
        if w is None:
            if self.cfg.balancing == "hash":
                w = fnv1a64(app_id) % self.cfg.n_workers
            else:
                w = int(np.argmin(self._loads))
                self._loads[w] += 1
            self._assign[app_id] = w
        return w

    def run(self, trace, exec_time_s: Optional[Dict[str, float]] = None
            ) -> ClusterResult:
        # Declarative workloads are materialized eagerly: the cluster sim
        # needs per-app AppSpecs (exec times, app ids) alongside the events.
        from ..core.workload_spec import WorkloadSpec
        if isinstance(trace, WorkloadSpec):
            trace = trace.materialize(eager=True)
        if trace.specs is None:
            raise ValueError(
                "ClusterSim needs an eager trace with AppSpecs; use "
                "generate_trace(...), spec.materialize(eager=True), or "
                "AppTable.to_trace() — or run the columnar engine "
                "(repro_torch.serving.cluster_vector) on the padded trace "
                "directly")
        # Merge all app invocation streams into one global event queue.
        events: List[Tuple[float, int, str]] = []
        for i, spec in enumerate(trace.specs):
            for t in trace.events(i):
                events.append((float(t) * MINUTE, i, spec.app_id))
        events.sort()

        n_apps = trace.n_apps
        cold = np.zeros(n_apps)
        inv = np.zeros(n_apps)
        lats: List[float] = []
        saved_state = None
        restored = False
        # `is not None`: checkpoint_at_minute=0.0 means "checkpoint at the
        # first event", not "no checkpoint" (a falsy check dropped it).
        ckpt_t = (self.cfg.checkpoint_at_minute * MINUTE
                  if self.cfg.checkpoint_at_minute is not None else None)
        hedge = self.cfg.hedge
        if hedge is not None:
            # One uniform pair per event, indexed by global arrival rank —
            # the same streams the vectorized engine consumes, so both
            # engines see identical stragglers.
            u1, u2 = hedge.event_uniforms(len(events))

        for rank, (t, idx, app_id) in enumerate(events):
            if ckpt_t is not None and t >= ckpt_t and saved_state is None:
                # controller checkpoint + simulated crash + restore
                saved_state = [p.state_dict() for p in self.pools]
                for p, sd in zip(self.pools, saved_state):
                    p.load_state_dict(sd)
                restored = True
            w = self._worker_for(app_id)
            pool = self.pools[w]
            was_cold, start_lat = pool.on_request(app_id, t)
            inv[idx] += 1
            cold[idx] += was_cold
            exec_s = (exec_time_s or {}).get(
                app_id, trace.specs[idx].exec_time_s)
            if hedge is not None:
                exec_s = float(hedge.latency_from_uniforms(
                    exec_s, u1[rank], u2[rank]))
            lats.append(start_lat + exec_s)
            pool.on_request_end(app_id, t + exec_s)

        end = trace.duration_minutes * MINUTE
        stats = [dataclasses.asdict(p.finalize(end)) for p in self.pools]
        wasted = sum(s["resident_byte_seconds"] for s in stats) / 1e9 / 60.0
        return ClusterResult(
            cold_pct_per_app=100.0 * cold / np.maximum(inv, 1),
            latencies_s=np.asarray(lats),
            wasted_gb_minutes=wasted,
            stats_per_worker=stats,
            restored_mid_run=restored,
        )
