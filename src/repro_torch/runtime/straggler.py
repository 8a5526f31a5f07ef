"""Straggler mitigation: hedged requests.

At scale some workers run slow (background compaction, thermal throttling,
failing HBM). The standard mitigation is to hedge: if a request has not
completed by a multiple of its expected time, fire a backup on another
worker and take whichever finishes first. This module models that policy
for the cluster simulators. The port of ``repro/runtime/straggler.py``
(numpy only, the same formulas and the same seeded uniform streams).
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["HedgePolicy"]


@dataclasses.dataclass
class HedgePolicy:
    straggler_prob: float = 0.03     # fraction of executions that straggle
    straggler_factor: float = 8.0    # slowdown multiplier when straggling
    hedge_after_factor: float = 2.0  # hedge when t > factor * expected
    enabled: bool = True

    def effective_latency(self, exec_s: float, rng: np.random.Generator
                          ) -> float:
        straggled = rng.uniform() < self.straggler_prob
        primary = exec_s * (self.straggler_factor if straggled else 1.0)
        if not self.enabled or not straggled:
            return primary
        # The backup fires once the request exceeds the hedge threshold;
        # the backup itself may straggle (independently).
        hedge_at = exec_s * self.hedge_after_factor
        backup_straggle = rng.uniform() < self.straggler_prob
        backup = hedge_at + exec_s * (self.straggler_factor
                                      if backup_straggle else 1.0)
        return min(primary, backup)

    def latency_from_uniforms(self, exec_s, u1, u2):
        """The hedged-latency formula over pre-drawn uniforms.

        Both cluster engines draw ``u1``/``u2`` up front (one pair per
        event, indexed by global arrival rank) and evaluate this formula,
        so the scalar oracle and the vectorized engine see the same
        stragglers whatever their evaluation order. Scalars or arrays."""
        straggled = u1 < self.straggler_prob
        primary = exec_s * np.where(straggled, self.straggler_factor, 1.0)
        if not self.enabled:
            return primary
        backup = exec_s * self.hedge_after_factor + exec_s * np.where(
            u2 < self.straggler_prob, self.straggler_factor, 1.0)
        return np.where(straggled, np.minimum(primary, backup), primary)

    def event_uniforms(self, n_events: int):
        """The shared per-event uniform streams (seeded, engine-agnostic)."""
        rng = np.random.default_rng(0)
        return rng.uniform(size=n_events), rng.uniform(size=n_events)
