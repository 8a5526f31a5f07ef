"""Request scheduler: admission, per-endpoint queues, continuous batching.

Sits between the trace/front door and the engine: requests for the same
endpoint are batched (decode steps run one batched `serve_step` across all
active sequences of that endpoint — continuous batching), subject to a
max batch size and a queueing delay budget. Cold endpoints are routed
through the warm pool first; the scheduler exposes the arrival events the
policy needs (`on_request` / `on_request_end`).

Fleet-level placement (which worker's scheduler a request reaches) lives
one layer up, in the cluster engines: the per-event oracle
(:mod:`repro_torch.serving.cluster_sim`) and the columnar engine
(:mod:`repro_torch.serving.cluster_vector`), both driven by the balancing
modes on :class:`repro_torch.serving.cluster_vector.ClusterSpec`. The port
of ``repro/serving/scheduler.py``: pure Python over the port's
:class:`~repro_torch.serving.warmpool.WarmPool`, in virtual time, with no
role on the card.
"""
from __future__ import annotations

import dataclasses
import heapq
from collections import defaultdict, deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

from .warmpool import WarmPool

__all__ = ["Request", "SchedulerConfig", "Scheduler"]


@dataclasses.dataclass
class Request:
    app_id: str
    arrival_s: float
    exec_s: float                 # service demand once running
    id: int = 0
    start_s: float = -1.0
    finish_s: float = -1.0

    @property
    def latency(self) -> float:
        return self.finish_s - self.arrival_s


@dataclasses.dataclass
class SchedulerConfig:
    max_batch: int = 8            # continuous-batching width per endpoint
    batch_wait_s: float = 0.005   # max time to hold a request for batching
    batch_efficiency: float = 0.85  # batched step cost vs sum of singles


class Scheduler:
    """Discrete-event scheduler over one worker's endpoints."""

    def __init__(self, pool: WarmPool, cfg: SchedulerConfig = SchedulerConfig()):
        self.pool = pool
        self.cfg = cfg
        self.queues: Dict[str, Deque[Request]] = defaultdict(deque)
        self.busy_until: Dict[str, float] = defaultdict(float)
        self.completed: List[Request] = []
        self._next_id = 0

    def submit(self, app_id: str, arrival_s: float, exec_s: float) -> Request:
        r = Request(app_id=app_id, arrival_s=arrival_s, exec_s=exec_s,
                    id=self._next_id)
        self._next_id += 1
        self.queues[app_id].append(r)
        return r

    def _drain_endpoint(self, app_id: str, now: float) -> float:
        """Run queued requests for one endpoint in batches; returns the time
        the endpoint becomes idle."""
        q = self.queues[app_id]
        t = max(now, self.busy_until[app_id])
        while q:
            batch = []
            while q and len(batch) < self.cfg.max_batch:
                batch.append(q.popleft())
            was_cold, startup = self.pool.on_request(app_id, t)
            # batched execution: dominated by the longest member, padded by
            # the batching efficiency factor
            span = max(r.exec_s for r in batch) * (
                1.0 + self.cfg.batch_efficiency * (len(batch) - 1)
                / max(len(batch), 1))
            start = t + startup + self.cfg.batch_wait_s
            for r in batch:
                r.start_s = start
                r.finish_s = start + span
                self.completed.append(r)
            t = start + span
            self.pool.on_request_end(app_id, t)
        self.busy_until[app_id] = t
        return t

    def run(self, events: List[Tuple[float, str, float]]) -> List[Request]:
        """events: sorted (arrival_s, app_id, exec_s). Returns completions.

        Arrivals within ``batch_wait_s`` of each other are admitted together
        before their endpoints drain — this is what forms decode batches.
        """
        i = 0
        n = len(events)
        while i < n:
            t0 = events[i][0]
            touched = []
            while i < n and events[i][0] <= t0 + self.cfg.batch_wait_s:
                arrival, app_id, exec_s = events[i]
                self.submit(app_id, arrival, exec_s)
                touched.append(app_id)
                i += 1
            for app_id in dict.fromkeys(touched):
                self._drain_endpoint(app_id, t0)
        return self.completed
