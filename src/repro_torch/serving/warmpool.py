"""Warm pool: the paper's hybrid histogram policy managing HBM residency.

This is the OpenWhisk-Invoker analog: instead of Docker containers it
manages *model images* (weights) in device memory. The policy decides, per
endpoint:

  * when to UNLOAD after a request finishes (pre-warming window > 0 means
    unload immediately and reload later);
  * when to PRE-WARM (load ahead of the predicted next request);
  * how long to KEEP ALIVE after the (re)load.

All in virtual time (the caller drives `now`); the caller mirrors the
pool's decisions onto the real engine (``ServeEngine.load``/``unload``).
Memory-budget pressure evicts the app whose keep-alive expires soonest (the
policy's own estimate of "least likely to be needed"); apps pinned
mid-request are never victims, and a load that cannot fit even after
evicting everything evictable proceeds over budget but is counted
(``PoolStats.budget_overflows``). The port of
``repro/serving/warmpool.py`` (pure Python, the same logic).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, Optional, Tuple

from ..core import policy_math
from ..core.policy import Policy, PolicyWindows
from .registry import Registry
from .spans import span

MINUTE = 60.0


@dataclasses.dataclass
class AppState:
    loaded: bool = False
    compile_cached: bool = False
    pinned: bool = False            # mid-request: never an eviction victim
    last_end: float = -1.0          # end of last request (s)
    unload_at: float = float("inf")  # keep-alive expiry (s)
    prewarm_at: float = float("inf")  # scheduled pre-warm (s)
    windows: Optional[PolicyWindows] = None
    cold_starts: int = 0
    requests: int = 0
    loaded_since: float = 0.0
    resident_seconds: float = 0.0   # accumulated memory time
    bytes_loaded: int = 0


@dataclasses.dataclass
class PoolStats:
    cold_starts: int = 0
    warm_starts: int = 0
    prewarms: int = 0
    unloads: int = 0
    evictions: int = 0
    budget_overflows: int = 0       # loads that proceeded over budget
    bytes_moved: float = 0.0
    resident_byte_seconds: float = 0.0


class WarmPool:
    def __init__(self, registry: Registry, policy,
                 budget_bytes: float = float("inf")):
        # ``policy`` may be a stateful Policy or a declarative PolicySpec
        # (repro.core.experiment) — the same specs the simulators sweep.
        if not isinstance(policy, Policy) and hasattr(policy, "build"):
            policy = policy.build()
        for ep in registry:
            if ep.weight_bytes > budget_bytes:
                raise ValueError(
                    f"endpoint {ep.app_id!r} needs {ep.weight_bytes} bytes "
                    f"but the HBM budget is {budget_bytes:.0f}: a single "
                    f"image larger than the budget can never fit (evicting "
                    f"everything still leaves the pool over budget forever)")
        self.registry = registry
        self.policy = policy
        self.budget = budget_bytes
        self.state: Dict[str, AppState] = {}
        self.stats = PoolStats()
        self._used = 0.0

    # -- residency bookkeeping ------------------------------------------------

    def _st(self, app_id: str) -> AppState:
        if app_id not in self.state:
            self.state[app_id] = AppState()
        return self.state[app_id]

    def _load(self, app_id: str, now: float) -> float:
        """Load an image; returns the latency paid (0 if already loaded)."""
        st = self._st(app_id)
        if st.loaded:
            return 0.0
        ep = self.registry.get(app_id)
        self._ensure_budget(ep.weight_bytes, now, exclude=app_id)
        lat = ep.cold_start_seconds(st.compile_cached)
        st.loaded = True
        st.compile_cached = True
        st.loaded_since = now
        st.bytes_loaded = ep.weight_bytes
        self._used += ep.weight_bytes
        self.stats.bytes_moved += ep.weight_bytes
        return lat

    def _unload(self, app_id: str, now: float) -> None:
        st = self._st(app_id)
        if not st.loaded:
            return
        st.loaded = False
        dt = max(now - st.loaded_since, 0.0)
        st.resident_seconds += dt
        self.stats.resident_byte_seconds += dt * st.bytes_loaded
        self._used -= st.bytes_loaded
        st.unload_at = float("inf")
        self.stats.unloads += 1

    def _ensure_budget(self, need: float, now: float, exclude: str) -> None:
        if self._used + need <= self.budget:
            return
        # Evict loaded apps in order of soonest keep-alive expiry. Pinned
        # (mid-request) apps are never candidates: their ``unload_at`` is
        # inf while they execute, which used to make them indistinguishable
        # from never-unload apps and thus evictable by a concurrent
        # pre-warm's budget pass.
        candidates = [(st.unload_at, app) for app, st in self.state.items()
                      if st.loaded and not st.pinned and app != exclude]
        heapq.heapify(candidates)
        while candidates and self._used + need > self.budget:
            _, app = heapq.heappop(candidates)
            self._unload(app, now)
            self.stats.evictions += 1
        if self._used + need > self.budget:
            # Nothing evictable is left and the load still does not fit:
            # the pool proceeds over budget (the load must happen), but no
            # longer silently — overflows are counted in ``stats``.
            self.stats.budget_overflows += 1

    # -- the policy surface ---------------------------------------------------

    def tick(self, now: float) -> None:
        """Advance virtual time: expire keep-alives, then fire pre-warms.

        Iterates over a snapshot: a pre-warm ``_load`` can trigger
        ``_ensure_budget`` evictions that mutate other apps' states, so the
        pass must not interleave with live dict iteration. All keep-alive
        expiries are processed first (freeing memory that is rightfully free
        at ``now``, so pre-warms do not force spurious evictions), then due
        pre-warms fire in scheduled-time order.
        """
        with span("pool.tick"):
            items = list(self.state.items())
            for app_id, st in items:
                if st.loaded and now >= st.unload_at:
                    self._unload(app_id, now)
            due = [(st.prewarm_at, app_id, st) for app_id, st in items
                   if not st.loaded and now >= st.prewarm_at]
            for _, app_id, st in sorted(due, key=lambda d: (d[0], d[1])):
                self._load(app_id, now)
                st.prewarm_at = float("inf")
                w = st.windows or self.policy.windows(app_id)
                st.unload_at = now + w.keep_alive * MINUTE
                self.stats.prewarms += 1

    def on_request(self, app_id: str, now: float) -> Tuple[bool, float]:
        """A request arrives. Returns (was_cold, startup_latency_s)."""
        with span("pool.on_request"):
            self.tick(now)
            st = self._st(app_id)
            st.requests += 1
            cold = not st.loaded
            lat = self._load(app_id, now) if cold else 0.0
            if cold:
                st.cold_starts += 1
                self.stats.cold_starts += 1
            else:
                self.stats.warm_starts += 1
            st.prewarm_at = float("inf")  # a real request supersedes pre-warm
            st.unload_at = float("inf")
            st.pinned = True              # pinned while executing
            return cold, lat

    def on_request_end(self, app_id: str, now: float) -> None:
        """Request finished: record IT, get fresh windows, schedule actions."""
        with span("pool.on_request_end"):
            st = self._st(app_id)
            # Computed as a difference of end-times-in-minutes (not a
            # difference of seconds divided by 60) so the scalar oracle sees
            # bit-identical idle values to the vectorized cluster engine,
            # which scans columns of end times already expressed in minutes.
            idle_min = ((now / MINUTE - st.last_end / MINUTE)
                        if st.last_end >= 0 else None)
            st.last_end = now
            st.pinned = False
            w = self.policy.on_invocation(app_id, idle_min)
            st.windows = w
            # The residency schedule comes from the same single-source
            # bounds the simulators use: resident on [load_at, unload_at]
            # from the gap start.
            load_at, unload_at = policy_math.window_bounds(w.prewarm,
                                                           w.keep_alive)
            if load_at <= 0.0:
                st.unload_at = now + float(unload_at) * MINUTE
                st.prewarm_at = float("inf")
            else:
                # unload now; reload right before the predicted arrival
                self._unload(app_id, now)
                st.prewarm_at = now + float(load_at) * MINUTE
                st.unload_at = float("inf")

    # -- reporting ------------------------------------------------------------

    def finalize(self, now: float) -> PoolStats:
        for app_id, st in list(self.state.items()):
            if st.loaded:
                self._unload(app_id, now)
        return self.stats

    # -- controller fault tolerance ------------------------------------------

    def state_dict(self) -> dict:
        policy_state = (self.policy.state_dict()
                        if hasattr(self.policy, "state_dict") else {})
        return {
            "policy": policy_state,
            "apps": {a: dataclasses.asdict(st) for a, st in self.state.items()},
            "used": self._used,
            "stats": dataclasses.asdict(self.stats),
        }

    def load_state_dict(self, sd: dict) -> None:
        if sd.get("policy") and hasattr(self.policy, "load_state_dict"):
            self.policy.load_state_dict(sd["policy"])
        self.state = {}
        for a, d in sd["apps"].items():
            w = d.pop("windows", None)
            st = AppState(**{k: v for k, v in d.items() if k != "windows"})
            if w:
                st.windows = (PolicyWindows(**w) if isinstance(w, dict)
                              else PolicyWindows(*w))
            self.state[a] = st
        self._used = sd["used"]
        self.stats = PoolStats(**sd["stats"])
