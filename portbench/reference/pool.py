"""Plain replay of the warm pool's keep-alive rules, to hold the program's
verdicts and its loads and unloads to.

The rules, as the paper states them (§4) and the mix configures them: each
endpoint's image stays resident for a keep-alive window after a request
ends, or is unloaded at once and loaded again (a pre-warm) shortly before
the next request is predicted. A request that finds its image resident is
warm, else cold and it waits for a load. Requests take no virtual time:
each ends at its arrival.

  * ``fixed``: no pre-warm, a constant keep-alive (minutes);
  * ``hybrid`` (without the ARIMA branch): a histogram of each endpoint's
    idle times in ``bin_minutes`` bins over ``range_minutes`` (later ones
    out of bounds). Fewer than ``min_samples`` idle times, mostly out of
    bounds, or bin counts whose coefficient of variation is below
    ``cv_threshold``: the standard window (no pre-warm, keep-alive the
    range). Otherwise the pre-warm is the lower edge of the
    ``head_percentile`` bin times ``1 - margin`` and the image stays until
    the upper edge of the ``tail_percentile`` bin (at most the range) times
    ``1 + margin``. The decision values are float32, as the configuration
    states its policy (counts exact, the percentile bins the first whose
    count reaches ``pct / 100`` of the idle times in bounds, at least one).

At every request the invoker expires keep-alives and fires due pre-warms,
then serves the request, then applies the window; after each of those
three steps the set of resident images is what the engine must hold.
Under a memory budget a load evicts the resident images whose keep-alive
ends soonest (never the one being served). Endpoints are named by their
index; ties go to the lower index.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["replay"]

INF = float("inf")
Action = Tuple[int, str, int, str]        # (request, step, endpoint, verb)


class _Hist:
    def __init__(self, p: dict):
        self.p = p
        self.n_bins = int(round(p["range_minutes"] / p["bin_minutes"]))
        self.counts = np.zeros(self.n_bins, np.int64)
        self.oob = 0

    def record(self, it: float) -> None:
        b = math.floor(it / self.p["bin_minutes"])
        if b >= self.n_bins:
            self.oob += 1
        elif b >= 0:
            self.counts[b] += 1

    def windows(self) -> Tuple[float, float]:
        """(load_at, unload_at) in minutes after a request's end."""
        p, f = self.p, np.float32
        standard = (0.0, float(p["range_minutes"]))
        total = int(self.counts.sum())
        seen = total + self.oob
        if seen < p["min_samples"] or total == 0:
            return standard
        if f(self.oob) > f(p["oob_fraction_threshold"]) * f(max(seen, 1)):
            return standard
        mean = f(total) / f(self.n_bins)
        var = f(float((self.counts ** 2).sum())) / f(self.n_bins) \
            - mean * mean
        cv = np.sqrt(max(var, f(0.0))) / max(mean, f(1e-9))
        if not cv >= f(p["cv_threshold"]):
            return standard
        cum = np.cumsum(self.counts)

        def first_bin(pct):
            # the percentile in hundredths of a percent, so the count it
            # needs is exact
            need = max(-(-total * int(round(pct * 100)) // 10_000), 1)
            return int(np.searchsorted(cum, need, side="left"))

        head = f(first_bin(p["head_percentile"]))
        tail = f(first_bin(p["tail_percentile"]) + 1)
        lo, hi = f(1.0 - p["margin"]), f(1.0 + p["margin"])
        bin_m, range_m = f(p["bin_minutes"]), f(p["range_minutes"])
        load_at = head * bin_m * lo
        unload_at = max(min(tail * bin_m, range_m) * hi, load_at)
        return float(load_at), float(unload_at)


def replay(arrivals: Sequence[Tuple[int, float]], n_endpoints: int,
           policy: dict, image_bytes: Sequence[float], budget: float
           ) -> Tuple[List[bool], List[Action]]:
    """Replay requests ``(endpoint, arrival seconds)`` in order: each one's
    cold verdict, and every load and unload as ``(request, step, endpoint,
    "load" | "unload")`` with step ``tick``, ``request`` or ``end``."""
    if policy["kind"] == "hybrid" and policy.get("use_arima", True):
        raise NotImplementedError("the replay holds no ARIMA forecaster")
    resident = [False] * n_endpoints
    unload_at = [INF] * n_endpoints
    prewarm_at = [INF] * n_endpoints
    last_end: List[Optional[float]] = [None] * n_endpoints
    hist: Dict[int, _Hist] = {}
    keep: Dict[int, float] = {}
    pinned = [False] * n_endpoints
    seen: List[int] = []                      # endpoints in first-seen order

    def standard_keep() -> float:
        return float(policy["keep_alive_minutes"]) if policy["kind"] == \
            "fixed" else float(policy["range_minutes"])

    def load(e: int) -> None:
        used = sum(b for b, r in zip(image_bytes, resident) if r)
        if used + image_bytes[e] > budget:
            victims = sorted((unload_at[a], a) for a in seen
                             if resident[a] and not pinned[a] and a != e)
            for _, a in victims:
                if used + image_bytes[e] <= budget:
                    break
                resident[a] = False
                unload_at[a] = INF
                used -= image_bytes[a]
        resident[e] = True

    def tick(now: float) -> None:
        for e in seen:
            if resident[e] and now >= unload_at[e]:
                resident[e] = False
                unload_at[e] = INF
        due = sorted((prewarm_at[e], e) for e in seen
                     if not resident[e] and now >= prewarm_at[e])
        for _, e in due:
            load(e)
            prewarm_at[e] = INF
            unload_at[e] = now + keep.get(e, standard_keep()) * 60.0

    colds: List[bool] = []
    actions: List[Action] = []

    def step(i: int, name: str, before: List[bool]) -> None:
        for e in range(n_endpoints):
            if resident[e] != before[e]:
                actions.append((i, name, e,
                                "load" if resident[e] else "unload"))

    for i, (e, now) in enumerate(arrivals):
        if e not in seen:
            seen.append(e)
        before = list(resident)
        tick(now)
        step(i, "tick", before)
        before = list(resident)
        tick(now)
        colds.append(not resident[e])
        if not resident[e]:
            load(e)
        prewarm_at[e] = unload_at[e] = INF
        pinned[e] = True
        step(i, "request", before)
        before = list(resident)
        idle = None if last_end[e] is None else now / 60.0 - last_end[e] / 60.0
        last_end[e] = now
        pinned[e] = False
        if policy["kind"] == "fixed":
            load_at, until = 0.0, float(policy["keep_alive_minutes"])
        else:
            h = hist.setdefault(e, _Hist(policy))
            if idle is not None and idle >= 0:
                h.record(idle)
            load_at, until = h.windows()
        keep[e] = until - load_at
        if load_at <= 0.0:
            unload_at[e] = now + until * 60.0
            prewarm_at[e] = INF
        else:
            resident[e] = False
            prewarm_at[e] = now + load_at * 60.0
            unload_at[e] = INF
        step(i, "end", before)
    return colds, actions
