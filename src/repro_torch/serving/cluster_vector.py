"""Vectorized fleet-scale cluster engine (the columnar ClusterSim).

The per-event oracle in :mod:`repro_torch.serving.cluster_sim` replays one
global heap-merged event stream through per-worker warm pools: exact, but
about 10^3-10^5 events/s of pure Python. This module computes the *same
trajectory* from the columnar :class:`~repro_torch.serving.apptable.AppTable`
in four passes. The port of ``repro/serving/cluster_vector.py``; phases A,
C and D are the reference's host numpy, phase B runs on ``device``.

  A. **Merged events.** Flatten the padded time frame to one event list,
     rank it by the oracle's ``(t, app_idx)`` sort, and draw the shared
     per-rank hedging uniforms so both engines see identical stragglers.

  B. **Policy windows.** The windows an app's pool consults after event
     ``k`` depend only on that app's end-time column, not on warm/cold
     outcomes, so stepping the policy over the end-time columns yields
     every per-gap residency bound up front (float64 minutes). The hybrid
     policy steps through
     :func:`repro_torch.forecast.replay._scan_window_sequences`: the CUDA
     sweep-step kernel once per event column of each chunk on the card
     (its plain version on the CPU), the rescan the forecast post-pass
     already holds to the scalar policy; with ``use_arima`` the rows that
     consult the forecaster get their forecast windows from the same
     post-pass (one batched fit). SPES steps through
     :func:`repro_torch.core.simulator._spes_states` (plain PyTorch).

  C. **Gap replay.** With windows known, each inter-arrival gap closes in
     closed form: keep-alive expiries and pre-warm fires happen at the
     first *worker tick* (any arrival on that worker) past the scheduled
     time, found with one exact float64 ``searchsorted`` per worker. Cold
     verdicts, loads/unloads, residency time, latency and per-worker stats
     fall out as segmented reductions.

  D. **HBM evictions to a fixed point.** Workers whose assigned image
     bytes exceed the budget (a cheap pessimistic screen; every other
     worker skips this phase) replay their occupancy in the oracle's
     processing order: one op list (expiries, pre-warm fires, request
     loads, end-of-request unloads, phase-ordered as ``WarmPool.tick`` /
     ``on_request`` interleave them) whose running cumsum exposes every
     over-budget load. Each violation is resolved the way
     ``WarmPool._ensure_budget`` would (evict resident, unpinned apps in
     ``(unload_at, app_id)`` order until the load fits), the occupancy is
     patched in place (an eviction removes residency only between the
     eviction and the victim's next arrival, which flips cold) and the
     scan resumes forward.

Exactness contract (``tests/test_torch_cluster_conformance.py``): cold
counts, per-app cold %, latencies and every load/unload/prewarm/eviction
counter are bit-identical to the oracle, on oversubscribed fleets too;
resident byte-seconds agree to float64 accumulation-order tolerance. A
``max_eviction_rounds`` cap bounds the fixed-point work; past it the front
door falls back to ``engine="scalar"`` with a warning. Like the oracle's
``WarmPool``, a single image larger than the per-worker budget is refused.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..core.experiment import (FixedSpec, HybridSpec, NoUnloadSpec,
                               PolicySpec, SpesSpec, as_spec)
from ..core.simulator import (DEFAULT_APP_CHUNK, _chunk_stream,
                              _chunked_buckets, _host_rows, _on_mesh,
                              _spes_knobs, _spes_states)
from ..core.workload import Trace
from ..core.workload_spec import WorkloadSpec
from ..device import resolve_device
from ..distributed.scaleout import mesh_for
from ..runtime.straggler import HedgePolicy
from .apptable import AppTable
from .cluster_sim import MINUTE, ClusterConfig, ClusterResult, ClusterSim
from .registry import (BASE_LOAD_LATENCY, COMPILE_MISS_LATENCY,
                       H2D_BANDWIDTH)

__all__ = ["CLUSTER_ENGINES", "ClusterSpec", "ClusterSweep",
           "EvictionRoundsExceeded", "PHASE_SECONDS", "as_table",
           "run_cluster", "sweep_cluster"]

CLUSTER_ENGINES = ("auto", "vector", "scalar")

#: Host seconds of the last vectorized run, by part: ``table`` (the
#: workload to an AppTable), ``A``-``D`` (the phases; ``B`` ends with the
#: bounds back on the host, so it includes the device work) and ``results``.
PHASE_SECONDS: Dict[str, float] = {}


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """Declarative cluster shape: the third axis of an experiment grid.

    Mirrors :class:`~repro_torch.serving.cluster_sim.ClusterConfig` knob
    for knob (same defaults) as a frozen spec, so ``trace x policy x
    cluster`` grids compose through ``experiment.run(..., cluster=...)``
    and ``experiment.sweep(..., clusters=[...])``.
    """
    n_workers: int = 18
    hbm_budget_bytes: float = 16e9
    balancing: str = "affinity"          # "affinity" | "hash"
    hedge: Optional[HedgePolicy] = None
    checkpoint_at_minute: Optional[float] = None
    label: Optional[str] = None

    @property
    def name(self) -> str:
        return self.label or f"{self.balancing}-{self.n_workers}w"

    def validate(self) -> None:
        if self.n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {self.n_workers}")
        if self.balancing not in ("affinity", "hash"):
            raise ValueError(f"unknown balancing {self.balancing!r}; "
                             "use 'affinity' or 'hash'")

    def to_config(self) -> ClusterConfig:
        """The oracle's mutable config (the ``engine="scalar"`` bridge)."""
        return ClusterConfig(
            n_workers=self.n_workers, hbm_budget_bytes=self.hbm_budget_bytes,
            hedge=self.hedge, checkpoint_at_minute=self.checkpoint_at_minute,
            balancing=self.balancing)


def as_table(workload, *, exec_s=None, memory_mb=None,
             weight_bytes=None) -> AppTable:
    """Coerce the workload axis: AppTable passes through, WorkloadSpec and
    Trace are converted columnar."""
    if isinstance(workload, AppTable):
        return workload
    if isinstance(workload, WorkloadSpec):
        return AppTable.from_spec(workload, exec_s=exec_s,
                                  memory_mb=memory_mb,
                                  weight_bytes=weight_bytes)
    if isinstance(workload, Trace):
        return AppTable.from_trace(workload, exec_s=exec_s,
                                   memory_mb=memory_mb,
                                   weight_bytes=weight_bytes)
    raise TypeError(f"expected an AppTable, WorkloadSpec or Trace, "
                    f"got {type(workload).__name__}")


# --------------------------------------------------------------------------
# Phase B: per-gap policy windows from the end-time columns
# --------------------------------------------------------------------------


def _spes_bounds(cols: torch.Tensor, knobs):
    """The SPES step's (load, unload) bounds after each event column of
    ``cols`` [width, n], two [width, n] tensors."""
    load = torch.empty_like(cols)
    unload = torch.empty_like(cols)
    for t, state in enumerate(_spes_states(cols, knobs)):
        load[t], unload[t] = state[4][0], state[5][0]
    return load, unload


def _spes_windows(e_min2d: np.ndarray, counts: np.ndarray, cfg,
                  app_chunk: int, device: torch.device, la: np.ndarray,
                  ua: np.ndarray, mesh=None) -> None:
    """The SPES step's bounds decided at each event, written into
    ``la``/``ua`` [n, M] in place (float64); ``mesh`` splits the app rows
    across devices."""
    knobs = _spes_knobs([cfg], device)
    work = _chunked_buckets(e_min2d, counts, app_chunk)
    bounds = _on_mesh(_spes_bounds, mesh, (1, None))
    for sel, cols in _chunk_stream(work, device, mesh):
        load, unload = _host_rows(bounds(cols, knobs), len(sel))
        width = load.shape[0]
        la[sel, :width] = load.T
        ua[sel, :width] = unload.T


def _policy_windows(spec: PolicySpec, e_min2d: np.ndarray,
                    counts: np.ndarray, app_chunk: int,
                    device: torch.device, mesh=None):
    """(load_at, unload_at, keep_alive) bounds [n, M] decided after each
    event, float64 minutes past the execution end.

    ``load_at``/``unload_at`` are exactly the values
    ``policy_math.window_bounds`` hands the oracle's warm pool (float32
    window values widen exactly); ``keep_alive`` is what a pre-warm fire
    keeps the image for: their float64 difference, which is how
    ``AppHistogram.windows`` defines it, or the forecast's own keep-alive
    where the forecaster decided the window. ``mesh`` splits the scans'
    app rows across devices; the forecast fit runs on ``device``.
    """
    n, m_ev = e_min2d.shape
    la = np.zeros((n, m_ev))
    ua = np.zeros((n, m_ev))
    if isinstance(spec, NoUnloadSpec):
        ua[:] = np.inf
        return la, ua, ua - la
    if isinstance(spec, FixedSpec):
        ua[:] = float(spec.keep_alive)
        return la, ua, ua - la
    if isinstance(spec, SpesSpec):
        cfg = spec.to_config()
        ua[:] = cfg.standard_keep_alive    # zero-event rows: never read
        _spes_windows(e_min2d, counts, cfg, app_chunk, device, la, ua,
                      mesh)
        return la, ua, ua - la
    if not isinstance(spec, HybridSpec):
        raise TypeError(
            f"the vectorized cluster engine needs a declarative PolicySpec "
            f"(Fixed/NoUnload/Hybrid/Spes), got {type(spec).__name__}; "
            f"arbitrary Policy objects run on engine='scalar'")

    # The rescan of the forecast post-pass, over every app: one step
    # launch per event column of each chunk on the card, each event's
    # bounds and the flag "the scalar policy consults the forecaster here"
    # (a subset of the rows whose OOB counter was ever heavy, which the
    # reference rescans).
    from ..forecast.replay import (_apply_forecast_overrides,
                                   _scan_window_sequences)
    hybrid = spec.to_config()
    la, ua, branch = _scan_window_sequences(e_min2d, counts, hybrid,
                                            app_chunk, device, True, mesh)
    keep = ua - la
    if hybrid.use_arima:
        _apply_forecast_overrides(e_min2d, counts, hybrid, la, ua, branch,
                                  device, keep)
    return la, ua, keep


# --------------------------------------------------------------------------
# Phase C: closed-form gap replay
# --------------------------------------------------------------------------


def _first_tick_ge(ticks_by_w, woff, tick_src, worker_q, thr_q):
    """First worker tick at time >= threshold, per query.

    ``ticks_by_w`` holds every arrival time grouped by worker (sorted within
    each group); a keep-alive expiry or pre-warm only *happens* when some
    event on that worker ticks the pool. Returns ``(time, flat_idx)`` with
    ``(inf, -1)`` when no tick qualifies. Queries are grouped by worker so
    each group is one exact float64 ``searchsorted`` — no scaled-offset key
    tricks that could round two distinct times together.
    """
    q_order = np.argsort(worker_q, kind="stable")
    wq = worker_q[q_order]
    tq = thr_q[q_order]
    n_workers = len(woff) - 1
    qoff = np.zeros(n_workers + 1, np.int64)
    np.cumsum(np.bincount(wq, minlength=n_workers), out=qoff[1:])
    t_sorted = np.full(tq.shape, np.inf)
    i_sorted = np.full(tq.shape, -1, np.int64)
    for w in range(n_workers):
        a, b = qoff[w], qoff[w + 1]
        if b == a:
            continue
        seg = ticks_by_w[woff[w]:woff[w + 1]]
        if not len(seg):
            continue
        pos = np.searchsorted(seg, tq[a:b], side="left")
        ok = pos < len(seg)
        pos_c = np.minimum(pos, len(seg) - 1)
        t_sorted[a:b] = np.where(ok, seg[pos_c], np.inf)
        i_sorted[a:b] = np.where(ok, tick_src[woff[w] + pos_c], -1)
    t_out = np.empty_like(t_sorted)
    i_out = np.empty_like(i_sorted)
    t_out[q_order] = t_sorted
    i_out[q_order] = i_sorted
    return t_out, i_out


class EvictionRoundsExceeded(RuntimeError):
    """The eviction fixed point ran past ``max_eviction_rounds``.

    Raised by the worker replay; :func:`run_cluster` catches it and falls
    back to ``engine="scalar"`` with a warning rather than spinning (or
    silently diverging from) the oracle's sequential eviction cascade.
    """


def _app_tie_ranks(table: AppTable) -> np.ndarray:
    """Eviction tie-break keys matching the oracle's heap order.

    ``WarmPool._ensure_budget`` pops ``(unload_at, app_id)`` tuples, so
    equal expiries tie-break on the app-id *string*. Canonical
    ``app-%06d`` ids compare in index order while they are 6 digits wide;
    wider fleets (and explicit non-canonical ids) get their true
    lexicographic rank.
    """
    n = table.n_apps
    if table.app_ids is not None:
        ids = np.asarray(table.app_ids)
    elif n > 1_000_000:          # "app-1000000" sorts before "app-999999"
        ids = np.array([table.app_id(i) for i in range(n)])
    else:
        return np.arange(n, dtype=np.int64)
    ranks = np.empty(n, np.int64)
    ranks[np.argsort(ids)] = np.arange(n)
    return ranks


def _evict_worker(j_idx, budget, *, rows, rank, t_by_rank, wb, tie, cold,
                  stay, pre, fired, need_u, need_f, ui_stay, ui_fire,
                  tau_i, u_stay, q_fire, p_pre, max_rounds):
    """Exact HBM-eviction replay for one worker (phase D).

    ``j_idx`` holds the worker's flat event indices in ``(app, k)`` order;
    every other array is global flat-event state from the gap replay. The
    worker's memory ops are laid out in the oracle's processing order —
    per event rank, keep-alive expiries (phase 0), then pre-warm fires
    ordered by ``(prewarm_at, app_id)`` (phase 1), then the request load
    (phase 2), then the end-of-request unload (phase 3) — and the running
    occupancy cumsum is scanned for over-budget loads. Each violation is
    resolved like ``WarmPool._ensure_budget``: resident spans covering the
    violation are candidates, evicted in ``(unload_at, app_id)`` order
    until the load fits (or counted as a budget overflow when nothing
    evictable remains). An eviction removes the victim's occupancy only
    between the violation and the victim's next scheduled end — its next
    arrival (flipped to a cold load, in-place in ``cold``) or scheduled
    expiry — so the patch is a slice subtraction and the scan resumes
    forward; positions are monotone, so each ``_ensure_budget`` call is
    resolved exactly once.

    Returns ``(evicted_local, evict_time_local, overflows, rounds)``.
    """
    E = len(j_idx)
    app = rows[j_idx]
    w_b = wb[j_idx].astype(np.float64)
    g_tie = tie[app]
    step = rank[j_idx]
    st_g, pre_g, fired_g = stay[j_idx], pre[j_idx], fired[j_idx]
    nu_g, nf_g = need_u[j_idx], need_f[j_idx]

    # ---- op table (unsorted layout: expiries | fires | slots | ends) ----
    ui_g = np.where(st_g, ui_stay[j_idx], ui_fire[j_idx])
    g_exp = np.nonzero((nu_g | nf_g) & (ui_g >= 0))[0]
    g_fire = np.nonzero(fired_g)[0]
    g_end = np.nonzero(pre_g)[0]
    n_exp, n_fire, n_end = len(g_exp), len(g_fire), len(g_end)
    slot0 = n_exp + n_fire
    N = slot0 + E + n_end

    op_gap = np.concatenate([g_exp, g_fire, np.arange(E), g_end])
    op_step = np.concatenate([rank[ui_g[g_exp]], rank[tau_i[j_idx[g_fire]]],
                              step, step[g_end]])
    op_phase = np.concatenate([np.zeros(n_exp, np.int8),
                               np.ones(n_fire, np.int8),
                               np.full(E, 2, np.int8),
                               np.full(n_end, 3, np.int8)])
    op_sub1 = np.zeros(N)
    op_sub1[n_exp:slot0] = p_pre[j_idx[g_fire]]
    op_sub2 = np.zeros(N, np.int64)
    op_sub2[n_exp:slot0] = g_tie[g_fire]
    op_delta = np.concatenate([-w_b[g_exp], w_b[g_fire],
                               w_b * cold[j_idx], -w_b[g_end]])
    op_need = np.concatenate([np.zeros(n_exp), w_b[g_fire], w_b,
                              np.zeros(n_end)])
    op_check = np.concatenate([np.zeros(n_exp, bool), np.ones(n_fire, bool),
                               cold[j_idx].copy(), np.zeros(n_end, bool)])

    srt = np.lexsort((op_sub2, op_sub1, op_phase, op_step))
    pos_of = np.empty(N, np.int64)
    pos_of[srt] = np.arange(N)
    slot_pos = pos_of[slot0:slot0 + E]
    fire_pos = np.full(E, -1, np.int64)
    fire_pos[g_fire] = pos_of[n_exp:slot0]
    exp_pos = np.full(E, -1, np.int64)
    exp_pos[g_exp] = pos_of[:n_exp]

    occ = np.cumsum(op_delta[srt])
    check_s = op_check[srt]
    need_s = op_need[srt]
    gap_s = op_gap[srt]
    step_s = op_step[srt]

    # ---- resident spans per gap, in op positions -----------------------
    active = st_g | fired_g
    span_start = np.where(st_g, slot_pos, fire_pos)
    has_sched = np.where(st_g, nu_g, nf_g)
    span_end = np.full(E, N, np.int64)          # scheduled end at run end
    found = active & has_sched & (exp_pos >= 0)
    span_end[found] = exp_pos[found]
    warm_cont = active & ~has_sched             # continues into next event
    if warm_cont.any():
        g_nxt = np.searchsorted(j_idx, j_idx[warm_cont] + 1)
        span_end[warm_cont] = slot_pos[g_nxt]
    u_time = np.where(st_g, u_stay[j_idx], q_fire[j_idx])

    # ---- scan + resolve ------------------------------------------------
    evicted = np.zeros(E, bool)
    evict_t = np.zeros(E)
    overflows = 0
    rounds = 0
    s = 0
    while s < N:
        seg = check_s[s:] & (occ[s:] > budget)
        rel = int(np.argmax(seg))
        if not seg[rel]:
            break
        v = s + rel
        rounds += 1
        if rounds > max_rounds:
            raise EvictionRoundsExceeded(
                f"eviction fixed point exceeded max_eviction_rounds="
                f"{max_rounds} on one worker")
        a_v = app[gap_s[v]]
        t_v = t_by_rank[step_s[v]]
        need = need_s[v]
        used_before = occ[v] - need
        cand = np.nonzero(active & ~evicted & (span_start < v)
                          & (span_end > v) & (app != a_v))[0]
        if len(cand):
            cand = cand[np.lexsort((g_tie[cand], u_time[cand]))]
            freed = np.cumsum(w_b[cand])
            k = int(np.searchsorted(freed, used_before + need - budget,
                                    side="left")) + 1
            if k > len(cand):
                k = len(cand)
                overflows += 1
            victims = cand[:k]
        else:
            victims = cand
            overflows += 1
        for g_e in victims:
            evicted[g_e] = True
            evict_t[g_e] = t_v
            occ[v:span_end[g_e]] -= w_b[g_e]
            if warm_cont[g_e]:
                # The victim's next arrival finds the image gone: cold.
                j_n = j_idx[g_e] + 1
                cold[j_n] = True
                check_s[slot_pos[np.searchsorted(j_idx, j_n)]] = True
        s = v + 1
    return evicted, evict_t, overflows, rounds


def _run_vector(table: AppTable, spec: PolicySpec, cluster: ClusterSpec,
                app_chunk: int, device: torch.device,
                max_eviction_rounds: Optional[int] = None,
                mesh=None) -> ClusterResult:
    n = table.n_apps
    n_workers = cluster.n_workers
    counts = np.asarray(table.counts, np.int64)
    t_end = float(table.duration_minutes) * MINUTE

    budget = float(cluster.hbm_budget_bytes)
    if np.isfinite(budget) and n and table.weight_bytes.max() > budget:
        i_big = int(np.argmax(table.weight_bytes))
        raise ValueError(
            f"endpoint {table.app_id(i_big)!r} needs "
            f"{int(table.weight_bytes[i_big])} bytes but the HBM budget is "
            f"{budget:.0f}: a single image larger than the budget can "
            f"never fit (evicting everything still leaves the pool over "
            f"budget forever)")

    # ---- Phase A: the merged event stream -------------------------------
    # repro-lint: ignore[nondeterminism] -- PHASE_SECONDS times the
    # engine's phases for the chip run's breakdown; no result reads it
    t0 = time.perf_counter()
    m_ev = table.times.shape[1]
    valid = np.arange(m_ev)[None, :] < counts[:, None]
    rows, cols = np.nonzero(valid)              # row-major: (app, k) order
    n_events = len(rows)
    t_flat = table.times[rows, cols].astype(np.float64) * MINUTE
    order = np.lexsort((rows, t_flat))          # oracle sort: (t, app_idx)
    rank = np.empty(n_events, np.int64)
    rank[order] = np.arange(n_events)

    x_flat = table.exec_s[rows].astype(np.float64)
    if cluster.hedge is not None and n_events:
        u1, u2 = cluster.hedge.event_uniforms(n_events)
        x_flat = np.asarray(cluster.hedge.latency_from_uniforms(
            x_flat, u1[rank], u2[rank]), np.float64)
    e_flat = t_flat + x_flat
    e_min_flat = e_flat / MINUTE
    # repro-lint: ignore[nondeterminism] -- phase timing only
    t1 = time.perf_counter()
    PHASE_SECONDS["A"] = t1 - t0

    # ---- Phase B: policy windows per gap --------------------------------
    e_min2d = np.full((n, m_ev), np.inf)
    e_min2d[rows, cols] = e_min_flat
    la2d, ua2d, ka2d = _policy_windows(spec, e_min2d, counts, app_chunk,
                                       device, mesh)
    la = la2d[rows, cols]
    ua = ua2d[rows, cols]
    ka_sec = ka2d[rows, cols] * MINUTE          # the policy's keep_alive
    # repro-lint: ignore[nondeterminism] -- phase timing only
    t0 = time.perf_counter()
    PHASE_SECONDS["B"] = t0 - t1

    # ---- Phase C: closed-form gap replay --------------------------------
    assign = table.worker_assignment(n_workers, cluster.balancing)
    w_flat = assign[rows]
    tick_src = np.lexsort((t_flat, w_flat))     # per-worker sorted arrivals
    ticks_by_w = t_flat[tick_src]
    woff = np.zeros(n_workers + 1, np.int64)
    np.cumsum(np.bincount(w_flat, minlength=n_workers), out=woff[1:])

    last = cols == counts[rows] - 1
    first = cols == 0
    nxt = np.full(n_events, np.inf)
    nxt[~last] = t_flat[np.nonzero(~last)[0] + 1]

    stay = la <= 0.0                            # keep loaded through the gap
    u_stay = e_flat + ua * MINUTE               # expiry schedule (stay)
    p_pre = e_flat + la * MINUTE                # pre-warm schedule (else)

    # Stay branch: unloaded at the first tick past the expiry — which
    # exists whenever the next arrival is cold; the run end finalizes the
    # last gap when no tick ever reaches it.
    need_u = stay & ((nxt >= u_stay) | last)
    ut_stay = np.full(n_events, np.inf)
    ui_stay = np.full(n_events, -1, np.int64)
    ut_stay[need_u], ui_stay[need_u] = _first_tick_ge(
        ticks_by_w, woff, tick_src, w_flat[need_u], u_stay[need_u])

    # Pre-warm branch: unloaded immediately at the execution end; the fire
    # happens at the first tick past the schedule unless the app's own next
    # arrival (which cancels the pre-warm) comes first.
    pre = ~stay
    tau = np.full(n_events, np.inf)
    tau_i = np.full(n_events, -1, np.int64)
    tau[pre], tau_i[pre] = _first_tick_ge(
        ticks_by_w, woff, tick_src, w_flat[pre], p_pre[pre])
    fired = pre & np.isfinite(tau) & (last | (tau <= nxt))
    q_fire = tau + ka_sec                       # post-fire expiry schedule
    need_f = fired & ((nxt >= q_fire) | last)
    ut_fire = np.full(n_events, np.inf)
    ui_fire = np.full(n_events, -1, np.int64)
    ut_fire[need_f], ui_fire[need_f] = _first_tick_ge(
        ticks_by_w, woff, tick_src, w_flat[need_f], q_fire[need_f])

    # Cold verdicts: event k is cold iff gap k-1 lost the image.
    next_cold = np.where(stay, nxt >= u_stay,
                         np.where(fired, nxt >= q_fire, True))
    cold = np.empty(n_events, bool)
    cold[first] = True
    not_first = np.nonzero(~first)[0]
    cold[not_first] = next_cold[not_first - 1]

    # repro-lint: ignore[nondeterminism] -- phase timing only
    t1 = time.perf_counter()
    PHASE_SECONDS["C"] = t1 - t0

    # ---- Phase D: HBM evictions to a fixed point ------------------------
    # Cheap pessimistic screen first: a worker whose assigned apps all fit
    # at once can never evict; only workers past the sum test replay their
    # exact processing-order occupancy (and most find no violation).
    wb = table.weight_bytes.astype(np.float64)
    wb_flat = wb[rows]
    evicted = np.zeros(n_events, bool)
    evict_time = np.zeros(n_events)
    overflow_w = np.zeros(n_workers, np.int64)
    active = counts > 0
    if np.isfinite(budget) and n_events:
        per_w_assigned = np.bincount(assign[active], weights=wb[active],
                                     minlength=n_workers)
        risky = np.nonzero(per_w_assigned > budget)[0]
        if len(risky):
            tie = _app_tie_ranks(table)
            t_by_rank = t_flat[order]
            rounds_left = (max_eviction_rounds if max_eviction_rounds
                           is not None else np.inf)
            for w in risky:
                j_w = np.nonzero(w_flat == w)[0]
                ev_l, evt_l, n_over, used = _evict_worker(
                    j_w, budget, rows=rows, rank=rank, t_by_rank=t_by_rank,
                    wb=wb_flat, tie=tie, cold=cold, stay=stay, pre=pre,
                    fired=fired, need_u=need_u, need_f=need_f,
                    ui_stay=ui_stay, ui_fire=ui_fire, tau_i=tau_i,
                    u_stay=u_stay, q_fire=q_fire, p_pre=p_pre,
                    max_rounds=rounds_left)
                evicted[j_w] = ev_l
                evict_time[j_w] = evt_l
                overflow_w[w] = n_over
                rounds_left -= used

    # repro-lint: ignore[nondeterminism] -- phase timing only
    t0 = time.perf_counter()
    PHASE_SECONDS["D"] = t0 - t1

    # Loads and unloads (time, worker, bytes) for residency + stats. An
    # evicted span's scheduled expiry never happens — its unload is the
    # eviction itself, at the evicting load's tick time.
    sched_u = need_u & ~evicted
    sched_f = need_f & ~evicted
    load_m = [cold, fired]
    load_t = [t_flat[cold], tau[fired]]
    unload_m = [pre, sched_u, sched_f, evicted]
    # Expiries missing their tick are finalized at the run end.
    unload_t = [e_flat[pre],
                np.where(np.isfinite(ut_stay[sched_u]), ut_stay[sched_u],
                         t_end),
                np.where(np.isfinite(ut_fire[sched_f]), ut_fire[sched_f],
                         t_end),
                evict_time[evicted]]

    lw = np.concatenate([w_flat[m] for m in load_m]) if n_events else \
        np.zeros(0, np.int64)
    uw = np.concatenate([w_flat[m] for m in unload_m]) if n_events else \
        np.zeros(0, np.int64)
    lr = np.concatenate([rows[m] for m in load_m]) if n_events else \
        np.zeros(0, np.int64)
    ur = np.concatenate([rows[m] for m in unload_m]) if n_events else \
        np.zeros(0, np.int64)
    lb = wb[lr]
    ub = wb[ur]
    lt = np.concatenate(load_t) if n_events else np.zeros(0)
    ut = np.concatenate(unload_t) if n_events else np.zeros(0)

    n_loads = np.bincount(lr, minlength=n)
    n_unloads = np.bincount(ur, minlength=n)
    if not np.array_equal(n_loads, n_unloads):  # pragma: no cover
        raise AssertionError("cluster_vector invariant violated: "
                             "per-app loads != unloads")

    # ---- Results --------------------------------------------------------
    base_cold = BASE_LOAD_LATENCY + wb / H2D_BANDWIDTH
    start_lat = np.where(
        cold, base_cold[rows] + np.where(first, COMPILE_MISS_LATENCY, 0.0),
        0.0)
    lat = np.empty(n_events)
    lat[rank] = start_lat + x_flat              # oracle (arrival) order

    cold_per_app = np.bincount(rows, weights=cold.astype(np.float64),
                               minlength=n)
    inv = counts.astype(np.float64)
    # Per-app first, per-worker second: the load/unload time sums cancel
    # within each app's handful of events instead of across the fleet,
    # keeping resident time at float64 accumulation accuracy.
    res_app = (np.bincount(ur, weights=ut * ub, minlength=n)
               - np.bincount(lr, weights=lt * lb, minlength=n))
    resident_bs = np.bincount(assign, weights=res_app, minlength=n_workers)

    stats = []
    cold_w = np.bincount(w_flat[cold], minlength=n_workers)
    warm_w = (np.bincount(w_flat, minlength=n_workers) - cold_w)
    fire_w = np.bincount(w_flat[fired], minlength=n_workers)
    unl_w = np.bincount(uw, minlength=n_workers)   # includes evictions
    evict_w = np.bincount(w_flat[evicted], minlength=n_workers)
    moved_w = np.bincount(lw, weights=lb, minlength=n_workers)
    for w in range(n_workers):
        stats.append(dict(
            cold_starts=int(cold_w[w]), warm_starts=int(warm_w[w]),
            prewarms=int(fire_w[w]), unloads=int(unl_w[w]),
            evictions=int(evict_w[w]),
            budget_overflows=int(overflow_w[w]),
            bytes_moved=float(moved_w[w]),
            resident_byte_seconds=float(resident_bs[w])))

    # repro-lint: ignore[nondeterminism] -- phase timing only
    PHASE_SECONDS["results"] = time.perf_counter() - t0
    restored = (cluster.checkpoint_at_minute is not None and n_events > 0
                and bool(np.any(
                    t_flat >= cluster.checkpoint_at_minute * MINUTE)))
    return ClusterResult(
        cold_pct_per_app=100.0 * cold_per_app / np.maximum(inv, 1),
        latencies_s=lat,
        wasted_gb_minutes=float(resident_bs.sum()) / 1e9 / 60.0,
        stats_per_worker=stats,
        restored_mid_run=restored)


# --------------------------------------------------------------------------
# Front door
# --------------------------------------------------------------------------


def run_cluster(workload, policy, cluster: Optional[ClusterSpec] = None, *,
                engine: str = "auto", app_chunk: Optional[int] = None,
                device: Union[None, str, torch.device] = None,
                devices=None, max_eviction_rounds: Optional[int] = None,
                exec_s=None, memory_mb=None,
                weight_bytes=None) -> ClusterResult:
    """Run one workload x policy x cluster cell.

    ``workload`` is an :class:`AppTable`, ``WorkloadSpec`` or ``Trace``
    (``exec_s``/``memory_mb``/``weight_bytes`` fill in per-app metadata the
    workload itself does not carry). ``engine="auto"`` picks the vectorized
    engine, oversubscribed fleets included (HBM evictions are replayed to
    a fixed point); ``"scalar"`` runs the per-event oracle on the same
    table. Phase B and the oracle's forecasters run on ``device`` (the
    card unless told otherwise; raises without one). ``max_eviction_rounds``
    (default unlimited) caps the total fixed-point resolutions; past it the
    run falls back to the scalar oracle with a warning. ``devices``
    (None, an int or ``"auto"``, as ``EngineOptions.devices``) splits
    phase B's app rows across devices
    (:mod:`repro_torch.distributed.scaleout`), bit for bit; the scalar
    engine ignores it.
    """
    if engine not in CLUSTER_ENGINES:
        raise ValueError(f"unknown cluster engine {engine!r}; expected one "
                         f"of {CLUSTER_ENGINES}")
    dev = resolve_device(device)
    mesh = mesh_for(devices, dev)
    cluster = cluster if cluster is not None else ClusterSpec()
    cluster.validate()
    spec = as_spec(policy)
    PHASE_SECONDS.clear()
    # repro-lint: ignore[nondeterminism] -- phase timing only
    t0 = time.perf_counter()
    table = as_table(workload, exec_s=exec_s, memory_mb=memory_mb,
                     weight_bytes=weight_bytes)
    # repro-lint: ignore[nondeterminism] -- phase timing only
    PHASE_SECONDS["table"] = time.perf_counter() - t0
    if engine != "scalar":
        try:
            return _run_vector(table, spec, cluster,
                               app_chunk or DEFAULT_APP_CHUNK, dev,
                               max_eviction_rounds=max_eviction_rounds,
                               mesh=mesh)
        except EvictionRoundsExceeded as e:
            warnings.warn(
                f"{e}; falling back to engine='scalar' (raise "
                f"max_eviction_rounds to keep the vectorized engine)",
                RuntimeWarning, stacklevel=2)
    sim = ClusterSim(table.to_registry(), spec, cluster.to_config(),
                     device=dev)
    return sim.run(table.to_trace())


@dataclasses.dataclass
class ClusterSweep:
    """A (T, S, C) grid: policy x cluster sweeps over T workloads.

    ``results[t][s][c]`` is the :class:`ClusterResult` of workload ``t``
    under policy spec ``s`` on cluster shape ``c``, each cell identical to
    the corresponding single :func:`run_cluster` call.
    """
    tables: List[AppTable]
    specs: List[PolicySpec]
    clusters: List[ClusterSpec]
    results: List[List[List[ClusterResult]]]

    @property
    def shape(self):
        return (len(self.tables), len(self.specs), len(self.clusters))

    def row(self, t: int, s: int, c: int = 0) -> ClusterResult:
        return self.results[t][s][c]


def sweep_cluster(workloads: Union[Sequence, object], specs: Sequence,
                  clusters: Optional[Sequence[ClusterSpec]] = None, *,
                  engine: str = "auto", app_chunk: Optional[int] = None,
                  device: Union[None, str, torch.device] = None,
                  devices=None,
                  max_eviction_rounds: Optional[int] = None) -> ClusterSweep:
    """Evaluate the full workload x policy x cluster grid.

    Each workload is converted to a columnar :class:`AppTable` once and
    reused across every (policy, cluster) cell.
    """
    if not isinstance(workloads, (list, tuple)):
        workloads = [workloads]
    specs = [as_spec(s) for s in specs]
    clusters = list(clusters) if clusters is not None else [ClusterSpec()]
    if not specs or not clusters or not len(workloads):
        raise ValueError("sweep_cluster needs at least one workload, one "
                         "PolicySpec and one ClusterSpec")
    tables = [as_table(w) for w in workloads]
    results = [[[run_cluster(tab, s, c, engine=engine, app_chunk=app_chunk,
                             device=device, devices=devices,
                             max_eviction_rounds=max_eviction_rounds)
                 for c in clusters] for s in specs] for tab in tables]
    return ClusterSweep(tables=tables, specs=specs, clusters=clusters,
                        results=results)
