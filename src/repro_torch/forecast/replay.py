"""Vectorised replay of the hybrid policy for OOB-heavy apps.

The port of ``repro/forecast/replay.py``: the engines' post-pass for
``HybridSpec(use_arima=True)``. A forecaster cannot run inside the sweep
scan, so the apps at which the scan flags a forecaster call (at some
event, OOB-heavy with enough samples) are replayed here, on the engine's
device:

  1. a rescan of those apps through the fused hybrid step, one launch of
     the sweep-step kernel per event column on the card
     (:func:`repro_torch.kernels.histogram.fused_hybrid_sweep_step`, S=1,
     float64 time; its plain version on the CPU), keeping every event's
     residency bounds and the flag "the scalar policy consults the
     forecaster here";
  2. the flagged (app, event) observation windows stacked on the host and
     fitted in one batched call
     (:func:`repro_torch.forecast.arima_batched.fit_arima_grid`);
  3. each app's order-selection cadence replayed on the host
     (:func:`repro_torch.forecast.forecaster.select_order_step`, the
     function the scalar forecaster steps through); accepted forecasts
     override the scanned bounds through ``policy_math.arima_window`` /
     ``window_bounds``, as the scalar policy does;
  4. cold counts, waste and final windows recomputed under the per-event
     bounds, in float64.

Equivalence to the scalar oracle is structural: where the scalar policy
does not take the ARIMA branch its windows are the fused step's, and where
it does both sides run the same fit, selection and window code.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..core import policy_math
from ..core.policy import HybridConfig
from ..device import resolve_device
from .arima_batched import MAX_OBS, GridFit, fit_arima_grid
from .forecaster import (DEFAULT_REFIT_EVERY, MIN_FORECAST_OBS,
                         select_order_step)

__all__ = ["hybrid_window_sequences", "replay_oob_apps"]


def _branch_scan(cols: torch.Tensor, cfg_i32: torch.Tensor,
                 cfg_f32: torch.Tensor, bin_minutes: torch.Tensor,
                 n_bins: int, step):
    """Step one chunk's event columns ``cols`` [width, n] (float64)
    through ``step`` — the sweep step (kernel or plain version) with one
    config — and keep each column's (load, unload) bounds and the
    "forecaster consulted" flag: enough recorded samples AND the OOB
    counter heavy, the guard ``HybridHistogramPolicy._decide`` evaluates
    after its histogram update. Returns three [width, n] tensors."""
    from ..core.simulator import _initial_carry
    width, n = cols.shape
    tdt, dev = cols.dtype, cols.device
    state = _initial_carry(cfg_f32, n, n_bins, tdt)
    load = torch.empty((width, n), dtype=tdt, device=dev)
    unload = torch.empty_like(load)
    branch = torch.empty((width, n), dtype=torch.bool, device=dev)
    oob_threshold, min_samples = cfg_f32[:, 5:6], cfg_i32[:, 3:4]
    for t, t_now in enumerate(cols):
        state = step(t_now, *state, cfg_i32, cfg_f32,
                     bin_minutes=bin_minutes)
        total, oob = state[1][..., -1], state[2]
        heavy = policy_math.oob_heavy(total, oob, oob_threshold)
        load[t], unload[t] = state[5][0], state[6][0]
        branch[t] = (heavy & ((total + oob) >= min_samples))[0]
    return load, unload, branch


def _scan_window_sequences(times2d: np.ndarray, counts: np.ndarray,
                           hybrid: HybridConfig, app_chunk: Optional[int],
                           device: torch.device, use_kernel: bool, mesh=None
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fused-step (load, unload) bounds and branch flags for every event,
    host float64 / bool [n, M]; ``mesh`` splits the app rows across
    devices (``distributed.scaleout``)."""
    from ..core.simulator import (DEFAULT_APP_CHUNK, _build_cfg_blocks,
                                  _chunk_stream, _chunked_buckets,
                                  _host_rows, _on_mesh)
    from ..kernels.histogram import (fused_hybrid_sweep_step,
                                     fused_hybrid_sweep_step_plain)
    n, m_ev = times2d.shape
    la = np.zeros((n, m_ev))
    ua = np.full((n, m_ev), float(hybrid.standard_keep_alive))
    branch = np.zeros((n, m_ev), bool)
    ci, cf = (torch.from_numpy(x).to(device)
              for x in _build_cfg_blocks([hybrid]))
    bm = torch.tensor([float(hybrid.histogram.bin_minutes)],
                      dtype=torch.float64, device=device)
    step = fused_hybrid_sweep_step if use_kernel \
        else fused_hybrid_sweep_step_plain
    chunk = DEFAULT_APP_CHUNK if app_chunk is None else int(app_chunk)
    work = _chunked_buckets(times2d, counts, chunk)
    scan = _on_mesh(lambda cols, ci, cf, bm: _branch_scan(
        cols, ci, cf, bm, hybrid.histogram.n_bins, step), mesh,
        (1, None, None, None))
    for sel, cols in _chunk_stream(work, device, mesh):
        l_seq, u_seq, b_seq = (
            x.T for x in _host_rows(scan(cols, ci, cf, bm), len(sel)))
        width = l_seq.shape[1]
        la[sel, :width] = l_seq
        ua[sel, :width] = u_seq
        branch[sel, :width] = b_seq
    return la, ua, branch


def _call_windows(times2d: np.ndarray, counts: np.ndarray,
                  hybrid: HybridConfig, branch: np.ndarray):
    """Stage 1: every (app, event) forecaster-call window. The scalar
    forecaster sees the last MAX_OBS inter-arrival times before the
    decision event: the diffs of t[0..k] trimmed to the window. Returns
    (rows, events per row, stacked [W, MAX_OBS] float32, lengths [W])."""
    min_fit_obs = max(int(hybrid.arima_min_samples), MIN_FORECAST_OBS)
    rows: List[int] = []
    events: List[List[int]] = []
    windows: List[np.ndarray] = []
    for r in np.nonzero(branch.any(axis=1))[0]:
        m = int(counts[r])
        its = np.diff(times2d[r, :m].astype(np.float64))
        ks = [k for k in range(1, m)
              if branch[r, k] and min(k, MAX_OBS) >= min_fit_obs]
        if not ks:
            continue
        rows.append(int(r))
        events.append(ks)
        windows.extend(its[max(0, k - MAX_OBS):k] for k in ks)
    stacked = np.zeros((len(windows), MAX_OBS), np.float32)
    lens = np.zeros(len(windows), np.int32)
    for i, w in enumerate(windows):
        stacked[i, :len(w)] = w
        lens[i] = len(w)
    return rows, events, stacked, lens


def _replay_cadence(rows: List[int], events: List[List[int]], fit: GridFit,
                    counts: np.ndarray, hybrid: HybridConfig,
                    la: np.ndarray, ua: np.ndarray,
                    keep: Optional[np.ndarray] = None) -> np.ndarray:
    """Stage 2: each app's selection cadence over its call sequence; an
    accepted forecast overrides the scanned bounds of its event in place
    (and its keep-alive in ``keep``, where given: ``ua - la`` need not
    round back to it). Returns ``last_keep`` [n]: the keep-alive of an
    app's final window where the forecaster decided it, else NaN."""
    last_keep = np.full(la.shape[0], np.nan)
    task = 0
    for r, ks in zip(rows, events):
        state = (None, 0)
        last_event = int(counts[r]) - 1
        for k in ks:
            state, pred = select_order_step(
                state, fit.aic[task], fit.valid[task], fit.pred[task],
                DEFAULT_REFIT_EVERY)
            task += 1
            if pred is None or not (math.isfinite(pred) and pred > 0):
                continue  # the scanned standard bounds stay
            pw, ka = policy_math.arima_window(pred, hybrid.arima_margin)
            lo, hi = policy_math.window_bounds(pw, ka)
            la[r, k] = lo
            ua[r, k] = hi
            if keep is not None:
                keep[r, k] = ka
            if k == last_event:
                last_keep[r] = ka
    return last_keep


def _apply_forecast_overrides(times2d: np.ndarray, counts: np.ndarray,
                              hybrid: HybridConfig, la: np.ndarray,
                              ua: np.ndarray, branch: np.ndarray,
                              device: torch.device,
                              keep: Optional[np.ndarray] = None
                              ) -> np.ndarray:
    """Batched-ARIMA overrides of the scanned bounds (and ``keep``), in
    place: stage 1, one fit of every window on ``device``, stage 2.
    Returns ``last_keep``."""
    if not hybrid.use_arima or not branch.any():
        return np.full(times2d.shape[0], np.nan)
    rows, events, stacked, lens = _call_windows(times2d, counts, hybrid,
                                                branch)
    fit = fit_arima_grid(stacked, lens, device=device)
    return _replay_cadence(rows, events, fit, counts, hybrid, la, ua, keep)


def _verdict(sub_t: np.ndarray, sub_c: np.ndarray, duration: float,
             hybrid: HybridConfig, la: np.ndarray, ua: np.ndarray,
             last_keep: np.ndarray,
             include_trailing: bool) -> Dict[str, np.ndarray]:
    """Cold counts, waste and final windows under the per-event bounds
    (row k's bounds govern the gap after event k), float64 as the scalar
    loop's Python floats."""
    k, m_ev = sub_t.shape
    t64 = sub_t.astype(np.float64)
    col = np.arange(m_ev)[None, :]
    valid = col < sub_c[:, None]
    has_events = sub_c > 0
    gap_valid = valid[:, 1:]
    with np.errstate(invalid="ignore"):   # inf - inf on padding columns
        it = t64[:, 1:] - t64[:, :-1]
    it = np.where(gap_valid, it, 0.0)
    prev_la, prev_ua = la[:, :-1], ua[:, :-1]
    warm = policy_math.warm_from_bounds(it, prev_la, prev_ua)
    cold = has_events.astype(np.int64) + np.sum(gap_valid & ~warm, axis=1)
    contrib = np.where(gap_valid,
                       policy_math.idle_from_bounds(it, prev_la, prev_ua),
                       0.0)
    # accumulate in event order, as the scalar oracle sums per event
    waste = np.zeros(k)
    for j in range(contrib.shape[1]):
        waste += contrib[:, j]

    last = np.maximum(sub_c - 1, 0)
    rows = np.arange(k)
    final_la = np.where(has_events, la[rows, last], 0.0)
    final_ua = np.where(has_events, ua[rows, last],
                        float(hybrid.standard_keep_alive))
    if include_trailing:
        t_last = np.where(has_events, t64[rows, last], np.inf)
        tail = duration - t_last
        waste = waste + np.where(
            has_events & (tail > 0),
            policy_math.idle_from_bounds(np.where(np.isfinite(tail), tail,
                                                  0.0),
                                         final_la, final_ua),
            0.0)
    # the final keep-alive is the bound difference, but where the last
    # decision was a forecast the scalar policy reports that keep-alive
    # itself ((pw + ka) - pw need not round back to ka)
    final_keep = np.where(np.isnan(last_keep), final_ua - final_la,
                          last_keep)
    return dict(cold=cold, wasted_minutes=waste, final_prewarm=final_la,
                final_keep_alive=final_keep)


def hybrid_window_sequences(times2d: np.ndarray, counts: np.ndarray,
                            hybrid: HybridConfig, *,
                            app_chunk: Optional[int] = None,
                            device: Union[None, str, torch.device] = None
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-event (load_at, unload_at) bounds for the given apps, float64.

    ``times2d`` is a padded [n, M] event-time matrix (+inf padding, as
    ``Trace.to_padded``); row k's bounds are the windows decided at event
    k. The batched equivalent of stepping
    ``HybridHistogramPolicy.on_invocation`` through every event, forecaster
    included, on ``device`` (the card unless told otherwise; the rescan
    takes the step kernel there)."""
    dev = resolve_device(device)
    la, ua, branch = _scan_window_sequences(times2d, counts, hybrid,
                                            app_chunk, dev, True)
    _apply_forecast_overrides(times2d, counts, hybrid, la, ua, branch, dev)
    return la, ua


def replay_oob_apps(times2d: np.ndarray, counts: np.ndarray,
                    duration: float, hybrid: HybridConfig,
                    app_indices: np.ndarray, include_trailing: bool, *,
                    app_chunk: Optional[int] = None,
                    device: Union[None, str, torch.device] = None,
                    use_kernel: bool = True) -> Dict[str, np.ndarray]:
    """Re-simulate the flagged apps under the full (forecaster-capable)
    hybrid policy, vectorised, on ``device`` — the engines' post-pass.

    Returns per-app arrays aligned with ``app_indices``: cold counts,
    wasted minutes, final prewarm, final keep-alive — bit-identical to
    ``simulate_scalar(trace, HybridHistogramPolicy(hybrid, device=device),
    ...)`` on those apps."""
    dev = resolve_device(device)
    aidx = np.asarray(app_indices)
    sub_t = times2d[aidx]
    sub_c = counts[aidx].astype(np.int64)
    la, ua, branch = _scan_window_sequences(sub_t, sub_c, hybrid, app_chunk,
                                            dev, use_kernel)
    last_keep = _apply_forecast_overrides(sub_t, sub_c, hybrid, la, ua,
                                          branch, dev)
    return _verdict(sub_t, sub_c, duration, hybrid, la, ua, last_keep,
                    include_trailing)
