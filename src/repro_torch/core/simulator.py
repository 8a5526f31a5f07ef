"""Trace-driven cold-start simulator engines (paper §5.1), in PyTorch.

The front door is :mod:`repro_torch.core.experiment` (``run``/``sweep``);
this module holds the engines, all deciding through
:mod:`repro_torch.core.policy_math`:

  * :func:`simulate_scalar` — the float64 event-driven oracle; walks each
    app's invocations through any :class:`~repro_torch.core.policy.Policy`.
  * :func:`_run_fixed_sweep` — S fixed keep-alive configs in one float64
    pass over the padded trace columns.
  * :func:`_run_hybrid_sweep` — S hybrid configs in one pass: apps are
    bucketed by event count, each bucket chunked over apps, and one fused
    step per event column advances every config x app of the chunk. With
    ``use_kernel`` the step is
    :func:`repro_torch.kernels.histogram.fused_hybrid_sweep_step` (the CUDA
    kernel on the card); otherwise its plain version. Per-config state is
    carried unfactored, ``[S, n, n_bins]`` int32.

Every engine keeps time in float64, so none needs per-chunk rebasing: the
TPU kernel's float32 rebased time is not exact on float32 minute stamps
over two weeks (an idle time rounds across a bin edge; ROADMAP Queue C).

The scan reads the times as ``[width, n]``, so each event column is
contiguous (transposed on the device); on the card the next chunk is
copied from pinned host memory on a side stream while the current one is
scanned.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from . import policy_math
from .policy import (HybridConfig, Policy, is_warm, loaded_idle_time)
from .workload import Trace

__all__ = ["SimResult", "simulate_scalar", "BUCKET_EDGES",
           "DEFAULT_APP_CHUNK"]

BUCKET_EDGES = (64, 512, 4096, 1 << 62)

# Apps per device-resident chunk of the hybrid scan: bounds the cumulative
# count state ([S, chunk, n_bins]); sweeps divide it by the config count.
DEFAULT_APP_CHUNK = 131072
_MIN_AUTO_CHUNK = 4096


@dataclasses.dataclass
class SimResult:
    cold: np.ndarray            # [n_apps] cold-start counts
    invocations: np.ndarray     # [n_apps] invocation counts
    wasted_minutes: np.ndarray  # [n_apps] loaded-but-idle memory time
    final_prewarm: Optional[np.ndarray] = None     # [n_apps] float64
    final_keep_alive: Optional[np.ndarray] = None  # [n_apps] float64

    @property
    def cold_pct(self) -> np.ndarray:
        return 100.0 * self.cold / np.maximum(self.invocations, 1)

    def cold_pct_percentile(self, q: float = 75.0) -> float:
        return float(np.percentile(self.cold_pct, q))

    @property
    def total_wasted(self) -> float:
        return float(self.wasted_minutes.sum())

    @property
    def always_cold_fraction(self) -> float:
        # only invoked apps can be always-cold (paper Fig. 12)
        invoked = self.invocations > 0
        if not invoked.any():
            return 0.0
        return float(np.mean(self.cold[invoked] >= self.invocations[invoked]))


# --------------------------------------------------------------------------
# Scalar reference engine
# --------------------------------------------------------------------------

def simulate_scalar(trace: Trace, policy: Policy,
                    include_trailing: bool = True,
                    app_indices: Optional[Sequence[int]] = None) -> SimResult:
    idx = range(trace.n_apps) if app_indices is None else app_indices
    n = trace.n_apps
    cold = np.zeros(n, np.int64)
    inv = np.zeros(n, np.int64)
    waste = np.zeros(n, np.float64)
    final_pre = np.zeros(n, np.float64)
    final_keep = np.zeros(n, np.float64)
    for i in idx:
        t = trace.events(i)
        app = trace.app_id(i)
        inv[i] = len(t)
        w = policy.windows(app)
        if len(t):
            cold[i] += 1  # first invocation is always cold
            w = policy.on_invocation(app, None)
            for k in range(1, len(t)):
                it = float(t[k]) - float(t[k - 1])  # exec time = 0 => IT == IAT
                if not is_warm(it, w):
                    cold[i] += 1
                waste[i] += loaded_idle_time(it, w)
                w = policy.on_invocation(app, it)
            if include_trailing:
                tail_gap = trace.duration_minutes - float(t[-1])
                waste[i] += loaded_idle_time(tail_gap, w) if tail_gap > 0 else 0.0
        final_pre[i], final_keep[i] = w.prewarm, w.keep_alive
    return SimResult(cold, inv, waste, final_pre, final_keep)


# --------------------------------------------------------------------------
# Buckets, chunks, transfers
# --------------------------------------------------------------------------


def _buckets(times: np.ndarray, counts: np.ndarray):
    """Yield (app_index_array, trimmed_times) grouped by event count."""
    lo = 0
    for edge in BUCKET_EDGES:
        sel = np.where((counts > lo) & (counts <= edge))[0]
        if len(sel):
            width = int(counts[sel].max())
            yield sel, times[sel][:, :width]
        lo = edge


def _chunked_buckets(times: np.ndarray, counts: np.ndarray, app_chunk: int):
    """Bucket by event count, then chunk each bucket over apps (the last
    chunk of a bucket may be ragged)."""
    if app_chunk < 1:
        raise ValueError(
            f"app_chunk must be a positive app count, got {app_chunk}")
    for sel, sub in _buckets(times, counts):
        _check_scan_width(sub.shape[1])
        for lo in range(0, len(sel), app_chunk):
            yield sel[lo:lo + app_chunk], sub[lo:lo + app_chunk]


def _check_scan_width(width: int) -> None:
    """The scaled percentile compare multiplies cumulative counts — bounded
    by the scan width — by PCT_SCALE in int32; reject wider scans."""
    if width > policy_math.MAX_SCALED_COUNT:
        raise ValueError(
            f"bucket scan width {width} overflows the int32 scaled "
            f"percentile compare (max {policy_math.MAX_SCALED_COUNT} "
            f"events per app)")


def _absolute_results(waste, last_t, prewarm, unload_at, duration,
                      include_trailing):
    """Trailing waste from the last-event clock, and the final (prewarm,
    keep-alive) windows, in float64. Works for [S, n] rows. Returns
    (waste64, prewarm64, keep64)."""
    pre = np.asarray(prewarm, np.float64)
    ub = np.asarray(unload_at, np.float64)
    waste = np.asarray(waste, np.float64)
    if include_trailing:
        tail_gap = duration - np.asarray(last_t, np.float64)
        waste = waste + policy_math.idle_from_bounds(tail_gap, pre, ub)
    return waste, pre, ub - pre


def _columns_to_device(host: np.ndarray, device: torch.device, copy_stream):
    """``host`` [n, width] on ``device``, as it is laid out on the host.

    On the card the copy is enqueued from pinned memory on ``copy_stream``
    (non-blocking); :func:`_columns_ready` makes the compute stream wait."""
    rows = torch.from_numpy(np.ascontiguousarray(host))
    if device.type != "cuda":
        return rows.to(device)
    rows = rows.pin_memory()
    with torch.cuda.stream(copy_stream):
        return rows.to(device, non_blocking=True)


def _columns_ready(rows: torch.Tensor, copy_stream) -> torch.Tensor:
    """The chunk as contiguous float64 [width, n] event columns, transposed
    and widened on the device (a strided host transpose of a 1M-app chunk
    costs seconds; the float32 trace crosses the bus at half the bytes)."""
    if copy_stream is not None:
        compute = torch.cuda.current_stream(rows.device)
        compute.wait_stream(copy_stream)
        rows.record_stream(compute)
    cols = torch.empty((rows.shape[1], rows.shape[0]), dtype=torch.float64,
                       device=rows.device)
    return cols.copy_(rows.t())


def _chunk_stream(work, device):
    """Yield (sel, float64 columns [width, n] on device) for each (sel,
    sub) of ``work``; the next chunk's host->device copy is in flight while
    the current one runs."""
    copy_stream = torch.cuda.Stream(device) if device.type == "cuda" \
        else None

    def prep(sel_sub):
        sel, sub = sel_sub
        return sel, _columns_to_device(sub, device, copy_stream)

    pending = next(work, None)
    pending = None if pending is None else prep(pending)
    while pending is not None:
        sel, cols = pending
        nxt = next(work, None)
        pending = None if nxt is None else prep(nxt)
        yield sel, _columns_ready(cols, copy_stream)


# --------------------------------------------------------------------------
# Fixed keep-alive family
# --------------------------------------------------------------------------


def _fixed_scan(cols: torch.Tensor, keep_alive: torch.Tensor,
                duration: float, include_trailing: bool):
    """Scan one chunk (``cols`` [width, n] float64) for S stacked keep-alive
    values ``keep_alive`` [S, 1]. Returns (cold [S, n], waste [S, n])."""
    n = cols.shape[1]
    S = keep_alive.shape[0]
    prev_t = torch.full((n,), -np.inf, dtype=cols.dtype, device=cols.device)
    cold = torch.zeros((S, n), dtype=torch.int32, device=cols.device)
    waste = torch.zeros((S, n), dtype=cols.dtype, device=cols.device)
    for t_now in cols:
        valid = torch.isfinite(t_now)
        it = t_now - prev_t
        first = ~torch.isfinite(prev_t)
        warm = policy_math.warm_from_bounds(it, 0.0, keep_alive)
        cold = cold + (valid & (first | ~warm)).to(torch.int32)
        waste = waste + torch.where(
            valid & ~first, policy_math.idle_from_bounds(it, 0.0, keep_alive),
            0.0)
        prev_t = torch.where(valid, t_now, prev_t)
    if include_trailing:
        tail = torch.clamp(duration - prev_t, min=0.0)
        waste = waste + torch.where(
            torch.isfinite(prev_t),
            policy_math.idle_from_bounds(tail, 0.0, keep_alive), 0.0)
    return cold, waste


def _run_fixed_sweep(trace: Trace, keeps: Sequence[float],
                     include_trailing: bool = True, *, padded=None,
                     device: torch.device) -> dict:
    """S fixed keep-alive configs (``inf`` == never unload) in one float64
    pass: float32 would flip verdicts at the keep-alive boundary on
    multi-week clocks. ``padded`` is the trace's ``to_padded()`` pair."""
    times, counts = padded if padded is not None else trace.to_padded()
    S, n = len(keeps), trace.n_apps
    cold = np.zeros((S, n), np.int64)
    waste = np.zeros((S, n), np.float64)
    ks = torch.tensor(np.asarray(keeps, np.float64)[:, None], device=device)
    for sel, cols in _chunk_stream(_buckets(times, counts), device):
        c, w = _fixed_scan(cols, ks, float(trace.duration_minutes),
                           include_trailing)
        cold[:, sel] = c.cpu().numpy()
        waste[:, sel] = w.cpu().numpy()
    keep = np.broadcast_to(np.asarray(keeps, np.float64)[:, None],
                           (S, n)).copy()
    return dict(cold=cold, invocations=counts.astype(np.int64),
                wasted_minutes=waste, final_prewarm=np.zeros((S, n)),
                final_keep_alive=keep)


# --------------------------------------------------------------------------
# Hybrid histogram family
# --------------------------------------------------------------------------


def _step_config_for(cfg: HybridConfig) -> policy_math.HybridStepConfig:
    h = cfg.histogram
    return policy_math.HybridStepConfig.from_host(
        n_bins=h.n_bins, head_pct=h.head_percentile,
        tail_pct=h.tail_percentile, margin=h.margin,
        bin_minutes=h.bin_minutes, range_minutes=h.range_minutes,
        cv_threshold=cfg.cv_threshold, min_samples=cfg.min_samples,
        oob_threshold=cfg.oob_fraction_threshold,
        standard_keep=cfg.standard_keep_alive)


def _build_cfg_blocks(cfgs: Sequence[HybridConfig]):
    """Pack S configs into the (int32 [S, 4], float32 [S, 7]) knob blocks
    the sweep step reads (``kernels.histogram.CFG_*_COLS``)."""
    rows_i, rows_f = [], []
    for c in cfgs:
        h = _step_config_for(c)
        rows_i.append([h.n_bins, h.head_numer, h.tail_numer, h.min_samples])
        rows_f.append([h.margin_lo, h.margin_hi, h.bin_f32, h.range_f32,
                       h.cv_threshold, h.oob_threshold, h.standard_keep])
    return np.asarray(rows_i, np.int32), np.asarray(rows_f, np.float32)


def _hybrid_sweep_scan(cols: torch.Tensor, cfg_i32: torch.Tensor,
                       cfg_f32: torch.Tensor, bin_minutes: torch.Tensor,
                       n_bins: int, step):
    """One sweep over a chunk: ``cols`` [width, n] float64, one ``step`` per
    column for all S configs — ``kernels.histogram.fused_hybrid_sweep_step``
    (the CUDA kernel on the card) or its plain version. Idle times are
    binned by the exact float64 ``bin_minutes`` [S]. The initial carry is
    ``prev=-inf``, zero state, bounds ``(0, standard_keep)`` — the decision
    of an empty histogram. Returns (cold, waste, oob_heavy, last_t,
    prewarm, unload_at)."""
    _check_scan_width(cols.shape[0])
    S, n = cfg_i32.shape[0], cols.shape[1]
    tdt, dev = cols.dtype, cols.device
    zeros = lambda dt: torch.zeros((S, n), dtype=dt, device=dev)
    state = (
        torch.full((S, n), -np.inf, dtype=tdt, device=dev),
        torch.zeros((S, n, n_bins), dtype=torch.int32, device=dev),
        zeros(torch.int32), zeros(tdt), zeros(tdt),
        zeros(tdt),                                        # prewarm
        cfg_f32[:, 6:7].to(tdt).repeat(1, n),              # unload_at
        zeros(torch.int32), zeros(tdt),
    )
    for t_now in cols:
        state = step(t_now, *state, cfg_i32, cfg_f32,
                     bin_minutes=bin_minutes)
    prev_t, cum, oob, _, _, prewarm, unload_at, cold, waste = state
    oobh = policy_math.oob_heavy(cum[..., -1], oob, cfg_f32[:, 5:6])
    # the clock is config-independent: any row of prev_t is the last event
    return cold, waste, oobh, prev_t[0], prewarm, unload_at


def _run_hybrid_sweep(trace: Trace, hybrids: Sequence[HybridConfig],
                      include_trailing: bool = True, *,
                      app_chunk: Optional[int] = None,
                      use_kernel: bool, padded=None,
                      device: torch.device) -> dict:
    """S hybrid configs over one bucketed/chunked trace pass.

    Configs are banded by bin count (no config pays for another's wider
    histogram); the trace preparation and each chunk's transfer are shared
    by every band. ``use_kernel`` steps through the kernel, otherwise
    through its plain version; both in float64 time."""
    if any(h.use_arima for h in hybrids):
        from .policy import ARIMA_NOT_PORTED
        raise NotImplementedError(ARIMA_NOT_PORTED)
    S = len(hybrids)
    times, counts = padded if padded is not None else trace.to_padded()
    n = trace.n_apps
    cold = np.zeros((S, n), np.int64)
    waste = np.zeros((S, n), np.float64)
    pre = np.zeros((S, n), np.float64)
    keep = np.empty((S, n), np.float64)
    for s, h in enumerate(hybrids):
        keep[s, :] = h.standard_keep_alive     # zero-event apps: never scanned
    duration = float(trace.duration_minutes)

    band_of = {}
    for s, h in enumerate(hybrids):
        band_of.setdefault(h.histogram.n_bins, []).append(s)
    if app_chunk is None:
        # per-config [S_band, chunk, n_bins] state: divide by the widest band
        widest = max(len(idx) for idx in band_of.values())
        chunk = max(DEFAULT_APP_CHUNK // widest, _MIN_AUTO_CHUNK)
    else:
        chunk = int(app_chunk)
    bands = []
    for n_bins, idx in sorted(band_of.items()):
        cfgs = [hybrids[s] for s in idx]
        ci, cf = _build_cfg_blocks(cfgs)
        bm = torch.tensor([float(c.histogram.bin_minutes) for c in cfgs],
                          dtype=torch.float64, device=device)
        bands.append((np.asarray(idx), torch.from_numpy(ci).to(device),
                      torch.from_numpy(cf).to(device), bm, n_bins))

    from ..kernels.histogram import (fused_hybrid_sweep_step,
                                     fused_hybrid_sweep_step_plain)
    step = fused_hybrid_sweep_step if use_kernel \
        else fused_hybrid_sweep_step_plain
    work = _chunked_buckets(times, counts, chunk)
    for sel, cols in _chunk_stream(work, device):
        for idx, ci, cf, bm, n_bins in bands:
            # oob_heavy feeds only the ARIMA post-pass, which is not ported
            c, w, _, last_t, pw, ub = (
                x.cpu().numpy()
                for x in _hybrid_sweep_scan(cols, ci, cf, bm, n_bins, step))
            at = np.ix_(idx, sel)
            cold[at] = c
            waste[at], pre[at], keep[at] = _absolute_results(
                w, last_t, pw, ub, duration, include_trailing)
    return dict(cold=cold, invocations=counts.astype(np.int64),
                wasted_minutes=waste, final_prewarm=pre,
                final_keep_alive=keep)
