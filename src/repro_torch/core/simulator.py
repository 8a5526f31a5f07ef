"""Trace-driven cold-start simulator engines (paper §5.1), in PyTorch.

The front door is :mod:`repro_torch.core.experiment` (``run``/``sweep``);
this module holds the engines, all deciding through
:mod:`repro_torch.core.policy_math`:

  * :func:`simulate_scalar` — the float64 event-driven oracle; walks each
    app's invocations through any :class:`~repro_torch.core.policy.Policy`.
  * :func:`_run_fixed_sweep` — S fixed keep-alive configs in one float64
    pass over the padded trace columns.
  * :func:`_run_hybrid_sweep` — S hybrid configs in one pass: apps are
    bucketed by event count, each bucket chunked over apps, and the fused
    step, once per event column, advances every config x app of the chunk.
    The state is factored as the reference's (``_build_sweep_block``):
    the histograms ``[G, n, n_bins]`` int32 once per distinct (bin width,
    bin count) group, and only the bounds, cold counts and waste per
    config, ``[S, n]``. With ``use_kernel`` the chunk's columns go through
    :func:`repro_torch.kernels.histogram.fused_hybrid_sweep_scan_factored`
    (one launch of the CUDA scan kernel on the card, in the form picked
    from the block); otherwise through its plain version, the factored
    plain step per column. A forecaster cannot run inside
    the scan: for each config with ``use_arima`` the apps whose scan
    flags a forecaster call at some event are replayed afterwards through
    :func:`repro_torch.forecast.replay.replay_oob_apps` on the same device
    (the step kernel once per event column with ``use_kernel``).
  * :func:`_run_spes_sweep` — S SPES predictor configs in one float64
    pass of plain PyTorch steps (no per-bin state; the reference has no
    kernel here either).
  * :func:`_simulate_hybrid_batch_reference` — the reference's pre-sweep
    float32 engine (``engine="reference"``): raw counts and a full
    per-step cumsum, one config at a time, per-bucket time rebasing, plain
    PyTorch on the engine's device.

Every other engine keeps time in float64, so none needs per-chunk
rebasing: the TPU kernel's float32 rebased time is not exact on float32
minute stamps over two weeks (an idle time rounds across a bin edge;
ROADMAP Queue C). The ``"reference"`` engine keeps float32 on purpose, to
reproduce the reference's float32 numbers.

``devices`` (``EngineOptions(devices=)``, see
:mod:`repro_torch.distributed.scaleout`) splits each chunk's app rows
across devices in the fixed, SPES and hybrid sweeps: each shard is copied
on its own device's copy stream and scanned there, the outputs
concatenated in device order; results are bit-identical to the
single-device run.

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

from ..distributed.scaleout import pad_app_rows, shard_along_apps
from . import policy_math
from .histogram import HistogramConfig
from .policy import (HybridConfig, Policy, is_warm, loaded_idle_time)
from .workload import Trace

__all__ = ["SimResult", "simulate_scalar", "BUCKET_EDGES",
           "DEFAULT_APP_CHUNK"]

BUCKET_EDGES = (64, 512, 4096, 1 << 62)

# Apps per device-resident chunk of one config's scan; a hybrid sweep
# divides it by how many times larger its state is (``_auto_chunk``), the
# SPES sweep by its config count.
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


def _rebase_chunk(sub: np.ndarray):
    """Per-chunk time rebasing for the float32 ``"reference"`` engine:
    each app's timestamps shifted by its own first event, in float64 on the
    host, BEFORE the cast to float32 (verdicts depend only on idle times).
    Padding (+inf) is unaffected. Returns (rebased float64 array, per-app
    offsets)."""
    t0 = sub[:, 0].astype(np.float64)
    return sub.astype(np.float64) - t0[:, None], t0


def _absolute_results(waste, last_t, prewarm, unload_at, duration,
                      include_trailing, t0=0.0):
    """Trailing waste from the last-event clock (``t0 + last_t``: ``t0``
    the per-app offsets of a rebased scan), and the final (prewarm,
    keep-alive) windows, in float64. Works for [S, n] rows. Returns
    (waste64, prewarm64, keep64)."""
    pre = np.asarray(prewarm, np.float64)
    ub = np.asarray(unload_at, np.float64)
    waste = np.asarray(waste, np.float64)
    if include_trailing:
        tail_gap = duration - (t0 + np.asarray(last_t, np.float64))
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


def _chunk_stream(work, device, mesh=None):
    """Yield (sel, float64 columns [width, n] on device) for each (sel,
    sub) of ``work``; the next chunk's host->device copy is in flight while
    the current one runs.

    With ``mesh`` (a device list, ``scaleout.mesh_for``) the chunk's rows
    are padded with +inf rows to a multiple of the mesh and the columns
    come as a list of each device's row slice, each copied on its own
    device's copy stream (per-device double buffering)."""
    targets = [device] if mesh is None else mesh
    streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
               for d in targets]

    def prep(sel_sub):
        sel, sub = sel_sub
        parts = [sub] if mesh is None else \
            np.split(pad_app_rows(sub, len(mesh)), len(mesh))
        return sel, [_columns_to_device(p, d, st)
                     for p, d, st in zip(parts, targets, streams)]

    pending = next(work, None)
    pending = None if pending is None else prep(pending)
    while pending is not None:
        sel, parts = pending
        nxt = next(work, None)
        pending = None if nxt is None else prep(nxt)
        cols = [_columns_ready(c, st) for c, st in zip(parts, streams)]
        yield sel, (cols[0] if mesh is None else cols)


def _on_mesh(fn, mesh, in_axes):
    """``fn`` as is on the single-device path, else split along the app
    axis of ``mesh`` (outputs carry apps on their last axis)."""
    return fn if mesh is None else shard_along_apps(fn, mesh, in_axes, -1)


def _host_rows(outs, k: int):
    """Each output tensor on the host as numpy, its first ``k`` apps (the
    rest are a sharded run's +inf padding rows)."""
    return tuple(x.cpu().numpy()[..., :k] for x in outs)


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
                     device: torch.device, mesh=None) -> dict:
    """S fixed keep-alive configs (``inf`` == never unload) in one float64
    pass: float32 would flip verdicts at the keep-alive boundary on
    multi-week clocks. ``padded`` is the trace's ``to_padded()`` pair;
    ``mesh`` splits the app rows across devices."""
    times, counts = padded if padded is not None else trace.to_padded()
    S, n = len(keeps), trace.n_apps
    cold = np.zeros((S, n), np.int64)
    waste = np.zeros((S, n), np.float64)
    ks = torch.tensor(np.asarray(keeps, np.float64)[:, None], device=device)
    duration = float(trace.duration_minutes)
    scan = _on_mesh(lambda cols, k: _fixed_scan(cols, k, duration,
                                                include_trailing),
                    mesh, (1, None))
    for sel, cols in _chunk_stream(_buckets(times, counts), device, mesh):
        cold[:, sel], waste[:, sel] = _host_rows(scan(cols, ks), len(sel))
    keep = np.broadcast_to(np.asarray(keeps, np.float64)[:, None],
                           (S, n)).copy()
    return dict(cold=cold, invocations=counts.astype(np.int64),
                wasted_minutes=waste, final_prewarm=np.zeros((S, n)),
                final_keep_alive=keep)


# --------------------------------------------------------------------------
# SPES predictor family
# --------------------------------------------------------------------------


def _spes_knobs(cfgs, device: torch.device) -> policy_math.SpesStepConfig:
    """Stack S predictor configs into [S, 1] knob columns on ``device``.
    Each goes through ``SpesStepConfig.from_host`` first, so host rounding
    (``1 - alpha``) happens once and the knobs equal the scalar policy's."""
    ks = [policy_math.SpesStepConfig.from_host(
        alpha=c.alpha, band_margin=c.band_margin, band_sigma=c.band_sigma,
        min_samples=c.min_samples, standard_keep=c.standard_keep_alive)
        for c in cfgs]
    col = lambda xs, dt: torch.from_numpy(
        np.asarray(xs, dt)[:, None]).to(device)
    return policy_math.SpesStepConfig(
        alpha=col([k.alpha for k in ks], np.float32),
        om_alpha=col([k.om_alpha for k in ks], np.float32),
        band_margin=col([k.band_margin for k in ks], np.float32),
        band_sigma=col([k.band_sigma for k in ks], np.float32),
        min_samples=col([k.min_samples for k in ks], np.int32),
        standard_keep=col([k.standard_keep for k in ks], np.float32))


def _spes_states(cols: torch.Tensor, knobs: policy_math.SpesStepConfig):
    """Yield the SPES step's state after each event column of one chunk
    (``cols`` [width, n] float64) for S stacked predictor configs (knob
    leaves [S, 1]): (prev_t [n], mean, var, n_obs [n], load, unload, cold,
    waste), the others [S, n]. The forecast state is float32, the clock
    and observation count config-independent."""
    n = cols.shape[1]
    S = knobs.alpha.shape[0]
    tdt, dev = cols.dtype, cols.device
    state = (
        torch.full((n,), -np.inf, dtype=tdt, device=dev),    # shared clock
        torch.zeros((S, n), dtype=torch.float32, device=dev),  # EW mean
        torch.zeros((S, n), dtype=torch.float32, device=dev),  # EW var
        torch.zeros((n,), dtype=torch.int32, device=dev),    # observations
        torch.zeros((S, n), dtype=tdt, device=dev),          # load bound
        knobs.standard_keep.to(tdt).expand(S, n),            # unload bound
        torch.zeros((S, n), dtype=torch.int32, device=dev),  # cold
        torch.zeros((S, n), dtype=tdt, device=dev),          # waste
    )
    for t_now in cols:
        state = policy_math.fused_spes_step_math(t_now, *state, cfg=knobs)
        yield state


def _spes_scan(cols: torch.Tensor, knobs: policy_math.SpesStepConfig):
    """Scan one chunk (``cols`` [width >= 1, n] float64) for S stacked
    predictor configs. Returns (cold [S, n], waste [S, n], last_t [n],
    load [S, n], unload [S, n])."""
    for state in _spes_states(cols, knobs):
        pass
    last_t, _, _, _, load, unload, cold, waste = state
    return cold, waste, last_t, load, unload


def _run_spes_sweep(trace: Trace, cfgs, include_trailing: bool = True, *,
                    app_chunk: Optional[int] = None, padded=None,
                    device: torch.device, mesh=None) -> dict:
    """S SPES predictor configs over one bucketed/chunked float64 pass on
    ``device`` (``mesh`` splits the app rows across devices). The float32
    decision state (``policy_math.spes_update`` rounds once from float64)
    makes it oracle-exact, waste included, so every engine runs this
    one."""
    times, counts = padded if padded is not None else trace.to_padded()
    S, n = len(cfgs), trace.n_apps
    knobs = _spes_knobs(cfgs, device)
    cold = np.zeros((S, n), np.int64)
    waste = np.zeros((S, n), np.float64)
    pre = np.zeros((S, n), np.float64)
    keep = np.empty((S, n), np.float64)
    for s, c in enumerate(cfgs):
        keep[s, :] = c.standard_keep_alive   # zero-event rows: never scanned
    duration = float(trace.duration_minutes)
    if app_chunk is None:
        chunk = max(DEFAULT_APP_CHUNK // max(S, 1), _MIN_AUTO_CHUNK)
    else:
        chunk = int(app_chunk)
    work = _chunked_buckets(times, counts, chunk)
    scan = _on_mesh(_spes_scan, mesh, (1, None))
    for sel, cols in _chunk_stream(work, device, mesh):
        c, w, last_t, lo, ub = _host_rows(scan(cols, knobs), len(sel))
        cold[:, sel] = c
        waste[:, sel], pre[:, sel], keep[:, sel] = _absolute_results(
            w, last_t, lo, ub, duration, include_trailing)
    return dict(cold=cold, invocations=counts.astype(np.int64),
                wasted_minutes=waste, final_prewarm=pre,
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


def _initial_carry(cfg_f32: torch.Tensor, n: int, n_bins: int,
                   tdt: torch.dtype) -> tuple:
    """The unfactored step's state (a histogram per config; the forecast
    post-pass's rescan) before a chunk's first column, for the S configs
    of ``cfg_f32`` x n apps: ``prev=-inf``, zero histogram and counters,
    bounds ``(0, standard_keep)`` — the decision of an empty histogram."""
    S, dev = cfg_f32.shape[0], cfg_f32.device
    zeros = lambda dt: torch.zeros((S, n), dtype=dt, device=dev)
    return (
        torch.full((S, n), -np.inf, dtype=tdt, device=dev),
        torch.zeros((S, n, n_bins), dtype=torch.int32, device=dev),
        zeros(torch.int32), zeros(tdt), zeros(tdt),
        zeros(tdt),                                        # prewarm
        cfg_f32[:, 6:7].to(tdt).repeat(1, n),              # unload_at
        zeros(torch.int32), zeros(tdt),
    )


def _sweep_block_host(
        cfgs: Sequence[HybridConfig]) -> policy_math.HybridSweepBlock:
    """Factor S hybrid configs into the group/window/gate/config layers on
    the host, leaf for leaf the reference's block (numpy, float64 bin
    widths).

    All configs share ``n_bins`` (the sweep bands by it); within a band
    the distinct (bin_minutes, n_bins) pairs become histogram groups, the
    distinct window and gate knob tuples become variants, and each config
    keeps only selector indices (``policy_math.HybridSweepBlock``)."""
    base = [_step_config_for(c) for c in cfgs]
    groups, g_of = {}, []
    for c in base:
        key = (float(c.bin_minutes), int(c.n_bins))
        g_of.append(groups.setdefault(key, len(groups)))
    wvars, w_of = {}, []
    for gi, c in zip(g_of, base):
        key = (gi, int(c.head_numer), int(c.tail_numer), float(c.bin_f32),
               float(c.range_f32), float(c.margin_lo), float(c.margin_hi))
        w_of.append(wvars.setdefault(key, len(wvars)))
    tvars, t_of = {}, []
    for gi, c in zip(g_of, base):
        key = (gi, int(c.min_samples), float(c.cv_threshold),
               float(c.oob_threshold))
        t_of.append(tvars.setdefault(key, len(tvars)))
    dvars, d_of = {}, []
    for c in base:
        d_of.append(dvars.setdefault(float(c.standard_keep), len(dvars)))
    col = lambda vals, dt: np.asarray(vals, dt)[:, None]
    gk, wk, tk = list(groups), list(wvars), list(tvars)
    return policy_math.HybridSweepBlock(
        g_bin_minutes=col([k[0] for k in gk], np.float64),
        g_n_bins=col([k[1] for k in gk], np.int32),
        w_group=np.asarray([k[0] for k in wk], np.int32),
        w_head_numer=col([k[1] for k in wk], np.int32),
        w_tail_numer=col([k[2] for k in wk], np.int32),
        w_bin_f32=col([k[3] for k in wk], np.float32),
        w_range_f32=col([k[4] for k in wk], np.float32),
        w_margin_lo=col([k[5] for k in wk], np.float32),
        w_margin_hi=col([k[6] for k in wk], np.float32),
        t_group=np.asarray([k[0] for k in tk], np.int32),
        t_min_samples=col([k[1] for k in tk], np.int32),
        t_cv_threshold=col([k[2] for k in tk], np.float32),
        t_oob_threshold=col([k[3] for k in tk], np.float32),
        d_standard_keep=col(list(dvars), np.float32),
        c_window=np.asarray(w_of, np.int32),
        c_gate=np.asarray(t_of, np.int32),
        c_std=np.asarray(d_of, np.int32),
    )


def _device_block(host: policy_math.HybridSweepBlock,
                  device) -> policy_math.HybridSweepBlock:
    """A host sweep block's leaves as tensors on ``device``."""
    dev = torch.device(device)
    return policy_math.HybridSweepBlock(
        *(torch.from_numpy(leaf).to(dev) for leaf in host))


def _build_sweep_block(cfgs: Sequence[HybridConfig],
                       device) -> policy_math.HybridSweepBlock:
    """:func:`_sweep_block_host` of ``cfgs`` as tensors on ``device``."""
    return _device_block(_sweep_block_host(cfgs), device)


def _sweep_identities(
        blk: policy_math.HybridSweepBlock) -> policy_math.SweepIdentities:
    """Which selectors of a host sweep block (numpy or CPU tensors) are the
    identity (all of them for a single config) — see
    ``policy_math.SweepIdentities``."""
    ident = lambda idx, m: (idx.shape[0] == m
                            and np.array_equal(np.asarray(idx), np.arange(m)))
    G = blk.g_n_bins.shape[0]
    W = blk.w_group.shape[0]
    T = blk.t_group.shape[0]
    D = blk.d_standard_keep.shape[0]
    return policy_math.SweepIdentities(
        w=ident(blk.w_group, G), t=ident(blk.t_group, G),
        c_window=ident(blk.c_window, W), c_gate=ident(blk.c_gate, T),
        c_std=ident(blk.c_std, D))


def _initial_sweep_carry(blk: policy_math.HybridSweepBlock, n: int,
                         n_bins: int, tdt: torch.dtype,
                         ids: policy_math.SweepIdentities =
                         policy_math.SweepIdentities()) -> tuple:
    """The factored sweep's state before a chunk's first column: the
    shared clock ``[n]`` at -inf, zero group state ``[G, n(, n_bins)]``,
    and per config ``[S, n]`` the bounds decide(zero state) = ``(0,
    standard_keep)``, zero cold counts and waste. The standard keep-alive
    rows are gathered to the configs unless ``ids.c_std`` proves the
    gather the identity."""
    G, S = blk.g_n_bins.shape[0], blk.c_window.shape[0]
    dev = blk.c_window.device
    zeros = lambda rows, dt: torch.zeros((rows, n), dtype=dt, device=dev)
    std = blk.d_standard_keep if ids.c_std else \
        blk.d_standard_keep.index_select(0, blk.c_std)
    return (
        torch.full((n,), -np.inf, dtype=tdt, device=dev),  # shared clock
        torch.zeros((G, n, n_bins), dtype=torch.int32, device=dev),
        zeros(G, torch.int32), zeros(G, tdt), zeros(G, tdt),
        zeros(S, tdt),                                     # load bound
        std.to(tdt).repeat(1, n),                          # unload bound
        zeros(S, torch.int32), zeros(S, tdt),
    )


def _hybrid_sweep_scan(cols: torch.Tensor,
                       blk: policy_math.HybridSweepBlock, plan, n_bins: int,
                       ids: policy_math.SweepIdentities, use_kernel: bool):
    """One factored sweep over a chunk: ``cols`` [width, n] float64 for
    all S configs of one band, through
    ``kernels.histogram.fused_hybrid_sweep_scan_factored`` (on the card
    one launch in the form ``plan`` picked) or its plain version. Returns
    (cold, waste, consulted, last_t, prewarm, unload_at); ``consulted``
    flags the apps at which the scalar policy consults the forecaster at
    some event."""
    from ..kernels import histogram as H
    _check_scan_width(cols.shape[0])
    state = _initial_sweep_carry(blk, cols.shape[1], n_bins, cols.dtype,
                                 ids)
    if use_kernel:
        out = H.fused_hybrid_sweep_scan_factored(cols, *state, blk=blk,
                                                 ids=ids, plan=plan)
    else:
        out = H.fused_hybrid_sweep_scan_factored_plain(cols, *state,
                                                       blk=blk, ids=ids)
    last_t, _, _, _, _, prewarm, unload_at, cold, waste, consulted = out
    return cold, waste, consulted, last_t, prewarm, unload_at


def _state_bytes_per_app(S: int, hists: int, n_bins: int) -> int:
    """Scan state a chunk carries per app: the shared clock, ``hists``
    histograms with their OOB count and Welford sums, and per config the
    bounds, cold count, waste and consulted flag."""
    return 8 + hists * (4 * n_bins + 4 + 16) + S * (8 + 8 + 4 + 8 + 1)


def _auto_chunk(blocks) -> int:
    """Apps per chunk when the caller sets none: ``DEFAULT_APP_CHUNK`` (the
    chunk of a single config) divided by how many times a single config's
    state the widest band's state is; ``blocks`` holds each band's (sweep
    block, n_bins). A band carries one histogram per group, and its
    per-config scalars; past the register form's width
    (``kernels.histogram.scan_form``) the kernel engine expands a band to
    one histogram per config, and the chunk allows for that."""
    from ..kernels.histogram import scan_form
    denom = 1
    for blk, n_bins in blocks:
        S, G = blk.c_window.shape[0], blk.g_n_bins.shape[0]
        hists = S if scan_form(n_bins)[0] == "columns" else G
        denom = max(denom, -(-_state_bytes_per_app(S, hists, n_bins)
                             // _state_bytes_per_app(1, 1, n_bins)))
    return max(DEFAULT_APP_CHUNK // denom, _MIN_AUTO_CHUNK)


def _run_hybrid_sweep(trace: Trace, hybrids: Sequence[HybridConfig],
                      include_trailing: bool = True, *,
                      app_chunk: Optional[int] = None,
                      use_kernel: bool, padded=None,
                      device: torch.device, mesh=None) -> dict:
    """S hybrid configs over one bucketed/chunked trace pass.

    Configs are banded by bin count (no config pays for another's wider
    histogram), and each band is factored into one sweep block
    (``_build_sweep_block``): within a band the histogram state is carried
    once per group. The trace preparation and each chunk's transfer are
    shared by every band. ``use_kernel`` scans each chunk through the scan
    kernel (one launch a chunk, band and shard on the card, in the form
    ``kernels.histogram.factored_scan_plan`` picks from the block),
    otherwise through its plain version; both in float64 time. ``mesh``
    splits each chunk's app rows across devices; the blocks replicate.
    Then the forecast post-pass of each ``use_arima`` config, on
    ``device``."""
    S = len(hybrids)
    times, counts = padded if padded is not None else trace.to_padded()
    n = trace.n_apps
    cold = np.zeros((S, n), np.int64)
    waste = np.zeros((S, n), np.float64)
    pre = np.zeros((S, n), np.float64)
    keep = np.empty((S, n), np.float64)
    consulted = np.zeros((S, n), bool)
    for s, h in enumerate(hybrids):
        keep[s, :] = h.standard_keep_alive     # zero-event apps: never scanned
    duration = float(trace.duration_minutes)

    from ..kernels.histogram import factored_scan_plan
    band_of = {}
    for s, h in enumerate(hybrids):
        band_of.setdefault(h.histogram.n_bins, []).append(s)
    bands = []
    for n_bins, idx in sorted(band_of.items()):
        host = _sweep_block_host([hybrids[s] for s in idx])
        ids = _sweep_identities(host)
        plan = factored_scan_plan(host, ids, n_bins, device) \
            if use_kernel else None
        bands.append((np.asarray(idx), _device_block(host, device), ids,
                      plan, n_bins))
    chunk = int(app_chunk) if app_chunk is not None else _auto_chunk(
        [(blk, n_bins) for _, blk, _, _, n_bins in bands])

    band_scan = _on_mesh(
        lambda cols, blk, ids, plan, n_bins: _hybrid_sweep_scan(
            cols, blk, plan, n_bins, ids, use_kernel),
        mesh, (1, None, None, None, None))
    work = _chunked_buckets(times, counts, chunk)
    for sel, cols in _chunk_stream(work, device, mesh):
        for idx, blk, ids, plan, n_bins in bands:
            c, w, flag, last_t, pw, ub = _host_rows(
                band_scan(cols, blk, ids, plan, n_bins), len(sel))
            at = np.ix_(idx, sel)
            cold[at] = c
            consulted[at] = flag
            waste[at], pre[at], keep[at] = _absolute_results(
                w, last_t, pw, ub, duration, include_trailing)

    # Forecast post-pass: each use_arima config's apps at which the scalar
    # policy consults the forecaster at some event (OOB-heavy with enough
    # samples, mid-trace included) replay through the batched forecasting
    # subsystem (a rescan, one grid fit of every forecaster window, the
    # cadence on the host), bit-identical to the scalar policy (see
    # repro_torch.forecast.replay). Every other app never takes the ARIMA
    # branch, so the scan's results are already the scalar policy's.
    for s, h in enumerate(hybrids):
        if h.use_arima and consulted[s].any():
            from ..forecast.replay import replay_oob_apps
            aidx = np.where(consulted[s])[0]
            out = replay_oob_apps(times, counts, duration, h, aidx,
                                  include_trailing, device=device,
                                  use_kernel=use_kernel)
            cold[s, aidx] = out["cold"]
            waste[s, aidx] = out["wasted_minutes"]
            pre[s, aidx] = out["final_prewarm"]
            keep[s, aidx] = out["final_keep_alive"]
    return dict(cold=cold, invocations=counts.astype(np.int64),
                wasted_minutes=waste, final_prewarm=pre,
                final_keep_alive=keep)


# --------------------------------------------------------------------------
# The pre-sweep float32 engine (engine="reference")
# --------------------------------------------------------------------------


def _hybrid_step_reference(cfg: HistogramConfig, hybrid: HybridConfig, carry,
                           t_now: torch.Tensor):
    """The reference's pre-sweep step: raw counts and a full [n_apps,
    n_bins] cumsum and masked percentile search per step, in the carry's
    float32 time. Decisions through the single-source helpers; where the
    reference's compiled program folds its constants (the bin width and
    count, the window factors) through the ``policy_math.folded_*``
    helpers. Also returns the per-row "forecaster consulted" flag after
    this event (enough samples AND OOB-heavy,
    ``HybridHistogramPolicy._decide``'s guard)."""
    (prev_t, counts, total, oob, cv_sum, cv_sum_sq, prewarm, unload_at,
     cold, waste) = carry
    valid = torch.isfinite(t_now)
    first = ~torch.isfinite(prev_t)
    it = t_now - prev_t

    warm = policy_math.warm_from_bounds(it, prewarm, unload_at)
    is_cold = valid & (first | ~warm)
    gap_waste = torch.where(valid & ~first,
                            policy_math.idle_from_bounds(it, prewarm,
                                                         unload_at), 0.0)

    rec = valid & ~first
    safe, in_b, oob_hit = policy_math.folded_idle_bins(
        it, rec, cfg.bin_minutes, cfg.n_bins)
    flat = torch.arange(counts.shape[0], device=counts.device) \
        * cfg.n_bins + safe.long()
    old = counts.view(-1)[flat]
    counts.view(-1)[flat] = old + in_b.to(torch.int32)   # IN PLACE
    total = total + in_b.to(torch.int32)
    oob = oob + oob_hit.to(torch.int32)
    cv_sum, cv_sum_sq = policy_math.welford_update(cv_sum, cv_sum_sq, in_b,
                                                   old)

    cum = torch.cumsum(counts, dim=-1, dtype=torch.int32)
    head_bin = policy_math.first_bin_ge_scaled(
        cum, policy_math.percentile_threshold_scaled(
            total, cfg.head_percentile), gather=False)
    tail_bin = policy_math.first_bin_ge_scaled(
        cum, policy_math.percentile_threshold_scaled(
            total, cfg.tail_percentile), gather=False) + 1
    new_load, new_unload = policy_math.folded_window_values(
        head_bin, tail_bin, cfg.bin_minutes, cfg.range_minutes, cfg.margin)
    use_hist = policy_math.use_histogram_gate_from_cv(
        total, oob, policy_math.folded_bin_count_cv(cv_sum, cv_sum_sq,
                                                    cfg.n_bins),
        hybrid.min_samples, hybrid.cv_threshold,
        hybrid.oob_fraction_threshold)
    std_load, std_unload = policy_math.standard_window_bounds(
        hybrid.standard_keep_alive)
    new_load = torch.where(use_hist, new_load, float(std_load))
    new_unload = torch.where(use_hist, new_unload, float(std_unload))
    consulted = valid & ((total + oob) >= hybrid.min_samples) \
        & policy_math.oob_heavy(total, oob, hybrid.oob_fraction_threshold)

    prewarm = torch.where(valid, new_load, prewarm)
    unload_at = torch.where(valid, new_unload, unload_at)
    prev_t = torch.where(valid, t_now, prev_t)
    return (prev_t, counts, total, oob, cv_sum, cv_sum_sq, prewarm,
            unload_at, cold + is_cold.to(torch.int32),
            waste + gap_waste), consulted


def _hybrid_scan_reference(cols: torch.Tensor, cfg: HistogramConfig,
                           hybrid: HybridConfig):
    """Scan one bucket (``cols`` [width, n] float32, rebased) through
    :func:`_hybrid_step_reference`. Returns (cold, waste, consulted,
    last_t, prewarm, unload_at), each [n]; ``consulted`` is the OR over
    the columns of the step's flag."""
    n, dev = cols.shape[1], cols.device
    f32, i32 = torch.float32, torch.int32
    zeros = lambda dt: torch.zeros((n,), dtype=dt, device=dev)
    carry = (
        torch.full((n,), -np.inf, dtype=f32, device=dev),
        torch.zeros((n, cfg.n_bins), dtype=i32, device=dev),
        zeros(i32), zeros(i32), zeros(f32), zeros(f32),
        zeros(f32),                                                  # prewarm
        torch.full((n,), float(np.float32(hybrid.standard_keep_alive)),
                   dtype=f32, device=dev),                           # unload
        zeros(i32), zeros(f32),
    )
    consulted = zeros(torch.bool)
    for t_now in cols:
        carry, flag = _hybrid_step_reference(cfg, hybrid, carry, t_now)
        consulted |= flag
    (last_t, _, _, _, _, _, prewarm, unload_at, cold, waste) = carry
    return cold, waste, consulted, last_t, prewarm, unload_at


def _simulate_hybrid_batch_reference(trace: Trace, hybrid: HybridConfig,
                                     include_trailing: bool = True,
                                     padded=None, *,
                                     device: torch.device) -> SimResult:
    """The reference's pre-sweep batched hybrid engine on ``device``, in
    plain PyTorch: float32 time rebased per bucket by each app's first
    event (in float64 on the host), a per-step cumsum, one config.

    It is float32 on purpose: it reproduces the reference's float32
    numbers, including the apps where float32 rebased time differs from
    the float64 engines (an idle time rounds across a bin edge; ROADMAP
    Queue C). With ``use_arima`` the forecast post-pass takes the apps the
    scan flags as consulting the forecaster at some event, not the
    reference's final-state OOB-heavy apps: that selection misses apps
    that consult it only mid-trace, a fault of the reference repaired in
    the port only (ROADMAP Queue C)."""
    times, counts = padded if padded is not None else trace.to_padded()
    n = trace.n_apps
    cold = np.zeros(n, np.int64)
    waste = np.zeros(n, np.float64)
    pre = np.zeros(n, np.float64)
    keep = np.full(n, hybrid.standard_keep_alive, np.float64)
    consulted = np.zeros(n, bool)
    duration = float(trace.duration_minutes)
    for sel, sub in _buckets(times, counts):
        _check_scan_width(sub.shape[1])
        sub, t0 = _rebase_chunk(sub)
        cols = torch.from_numpy(np.ascontiguousarray(
            sub.T, np.float32)).to(device)
        c, w, flag, last_t, pw, ub = (
            x.cpu().numpy() for x in _hybrid_scan_reference(
                cols, hybrid.histogram, hybrid))
        cold[sel] = c
        consulted[sel] = flag
        waste[sel], pre[sel], keep[sel] = _absolute_results(
            w, last_t, pw, ub, duration, include_trailing, t0)
    if hybrid.use_arima and consulted.any():
        from ..forecast.replay import replay_oob_apps
        aidx = np.where(consulted)[0]
        out = replay_oob_apps(times, counts, duration, hybrid, aidx,
                              include_trailing, device=device,
                              use_kernel=False)
        cold[aidx] = out["cold"]
        waste[aidx] = out["wasted_minutes"]
        pre[aidx] = out["final_prewarm"]
        keep[aidx] = out["final_keep_alive"]
    return SimResult(cold, counts.astype(np.int64), waste, pre, keep)
