"""The hybrid-policy sweep step and the fleet's policy-update tick: CUDA
kernels for Hopper and their plain PyTorch versions.

:func:`fused_hybrid_sweep_step` is one simulator step for S stacked policy
configurations x the whole fleet — the port of the TPU kernel
``repro/kernels/histogram.py::fused_hybrid_sweep_step_pallas`` (body
``_sweep_step_kernel``). On CUDA tensors it launches
``csrc/hybrid_sweep_step.cu`` (see the note at the top of that file for
its design and its bound on the card); on CPU tensors it runs
:func:`fused_hybrid_sweep_step_plain`, the same step written with PyTorch
ops over :mod:`repro_torch.core.policy_math`. There is no fallback: a CUDA
tensor either reaches the kernel or the call raises.

State contract (both versions): ``cum`` ``[S, n, n_bins]`` int32 is
updated IN PLACE and returned as the second output — it is the one large
state (about 0.96 GB at a million apps and 240 bins); the other eight
outputs are new tensors.

:func:`fused_hybrid_sweep_scan` is the step over every event column of a
chunk in one call — the port of the reference's ``lax.scan`` over the TPU
kernel (``repro/core/simulator.py``), with the loop moved into the kernel:
on CUDA tensors one launch of the scan kernel in the same source (each
row's histogram kept on chip across the columns, in the form
:func:`scan_form` picks from the row width), on CPU tensors
:func:`fused_hybrid_sweep_scan_plain` (the plain step iterated). Its
outputs are the iterated step's, bit for bit, and the per-row flag "the
forecaster was consulted" that selects the apps of the ARIMA post-pass.
The step stays: it is the S=1 parity surface and what the scan is held to
on the card.

:func:`policy_update` is one control-plane tick for the whole fleet — the
port of ``repro/kernels/histogram.py::policy_update_pallas`` (body
``_policy_kernel``): on CUDA tensors ``csrc/policy_update.cu`` (a warp
per 32 rows, in the form :func:`_policy_form` picks), on CPU tensors
:func:`policy_update_plain`. Its raw ``counts`` ``[n, n_bins]`` are
likewise updated in place and returned first.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from ..core import policy_math
from . import build

__all__ = ["CFG_I32_COLS", "CFG_F32_COLS", "LAUNCHES",
           "POLICY_UPDATE_LAUNCHES", "SCAN_LAUNCHES", "SCAN_LAUNCHES_BY_FORM",
           "SCAN_BINS_PER_LANE", "FACTORED_CONFIGS_PER_LANE", "ScanPlan",
           "ExpandedLayout", "FactoredLayout",
           "fused_hybrid_sweep_step",
           "fused_hybrid_sweep_step_plain", "fused_hybrid_sweep_scan",
           "fused_hybrid_sweep_scan_plain", "fused_hybrid_sweep_scan_factored",
           "fused_hybrid_sweep_scan_factored_plain", "factored_scan_plan",
           "fused_hybrid_step", "policy_update", "policy_update_plain",
           "scan_form"]

# Column layout of the per-config knob blocks (built by
# ``repro_torch.core.simulator._build_cfg_blocks``).
CFG_I32_COLS = ("n_bins", "head_numer", "tail_numer", "min_samples")
CFG_F32_COLS = ("margin_lo", "margin_hi", "bin_minutes", "range_f32",
                "cv_threshold", "oob_threshold", "standard_keep")

#: Sweep-step kernel launches made by this process (plain-version calls do
#: not count).
LAUNCHES = 0
#: Policy-update kernel launches made by this process.
POLICY_UPDATE_LAUNCHES = 0
#: Sweep-scan calls that reached the card (one launch each, but for the
#: ``columns`` form, which launches the step once a column), and the same
#: by form (:func:`scan_form`; ``factored``: :func:`factored_scan_plan`).
SCAN_LAUNCHES = 0
SCAN_LAUNCHES_BY_FORM = {"registers": 0, "columns": 0, "factored": 0}

#: Bins a lane of the scan's register form may hold (a warp a row): 2 for
#: rows of up to 64 bins (the sweep point's 60), 8 for up to 256 (the
#: paper's 240). ``csrc/hybrid_sweep_step.cu`` instantiates these two.
SCAN_BINS_PER_LANE = (2, 8)

#: Configs a lane of the factored form carries: a group of up to 32 x 2 =
#: 64 configs a warp (``csrc/hybrid_sweep_step.cu`` instantiates both; a
#: larger group is split by :func:`factored_scan_plan`).
FACTORED_CONFIGS_PER_LANE = (1, 2)


def _step_config(cfg_i32, cfg_f32, bin_minutes=None
                 ) -> policy_math.HybridStepConfig:
    col_i = lambda k: cfg_i32[:, k:k + 1]
    col_f = lambda k: cfg_f32[:, k:k + 1]
    return policy_math.HybridStepConfig(
        n_bins=col_i(0), head_numer=col_i(1), tail_numer=col_i(2),
        min_samples=col_i(3), margin_lo=col_f(0), margin_hi=col_f(1),
        bin_minutes=col_f(2) if bin_minutes is None else bin_minutes[:, None],
        bin_f32=col_f(2), range_f32=col_f(3), cv_threshold=col_f(4),
        oob_threshold=col_f(5), standard_keep=col_f(6))


def fused_hybrid_sweep_step_plain(t_now, prev_t, cum, oob, cv_sum, cv_sum_sq,
                                  prewarm, unload_at, cold, waste, cfg_i32,
                                  cfg_f32, *, bin_minutes=None):
    """The step in plain PyTorch ops, on any device and in any time dtype.

    Shapes as :func:`fused_hybrid_sweep_step`. The time layer (``t_now``,
    ``prev_t``, bounds, waste, CV accumulators) runs in ``t_now.dtype``:
    float64 in the simulator's engines, float32 as in the TPU kernel when
    it is held against that kernel. The IT binning divisor is
    ``cfg_f32[:, 2]`` unless ``bin_minutes`` ``[S]`` gives it in the time
    dtype (the exact float64 bin width). ``cum`` is updated in place."""
    return policy_math.fused_hybrid_step_math(
        t_now, prev_t, cum, oob, cv_sum, cv_sum_sq, prewarm, unload_at, cold,
        waste, cfg=_step_config(cfg_i32, cfg_f32, bin_minutes), gather=True)


def _check_cuda_args(args, bin_minutes) -> None:
    t_now, cum = args[0], args[2]
    S, n, n_bins = cum.shape
    dev, tdt = t_now.device, torch.float64
    i32 = torch.int32
    dtypes = (tdt, tdt, i32, i32, tdt, tdt, tdt, tdt, i32, tdt, i32,
              torch.float32, tdt)
    shapes = [(n,), (S, n), (S, n, n_bins)] + [(S, n)] * 7 + \
        [(S, len(CFG_I32_COLS)), (S, len(CFG_F32_COLS)), (S,)]
    for k, (x, dt, shape) in enumerate(zip((*args, bin_minutes), dtypes,
                                           shapes)):
        if x.device != dev or x.dtype != dt or tuple(x.shape) != shape \
                or not x.is_contiguous():
            raise ValueError(
                f"fused_hybrid_sweep_step: argument {k} must be a contiguous "
                f"{dt} tensor of shape {shape} on {dev}, got {x.dtype} "
                f"{tuple(x.shape)} on {x.device}")
    if n_bins < 1:
        raise ValueError("fused_hybrid_sweep_step: n_bins must be >= 1")


def _launch(args, bin_minutes):
    global LAUNCHES
    t_now, cum = args[0], args[2]
    if bin_minutes is None:
        bin_minutes = args[11][:, 2].to(torch.float64).contiguous()
    _check_cuda_args(args, bin_minutes)
    S, n, n_bins = cum.shape
    outs = [torch.empty_like(x) for x in (args[1], *args[3:10])]
    build.launch("hybrid_sweep_step", "hybrid_sweep_step", cum.device,
                 *(x.data_ptr() for x in (*args, bin_minutes)),
                 *(o.data_ptr() for o in outs), S, n, n_bins)
    LAUNCHES += 1
    o_prev, o_oob, o_cvs, o_cvss, o_pre, o_unload, o_cold, o_waste = outs
    return (o_prev, cum, o_oob, o_cvs, o_cvss, o_pre, o_unload, o_cold,
            o_waste)


def fused_hybrid_sweep_step(t_now, prev_t, cum, oob, cv_sum, cv_sum_sq,
                            prewarm, unload_at, cold, waste, cfg_i32,
                            cfg_f32, *, bin_minutes=None):
    """One fused hybrid-simulator step for S configs x the whole fleet.

    ``t_now`` ``[n]`` is the event column shared by every config (``+inf`` =
    no event); per-config state is ``[S, n]`` (``prev_t``, ``oob`` i32,
    ``cv_sum``/``cv_sum_sq``, the residency bounds ``prewarm``/``unload_at``,
    ``cold`` i32, ``waste``) and ``cum`` ``[S, n, n_bins]`` int32 cumulative
    in-bounds counts (updated in place). The kernel's time layer is float64
    (the TPU kernel's is float32, rebased per chunk); ``bin_minutes`` ``[S]``
    float64 overrides the binning divisor ``cfg_f32[:, 2]``.
    ``cfg_i32`` ``[S, 4]`` / ``cfg_f32`` ``[S, 7]`` are the knob blocks
    (``CFG_I32_COLS`` / ``CFG_F32_COLS``). Returns the updated (prev_t, cum,
    oob, cv_sum, cv_sum_sq, prewarm, unload_at, cold, waste).

    CPU tensors run the plain version, in any time dtype; CUDA tensors
    launch the kernel (and count one launch in ``LAUNCHES``) or raise."""
    args = (t_now, prev_t, cum, oob, cv_sum, cv_sum_sq, prewarm, unload_at,
            cold, waste, cfg_i32, cfg_f32)
    if t_now.device.type == "cpu":
        return fused_hybrid_sweep_step_plain(*args, bin_minutes=bin_minutes)
    if t_now.device.type == "cuda":
        return _launch(args, bin_minutes)
    raise ValueError(f"fused_hybrid_sweep_step: no kernel for device "
                     f"{t_now.device}")


def fused_hybrid_step(t_now, prev_t, cum, oob, cv_sum, cv_sum_sq, prewarm,
                      unload_at, cold, waste, *, head_pct=5.0, tail_pct=99.0,
                      margin=0.10, bin_minutes=1.0, range_minutes=240.0,
                      cv_threshold=2.0, min_samples=5, oob_threshold=0.5,
                      standard_keep=240.0):
    """Single-config step: the S=1 slice of :func:`fused_hybrid_sweep_step`
    (state ``[n]``, ``cum`` ``[n, n_bins]``, updated in place). The knobs are
    packed into one-row config blocks exactly as the sweep driver would
    (``HybridStepConfig.from_host`` owns the rounding)."""
    n_bins = cum.shape[-1]
    c = policy_math.HybridStepConfig.from_host(
        n_bins=n_bins, head_pct=head_pct, tail_pct=tail_pct, margin=margin,
        bin_minutes=bin_minutes, range_minutes=range_minutes,
        cv_threshold=cv_threshold, min_samples=min_samples,
        oob_threshold=oob_threshold, standard_keep=standard_keep)
    dev = t_now.device
    cfg_i32 = torch.tensor(
        [[c.n_bins, c.head_numer, c.tail_numer, c.min_samples]],
        dtype=torch.int32, device=dev)
    cfg_f32 = torch.from_numpy(np.asarray(
        [[c.margin_lo, c.margin_hi, c.bin_f32, c.range_f32, c.cv_threshold,
          c.oob_threshold, c.standard_keep]], np.float32)).to(dev)
    outs = fused_hybrid_sweep_step(
        t_now, prev_t[None], cum[None], oob[None], cv_sum[None],
        cv_sum_sq[None], prewarm[None], unload_at[None], cold[None],
        waste[None], cfg_i32, cfg_f32)
    return tuple(o[0] for o in outs)


# ---------------------------------------------------------------------------
# The scan of a chunk: every event column in one launch
# ---------------------------------------------------------------------------


def scan_form(n_bins: int) -> tuple:
    """The scan kernel's form for rows of ``n_bins`` bins: ``("registers",
    bins_per_lane)`` with the fewest bins a lane of ``SCAN_BINS_PER_LANE``
    that cover the row (up to 32 x 8 = 256 bins), else ``("columns", 0)``
    (the step, one launch a column)."""
    if n_bins < 1:
        raise ValueError(f"scan_form: n_bins must be >= 1, got {n_bins}")
    for bpl in SCAN_BINS_PER_LANE:
        if n_bins <= 32 * bpl:
            return "registers", bpl
    return "columns", 0


def _consulted_after(t_now, total, oob, min_samples, oob_threshold):
    """Whether the scalar policy consults the forecaster after the event
    column ``t_now`` ``[n]``, per row: an event, enough recorded samples
    AND the OOB counter heavy (the guard of
    ``HybridHistogramPolicy._decide`` that ``forecast/replay.py::
    _branch_scan`` evaluates), on the post-update in-bounds ``total`` and
    ``oob`` counts, against ``[rows, 1]`` knobs."""
    heavy = policy_math.oob_heavy(total, oob, oob_threshold)
    return heavy & ((total + oob) >= min_samples) & \
        torch.isfinite(t_now)[None]


def _consulted_after_step(t_now, state, cfg_i32, cfg_f32):
    """:func:`_consulted_after` on the step's post-update ``state``, per
    config ``[S, n]``."""
    return _consulted_after(t_now, state[1][..., -1], state[2],
                            cfg_i32[:, 3:4], cfg_f32[:, 5:6])


def fused_hybrid_sweep_scan_plain(cols, prev_t, cum, oob, cv_sum, cv_sum_sq,
                                  prewarm, unload_at, cold, waste, cfg_i32,
                                  cfg_f32, *, bin_minutes=None):
    """:func:`fused_hybrid_sweep_step_plain` over the event columns ``cols``
    ``[width, n]`` in order, on any device and in any time dtype; ``cum`` is
    updated in place. Returns the step's nine outputs and ``consulted``
    ``[S, n]`` bool, the OR over the columns of :func:`_consulted_after`."""
    state = (prev_t, cum, oob, cv_sum, cv_sum_sq, prewarm, unload_at, cold,
             waste)
    consulted = torch.zeros(oob.shape, dtype=torch.bool, device=oob.device)
    for t_now in cols:
        state = fused_hybrid_sweep_step_plain(t_now, *state, cfg_i32,
                                              cfg_f32,
                                              bin_minutes=bin_minutes)
        consulted |= _consulted_after_step(t_now, state, cfg_i32, cfg_f32)
    return (*state, consulted)


def _check_cols(cols, n) -> None:
    if cols.dim() != 2 or cols.shape[1] != n:
        raise ValueError(f"fused_hybrid_sweep_scan: cols must be [width, "
                         f"{n}] event columns, got {tuple(cols.shape)}")


def _check_scan_args(cols, args, bin_minutes) -> None:
    """What the scan kernel takes: contiguous float64 ``cols`` ``[width,
    n]`` on the state's device, and the step's state and config blocks."""
    cum = args[1]
    _check_cols(cols, cum.shape[1])
    if cols.dtype != torch.float64 or cols.device != cum.device \
            or not cols.is_contiguous():
        raise ValueError(f"fused_hybrid_sweep_scan: cols must be a "
                         f"contiguous float64 tensor on {cum.device}, got "
                         f"{cols.dtype} on {cols.device}")
    # the step's own checks, with a stand-in event column
    _check_cuda_args((cols[0] if cols.shape[0] else
                      cols.new_empty((cum.shape[1],)), *args), bin_minutes)


def _scan_launch(cols, args, bin_minutes):
    global SCAN_LAUNCHES
    cfg_f32 = args[10]
    if bin_minutes is None:
        bin_minutes = cfg_f32[:, 2].to(torch.float64).contiguous()
    _check_scan_args(cols, args, bin_minutes)
    cum = args[1]
    S, n, n_bins = cum.shape
    form, bpl = scan_form(n_bins)
    if form == "columns":
        state = args[:9]
        consulted = torch.zeros((S, n), dtype=torch.bool, device=cum.device)
        for t_now in cols:
            state = _launch((t_now, *state, *args[9:]), bin_minutes)
            consulted |= _consulted_after_step(t_now, state, args[9],
                                               cfg_f32)
        SCAN_LAUNCHES += 1
        SCAN_LAUNCHES_BY_FORM[form] += 1
        return (*state, consulted)
    outs = [torch.empty_like(x) for x in (args[0], *args[2:9])]
    consulted = torch.empty((S, n), dtype=torch.bool, device=cum.device)
    build.launch("hybrid_sweep_step", "hybrid_sweep_scan", cum.device,
                 cols.data_ptr(), cols.shape[0],
                 *(x.data_ptr() for x in (*args, bin_minutes)),
                 *(o.data_ptr() for o in outs), consulted.data_ptr(), S, n,
                 n_bins, bpl, what="hybrid_sweep_scan")
    SCAN_LAUNCHES += 1
    SCAN_LAUNCHES_BY_FORM[form] += 1
    o_prev, o_oob, o_cvs, o_cvss, o_pre, o_unload, o_cold, o_waste = outs
    return (o_prev, cum, o_oob, o_cvs, o_cvss, o_pre, o_unload, o_cold,
            o_waste, consulted)


def fused_hybrid_sweep_scan(cols, prev_t, cum, oob, cv_sum, cv_sum_sq,
                            prewarm, unload_at, cold, waste, cfg_i32,
                            cfg_f32, *, bin_minutes=None):
    """:func:`fused_hybrid_sweep_step` over every event column of ``cols``
    ``[width, n]`` (``+inf`` = no event), in one call: returns exactly what
    the step iterated over the columns returns, the nine tensors in the
    step's order, with ``cum`` updated in place, and a tenth, ``consulted``
    ``[S, n]`` bool: whether the scalar policy would consult the forecaster
    after some event of the row (enough samples, OOB-heavy), the selection
    of the ARIMA post-pass.

    CPU tensors run :func:`fused_hybrid_sweep_scan_plain`, in any time
    dtype; CUDA tensors (float64 ``cols`` and time) launch the scan kernel
    in the form :func:`scan_form` picks from ``n_bins`` (counted in
    ``SCAN_LAUNCHES`` and ``SCAN_LAUNCHES_BY_FORM``) or raise. ``cols``
    must be ``[width, n]`` on every device."""
    args = (prev_t, cum, oob, cv_sum, cv_sum_sq, prewarm, unload_at, cold,
            waste, cfg_i32, cfg_f32)
    _check_cols(cols, cum.shape[-2] if cum.dim() >= 2 else -1)
    if cols.device.type == "cpu":
        return fused_hybrid_sweep_scan_plain(cols, *args,
                                             bin_minutes=bin_minutes)
    if cols.device.type == "cuda":
        return _scan_launch(cols, args, bin_minutes)
    raise ValueError(f"fused_hybrid_sweep_scan: no kernel for device "
                     f"{cols.device}")


# ---------------------------------------------------------------------------
# The factored scan: a sweep block's S configs over a chunk in one launch
# ---------------------------------------------------------------------------


def _consulted_after_factored(t_now, state, blk, ids):
    """:func:`_consulted_after` per gate variant on the factored step's
    post-update group ``state``, gathered to the configs: ``[S, n]``."""
    sel_t = (lambda x: x) if ids.t else \
        (lambda x: x.index_select(0, blk.t_group))
    flag = _consulted_after(t_now, sel_t(state[1][..., -1]),
                            sel_t(state[2]), blk.t_min_samples,
                            blk.t_oob_threshold)
    return flag if ids.c_gate else flag.index_select(0, blk.c_gate)


def fused_hybrid_sweep_scan_factored_plain(
        cols, prev_t, gcum, goob, gcv_sum, gcv_sum_sq, load_c, unload_c,
        cold, waste, *, blk: policy_math.HybridSweepBlock,
        ids: policy_math.SweepIdentities = policy_math.SweepIdentities()):
    """``policy_math.fused_hybrid_sweep_step_math`` over the event columns
    ``cols`` ``[width, n]`` in order, on any device and in any time dtype;
    ``gcum`` is updated in place. Returns the factored step's nine outputs
    (prev_t ``[n]``, the group state ``[G, n(, n_bins)]``, the per-config
    bounds, cold counts and waste ``[S, n]``) and ``consulted`` ``[S, n]``
    bool, the OR over the columns of the forecaster guard, evaluated per
    gate variant and gathered to the configs."""
    state = (prev_t, gcum, goob, gcv_sum, gcv_sum_sq, load_c, unload_c,
             cold, waste)
    consulted = torch.zeros(cold.shape, dtype=torch.bool, device=cold.device)
    for t_now in cols:
        state = policy_math.fused_hybrid_sweep_step_math(t_now, *state,
                                                         blk=blk, ids=ids)
        consulted |= _consulted_after_factored(t_now, state, blk, ids)
    return (*state, consulted)


class ExpandedLayout(NamedTuple):
    """What the ``registers`` and ``columns`` forms read: the unfactored
    scan's per-config knob blocks, and how the group state expands to the
    configs (``c_group`` and ``first`` are None for an identity block)."""
    cfg_i32: torch.Tensor          # [S, 4] (n_bins, head, tail, min_samples)
    cfg_f32: torch.Tensor          # [S, 7] (the step's float knobs)
    bin_minutes: torch.Tensor      # [S] float64
    c_group: Optional[torch.Tensor]  # [S] int64: each config's group
    first: Optional[torch.Tensor]    # [G] int64: each group's first config


class FactoredLayout(NamedTuple):
    """What the ``factored`` form reads: the kernel's groups (a block's
    groups, those of more than 64 configs split), each a contiguous range
    of config slots and of percentile searches."""
    grp_i32: torch.Tensor     # [Gk, 5] n_bins, slot0, slot1, search0, search1
    grp_f64: torch.Tensor     # [Gk] bin minutes
    search_i32: torch.Tensor  # [Q, 2] (head, tail) numerators
    slot_i32: torch.Tensor    # [S, 3] (config row, search, min_samples)
    slot_f32: torch.Tensor    # [S, 7] the slot's config's float knobs
    k_group: Optional[torch.Tensor]  # [Gk] int64 block group; None: no split
    first_k: Optional[torch.Tensor]  # [G] int64 a group's first kernel group


class ScanPlan(NamedTuple):
    """How :func:`fused_hybrid_sweep_scan_factored` scans a sweep block on
    the card, picked on the host from the block before any launch
    (:func:`factored_scan_plan`)."""
    form: str              # "registers", "columns" or "factored"
    bins_per_lane: int     # registers and factored: 2 or 8
    configs_per_lane: int  # factored: 1 or 2 (FACTORED_CONFIGS_PER_LANE)
    layout: Union[ExpandedLayout, FactoredLayout]


def factored_scan_plan(blk: policy_math.HybridSweepBlock,
                       ids: policy_math.SweepIdentities, n_bins: int,
                       device) -> ScanPlan:
    """The form the scan takes for the host block ``blk`` (numpy or CPU
    tensors; ``n_bins`` bins allocated) and its layout, computed on the
    host and put on ``device``:

      * ``registers``: every selector is the identity (``ids``; a single
        config among them), so each config has its own histogram: the
        unfactored scan kernel in its register form, the configs' knob
        blocks built from the block;
      * ``factored``: the configs share a layer, up to 256 bins: one warp
        per (group, app) with the group's bins in registers, the configs
        sorted by group, lane k of a group's warp carrying its config k
        (and k + 32). A group of more than 64 configs is split into groups
        of at most 64 that each carry a copy of its histogram (exact: the
        copies see the same events). Each group's percentile searches are
        its configs' distinct (head, tail) numerators;
      * ``columns``: past 256 bins the band's configs expand to per-config
        rows (each group's histogram copied to its configs) and go
        through the unfactored scan's columns form, the step once a
        column.
    """
    host = {k: np.asarray(v) for k, v in blk._asdict().items()}
    G = len(host["g_n_bins"])
    win, gate, std = host["c_window"], host["c_gate"], host["c_std"]
    c_group = host["w_group"][win].astype(np.int64)
    if not np.array_equal(host["t_group"][gate], c_group) or \
            set(c_group.tolist()) != set(range(G)):
        raise ValueError("factored_scan_plan: each config's gate must read "
                         "its window's group, and every group needs a "
                         "config")
    dev = torch.device(device)
    put = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a, dt)).to(dev)
    col = lambda name, idx: host[name][idx, 0]
    f32_cols = lambda w, t, d: np.stack(
        [col("w_margin_lo", w), col("w_margin_hi", w), col("w_bin_f32", w),
         col("w_range_f32", w), col("t_cv_threshold", t),
         col("t_oob_threshold", t), col("d_standard_keep", d)], 1)
    form, bpl = scan_form(n_bins)
    identity = all(ids)
    if form == "columns" or identity:
        cfg_i32 = np.stack([col("g_n_bins", c_group), col("w_head_numer", win),
                            col("w_tail_numer", win),
                            col("t_min_samples", gate)], 1)
        first = np.asarray([np.flatnonzero(c_group == g)[0]
                            for g in range(G)])
        return ScanPlan(form, bpl, 0, ExpandedLayout(
            put(cfg_i32, np.int32), put(f32_cols(win, gate, std), np.float32),
            put(col("g_bin_minutes", c_group), np.float64),
            None if identity else put(c_group, np.int64),
            None if identity else put(first, np.int64)))

    cap = 32 * FACTORED_CONFIGS_PER_LANE[-1]
    pieces = [(g, part) for g in range(G)
              for part in np.array_split(
                  np.flatnonzero(c_group == g),
                  -(-int((c_group == g).sum()) // cap))]
    widest = max(len(part) for _, part in pieces)
    cpl = next(c for c in FACTORED_CONFIGS_PER_LANE if widest <= 32 * c)
    grp_i32, searches, slot_i32, slots = [], [], [], []
    for g, part in pieces:
        s0, slot0, local = len(searches), len(slots), {}
        for s in part:
            key = (int(host["w_head_numer"][win[s], 0]),
                   int(host["w_tail_numer"][win[s], 0]))
            if key not in local:
                local[key] = len(searches)
                searches.append(key)
            slots.append(s)
            slot_i32.append([s, local[key],
                             int(host["t_min_samples"][gate[s], 0])])
        grp_i32.append([int(host["g_n_bins"][g, 0]), slot0, len(slots), s0,
                        len(searches)])
    k_group = np.asarray([g for g, _ in pieces], np.int64)
    slots = np.asarray(slots)
    split = len(pieces) != G
    return ScanPlan("factored", bpl, cpl, FactoredLayout(
        put(grp_i32, np.int32),
        put(host["g_bin_minutes"][k_group, 0], np.float64),
        put(searches, np.int32), put(slot_i32, np.int32),
        put(f32_cols(win[slots], gate[slots], std[slots]), np.float32),
        put(k_group, np.int64) if split else None,
        put([int(np.flatnonzero(k_group == g)[0]) for g in range(G)],
            np.int64) if split else None))


def _expanded_launch(cols, state, plan: ScanPlan):
    """The ``registers`` and ``columns`` forms: the unfactored scan over
    one histogram per config (each group's state copied to its configs
    unless the block is the identity), then each group's state read back
    from its first config."""
    prev_t, gcum, goob, gcv_sum, gcv_sum_sq, load_c, unload_c, cold, \
        waste = state
    lay = plan.layout
    S, n = load_c.shape
    if lay.c_group is None:
        per_cfg = lambda x: x
        per_group = lambda x: x
    else:
        per_cfg = lambda x: x.index_select(0, lay.c_group)
        per_group = lambda x: x.index_select(0, lay.first)
    cum = per_cfg(gcum)
    out = _scan_launch(cols, (prev_t.expand(S, n).contiguous(), cum,
                              per_cfg(goob), per_cfg(gcv_sum),
                              per_cfg(gcv_sum_sq), load_c, unload_c, cold,
                              waste, lay.cfg_i32, lay.cfg_f32),
                       lay.bin_minutes)
    if lay.c_group is not None:
        gcum.copy_(per_group(cum))
    o_prev, _, o_oob, o_cvs, o_cvss, *per_config = out
    return (o_prev[0], gcum, per_group(o_oob), per_group(o_cvs),
            per_group(o_cvss), *per_config)


def _check_factored_args(cols, state) -> None:
    """What the factored kernel takes: contiguous float64 ``cols`` ``[width,
    n]``, the clock ``[n]``, the group state ``[G, n(, n_bins)]`` and the
    per-config state ``[S, n]``, all on one device."""
    gcum, load_c = state[1], state[5]
    if gcum.dim() != 3 or load_c.dim() != 2:
        raise ValueError("fused_hybrid_sweep_scan_factored: gcum must be "
                         "[G, n, n_bins] and the per-config state [S, n]")
    G, n, n_bins = gcum.shape
    S = load_c.shape[0]
    _check_cols(cols, n)
    f64, i32 = torch.float64, torch.int32
    want = [(cols, f64, tuple(cols.shape)), (state[0], f64, (n,)),
            (gcum, i32, (G, n, n_bins)), (state[2], i32, (G, n)),
            (state[3], f64, (G, n)), (state[4], f64, (G, n)),
            (load_c, f64, (S, n)), (state[6], f64, (S, n)),
            (state[7], i32, (S, n)), (state[8], f64, (S, n))]
    for k, (x, dt, shape) in enumerate(want):
        if x.device != gcum.device or x.dtype != dt or \
                tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(
                f"fused_hybrid_sweep_scan_factored: argument {k} (cols "
                f"first) must be a contiguous {dt} tensor of shape {shape} "
                f"on {gcum.device}, got {x.dtype} {tuple(x.shape)} on "
                f"{x.device}")


def _factored_launch(cols, state, plan: ScanPlan):
    """The ``factored`` form: one launch, a warp per (group, app)."""
    global SCAN_LAUNCHES
    _check_factored_args(cols, state)
    prev_t, gcum, goob, gcv_sum, gcv_sum_sq, load_c, unload_c, cold, \
        waste = state
    lay = plan.layout
    G, n, n_bins = gcum.shape
    Gk = lay.grp_i32.shape[0]
    if lay.k_group is None:
        kcum, kin = gcum, (goob, gcv_sum, gcv_sum_sq)
    else:
        kcum = gcum.index_select(0, lay.k_group)
        kin = tuple(x.index_select(0, lay.k_group)
                    for x in (goob, gcv_sum, gcv_sum_sq))
    o_prev = torch.empty_like(prev_t)
    o_group = [torch.empty_like(x) for x in kin]
    o_config = [torch.empty_like(x) for x in (load_c, unload_c, cold, waste)]
    consulted = torch.empty(cold.shape, dtype=torch.bool, device=cold.device)
    build.launch("hybrid_sweep_step", "hybrid_sweep_scan_factored",
                 gcum.device, cols.data_ptr(), cols.shape[0],
                 *(x.data_ptr() for x in (prev_t, kcum, *kin, load_c,
                                          unload_c, cold, waste, *lay[:5],
                                          o_prev, *o_group, *o_config,
                                          consulted)),
                 Gk, n, n_bins, plan.bins_per_lane, plan.configs_per_lane,
                 what="hybrid_sweep_scan_factored")
    SCAN_LAUNCHES += 1
    SCAN_LAUNCHES_BY_FORM["factored"] += 1
    if lay.k_group is not None:
        gcum.copy_(kcum.index_select(0, lay.first_k))
        o_group = [x.index_select(0, lay.first_k) for x in o_group]
    return (o_prev, gcum, *o_group, *o_config, consulted)


def fused_hybrid_sweep_scan_factored(
        cols, prev_t, gcum, goob, gcv_sum, gcv_sum_sq, load_c, unload_c,
        cold, waste, *, blk: policy_math.HybridSweepBlock,
        ids: policy_math.SweepIdentities = policy_math.SweepIdentities(),
        plan: ScanPlan = None):
    """The factored sweep step over every event column of ``cols``
    ``[width, n]`` (``+inf`` = no event), in one call: returns exactly what
    :func:`fused_hybrid_sweep_scan_factored_plain` returns (the factored
    step's nine outputs, ``gcum`` updated in place, and ``consulted``).

    CPU tensors run the plain version, in any time dtype. CUDA tensors
    (float64 time) run the form ``plan`` names (:func:`factored_scan_plan`
    of the host block, which must be given) and count it in
    ``SCAN_LAUNCHES_BY_FORM``, or raise."""
    state = (prev_t, gcum, goob, gcv_sum, gcv_sum_sq, load_c, unload_c,
             cold, waste)
    _check_cols(cols, gcum.shape[-2] if gcum.dim() >= 2 else -1)
    if cols.device.type == "cpu":
        return fused_hybrid_sweep_scan_factored_plain(cols, *state, blk=blk,
                                                      ids=ids)
    if cols.device.type != "cuda":
        raise ValueError(f"fused_hybrid_sweep_scan_factored: no kernel for "
                         f"device {cols.device}")
    if plan is None:
        raise ValueError("fused_hybrid_sweep_scan_factored: a CUDA scan "
                         "needs the plan factored_scan_plan made on the "
                         "host")
    if plan.form == "factored":
        return _factored_launch(cols, state, plan)
    return _expanded_launch(cols, state, plan)


# ---------------------------------------------------------------------------
# The fleet's policy-update tick
# ---------------------------------------------------------------------------


def policy_update_plain(counts, oob, total, cv_sum, cv_sum_sq, bins, active,
                        *, head_pct=5.0, tail_pct=99.0, margin=0.10,
                        bin_minutes=1.0, range_minutes=240.0,
                        cv_threshold=2.0, min_samples=5, oob_threshold=0.5):
    """The tick in plain PyTorch ops over :mod:`repro_torch.core.
    policy_math`, on any device (the port of ``repro/kernels/ref.py::
    policy_update_ref``, with the percentile bins in the masked-min form
    the TPU kernel uses). Arguments and outputs as :func:`policy_update`;
    ``counts`` is updated in place."""
    n_bins = counts.shape[1]
    active = active != 0
    in_b = active & (bins >= 0) & (bins < n_bins)
    oob_hit = active & (bins >= n_bins)
    safe = bins.clamp(0, n_bins - 1).long()[:, None]
    old = torch.gather(counts, 1, safe)[:, 0]
    counts.scatter_add_(1, safe, in_b.to(counts.dtype)[:, None])
    total = total + in_b.to(torch.int32)
    oob = oob + oob_hit.to(torch.int32)
    cv_sum, cv_sum_sq = policy_math.welford_update(cv_sum, cv_sum_sq, in_b,
                                                   old)
    cum = torch.cumsum(counts, dim=1, dtype=torch.int32)
    head_bin = policy_math.first_bin_ge_scaled(
        cum, policy_math.percentile_threshold_scaled(total, head_pct),
        gather=False)
    tail_bin = policy_math.first_bin_ge_scaled(
        cum, policy_math.percentile_threshold_scaled(total, tail_pct),
        gather=False) + 1
    load_at, unload_at = policy_math.window_values(
        head_bin, tail_bin, bin_minutes, range_minutes, margin)
    use_hist = policy_math.use_histogram_gate(
        total, oob, cv_sum, cv_sum_sq, n_bins, min_samples, cv_threshold,
        oob_threshold)
    zero = torch.zeros((), dtype=torch.float32, device=counts.device)
    std_unload = torch.tensor(float(np.float32(range_minutes)),
                              dtype=torch.float32, device=counts.device)
    prewarm = torch.where(use_hist, load_at, zero)
    keep = torch.where(use_hist, unload_at, std_unload) - prewarm
    return (counts, oob, total, cv_sum, cv_sum_sq, prewarm, keep,
            use_hist.to(torch.int32))


def _check_policy_args(args) -> None:
    counts = args[0]
    if counts.dim() != 2 or counts.shape[1] < 1:
        raise ValueError(f"policy_update: counts must be [n, n_bins] with "
                         f"n_bins >= 1, got {tuple(counts.shape)}")
    n, dev = counts.shape[0], counts.device
    i32, f32 = torch.int32, torch.float32
    names = ("counts", "oob", "total", "cv_sum", "cv_sum_sq", "bins",
             "active")
    dtypes = (i32, i32, i32, f32, f32, i32, i32)
    for name, x, dt in zip(names, args, dtypes):
        shape = tuple(counts.shape) if name == "counts" else (n,)
        if x.device != dev or x.dtype != dt or tuple(x.shape) != shape \
                or not x.is_contiguous():
            raise ValueError(
                f"policy_update: {name} must be a contiguous {dt} tensor of "
                f"shape {shape} on {dev}, got {x.dtype} {tuple(x.shape)} "
                f"on {x.device}")


def _policy_form(n_bins: int, counts_ptr: int) -> str:
    """The tick kernel's form for rows of ``n_bins`` at address
    ``counts_ptr``: ``vec4`` where every row starts 16-byte aligned (n_bins
    a multiple of 4 and the address 16-byte aligned; each lane then reads
    its 8 bins in two 16-byte loads), else ``scalar`` (eight 4-byte loads).
    Both forms are the same kernel, chosen before the launch."""
    return "vec4" if n_bins % 4 == 0 and counts_ptr % 16 == 0 else "scalar"


def _policy_launch(args, knobs):
    global POLICY_UPDATE_LAUNCHES
    _check_policy_args(args)
    counts = args[0]
    n, n_bins = counts.shape
    outs = [torch.empty_like(x) for x in args[1:5]] + \
        [torch.empty((n,), dtype=dt, device=counts.device)
         for dt in (torch.float32, torch.float32, torch.int32)]
    lo, hi = policy_math.margin_factors(knobs["margin"])
    f32 = lambda x: float(np.float32(x))
    build.launch(
        "policy_update", "policy_update", counts.device,
        *(x.data_ptr() for x in args), *(o.data_ptr() for o in outs), n,
        n_bins, policy_math.pct_numer(knobs["head_pct"]),
        policy_math.pct_numer(knobs["tail_pct"]), int(knobs["min_samples"]),
        float(lo), float(hi), f32(knobs["bin_minutes"]),
        f32(knobs["range_minutes"]), f32(knobs["cv_threshold"]),
        f32(knobs["oob_threshold"]),
        4 if _policy_form(n_bins, counts.data_ptr()) == "vec4" else 1)
    POLICY_UPDATE_LAUNCHES += 1
    return (counts, *outs)


def policy_update(counts, oob, total, cv_sum, cv_sum_sq, bins, active, *,
                  head_pct=5.0, tail_pct=99.0, margin=0.10, bin_minutes=1.0,
                  range_minutes=240.0, cv_threshold=2.0, min_samples=5,
                  oob_threshold=0.5):
    """One control-plane tick: this tick's idle-time bin of every app into
    its histogram, and the policy windows of the whole fleet.

    ``counts`` ``[n, n_bins]`` int32 raw bin counts (updated IN PLACE),
    ``oob``/``total`` ``[n]`` int32, ``cv_sum``/``cv_sum_sq`` ``[n]``
    float32, ``bins`` ``[n]`` int32 (this tick's bin; ``>= n_bins`` is out
    of bounds, a negative bin is neither), ``active`` ``[n]`` int32 (0/1).
    Returns the reference's eight, in its order: (counts, oob, total,
    cv_sum, cv_sum_sq, prewarm, keep_alive, use_hist) — the windows
    float32, ``use_hist`` int32.

    The percentile compares are int32, as in the reference: ``cum *
    PCT_SCALE`` and ``total * numer`` wrap around for a row whose counts
    pass ``policy_math.MAX_SCALED_COUNT`` (214,748 samples in range), and
    such a row gets the windows of the wrapped compare, exactly as the
    reference and the plain version give them. Nothing here checks for
    that (the check would read the device every tick): a tick adds at most
    one sample a row, so the caller bounds the totals by its tick count.

    CPU tensors run the plain version; CUDA tensors launch the kernel (and
    count one launch in ``POLICY_UPDATE_LAUNCHES``) or raise."""
    args = (counts, oob, total, cv_sum, cv_sum_sq, bins, active)
    knobs = dict(head_pct=head_pct, tail_pct=tail_pct, margin=margin,
                 bin_minutes=bin_minutes, range_minutes=range_minutes,
                 cv_threshold=cv_threshold, min_samples=min_samples,
                 oob_threshold=oob_threshold)
    if counts.device.type == "cpu":
        return policy_update_plain(*args, **knobs)
    if counts.device.type == "cuda":
        return _policy_launch(args, knobs)
    raise ValueError(f"policy_update: no kernel for device {counts.device}")
