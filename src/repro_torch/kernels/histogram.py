"""The hybrid-policy sweep step: a CUDA kernel for Hopper and its plain
PyTorch version.

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
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core import policy_math

__all__ = ["CFG_I32_COLS", "CFG_F32_COLS", "LAUNCHES",
           "fused_hybrid_sweep_step", "fused_hybrid_sweep_step_plain",
           "fused_hybrid_step"]

# Column layout of the per-config knob blocks (built by
# ``repro_torch.core.simulator._build_cfg_blocks``).
CFG_I32_COLS = ("n_bins", "head_numer", "tail_numer", "min_samples")
CFG_F32_COLS = ("margin_lo", "margin_hi", "bin_minutes", "range_f32",
                "cv_threshold", "oob_threshold", "standard_keep")

#: Kernel launches made by this process (plain-version calls do not count).
LAUNCHES = 0


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


def _lib() -> ctypes.CDLL:
    from . import build
    lib = build.load("hybrid_sweep_step")
    if not getattr(lib, "_typed", False):
        fn = lib.hybrid_sweep_step
        fn.argtypes = [ctypes.c_void_p] * 21 + [ctypes.c_int] * 3 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.hybrid_error_string.argtypes = [ctypes.c_int]
        lib.hybrid_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _launch(args, bin_minutes):
    global LAUNCHES
    t_now, cum = args[0], args[2]
    if bin_minutes is None:
        bin_minutes = args[11][:, 2].to(torch.float64).contiguous()
    _check_cuda_args(args, bin_minutes)
    lib = _lib()
    S, n, n_bins = cum.shape
    outs = [torch.empty_like(x) for x in (args[1], *args[3:10])]
    with torch.cuda.device(cum.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.hybrid_sweep_step(
            *(x.data_ptr() for x in (*args, bin_minutes)),
            *(o.data_ptr() for o in outs), S, n, n_bins, stream)
    if rc != 0:
        raise RuntimeError("hybrid_sweep_step launch failed: "
                           + lib.hybrid_error_string(rc).decode())
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
