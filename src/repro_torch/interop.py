"""Carry inputs and scan state across from the JAX reference as numpy.

This system has no model weights: its inputs (traces) and its scan state
take their place. The tests make both with numpy from a seed and hand the
same arrays to the reference and, through these functions, to the port.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .core.workload import Trace
from .device import resolve_device

__all__ = ["trace_from_numpy", "step_state_from_numpy",
           "cfg_blocks_from_numpy"]

_STEP_DTYPES = (torch.float32, torch.int32, torch.int32, torch.float32,
                torch.float32, torch.float32, torch.float32, torch.int32,
                torch.float32)


def trace_from_numpy(times: Union[np.ndarray, Sequence[np.ndarray]],
                     counts: Optional[np.ndarray] = None, *,
                     duration_minutes: float) -> Trace:
    """A port :class:`Trace` from the reference's data: either the padded
    ``Trace.to_padded()`` pair (``times`` [n, width] +inf-padded, ``counts``
    [n]) or a list of per-app sorted time arrays (``counts`` None)."""
    if counts is None:
        return Trace(specs=None,
                     times=[np.asarray(t).copy() for t in times],
                     duration_minutes=float(duration_minutes))
    times = np.ascontiguousarray(times)
    counts = np.asarray(counts, np.int32)
    if times.ndim != 2 or counts.shape != (times.shape[0],):
        raise ValueError("padded times must be [n, width] with counts [n]")
    return Trace(specs=None, times=None,
                 duration_minutes=float(duration_minutes),
                 _padded=(times.copy(), counts.copy()))


def step_state_from_numpy(prev_t, cum, oob, cv_sum, cv_sum_sq, prewarm,
                          unload_at, cold, waste, *,
                          device="cuda") -> Tuple[torch.Tensor, ...]:
    """The nine sweep-step states (reference order: prev_t, cum, oob,
    cv_sum, cv_sum_sq, prewarm, unload_at, cold, waste) as contiguous
    float32/int32 tensors on ``device``."""
    dev = resolve_device(device)
    arrays = (prev_t, cum, oob, cv_sum, cv_sum_sq, prewarm, unload_at, cold,
              waste)
    return tuple(torch.tensor(np.asarray(a), dtype=dt, device=dev)
                 for a, dt in zip(arrays, _STEP_DTYPES))


def cfg_blocks_from_numpy(cfg_i32, cfg_f32, *, device="cuda"
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``_build_pallas_cfg`` blocks ([S, 4] int32, [S, 7]
    float32) as tensors on ``device``."""
    dev = resolve_device(device)
    return (torch.tensor(np.asarray(cfg_i32), dtype=torch.int32, device=dev),
            torch.tensor(np.asarray(cfg_f32), dtype=torch.float32,
                         device=dev))
