"""Welford-style O(1) tracking of the CV of histogram bin counts (paper
§4.2), in PyTorch: the port of ``repro/core/welford.py``.

A histogram is *representative* when its bin counts have a high
coefficient of variation (CV = std / mean). Incrementing bin ``b`` from
count ``c`` to ``c+1`` adds 1 to the sum of counts and ``2c+1`` to the sum
of squared counts, so both sums are tracked and::

    mean = sum / n_bins
    var  = sum_sq / n_bins - mean**2          (population variance)
    cv   = sqrt(var) / mean                   (0 when mean == 0)

A scalar tracker (:class:`CVState`, the control-plane path) and a batched
one over ``[n_apps]`` tensors; both go through the single-source helpers
of :mod:`repro_torch.core.policy_math` (``welford_update`` /
``bin_count_cv``). Only the :func:`cv_from_counts` test oracle recomputes
from scratch.
"""
from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np
import torch

from ..device import resolve_device
from . import policy_math

__all__ = ["CVState", "cv_init", "cv_update", "cv_value", "cv_from_counts"]

_NUMPY_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


@dataclasses.dataclass
class CVState:
    """Scalar O(1) CV tracker for one histogram (host-side path)."""

    n_bins: int
    sum_counts: float = 0.0
    sum_sq_counts: float = 0.0

    def update(self, old_count: float) -> None:
        """Record that one bin went from ``old_count`` to ``old_count + 1``."""
        s, ss = policy_math.welford_update(self.sum_counts, self.sum_sq_counts,
                                           True, old_count)
        self.sum_counts, self.sum_sq_counts = float(s), float(ss)

    def remove(self, old_count: float) -> None:
        """Record that one bin went from ``old_count`` to ``old_count - 1``."""
        self.sum_counts -= 1.0
        self.sum_sq_counts -= 2.0 * old_count - 1.0

    @property
    def cv(self) -> float:
        return float(policy_math.bin_count_cv(self.sum_counts,
                                              self.sum_sq_counts,
                                              self.n_bins, np.float64))


# --- Batched path (state = dict of [n_apps] tensors) ------------------------


def cv_init(n_apps: int, dtype: torch.dtype = torch.float32, *,
            device: Union[None, str, torch.device] = None) -> dict:
    """Zero accumulators for ``n_apps`` apps on ``device`` (the card
    unless told otherwise; raises without one)."""
    dev = resolve_device(device)
    return {"sum": torch.zeros((n_apps,), dtype=dtype, device=dev),
            "sum_sq": torch.zeros((n_apps,), dtype=dtype, device=dev)}


def cv_update(state: dict, old_count: torch.Tensor,
              active: torch.Tensor) -> dict:
    """Batched O(1) update: per app, one bin went old_count -> old_count+1.

    ``active`` masks apps that actually recorded an in-bounds IT this step.
    """
    s, ss = policy_math.welford_update(state["sum"], state["sum_sq"],
                                       active != 0, old_count)
    return {"sum": s, "sum_sq": ss}


def cv_value(state: dict, n_bins: int) -> torch.Tensor:
    return policy_math.bin_count_cv(state["sum"], state["sum_sq"], n_bins,
                                    _NUMPY_DTYPE[state["sum"].dtype])


def cv_from_counts(counts: torch.Tensor) -> torch.Tensor:
    """Direct CV of bin counts along the last axis (reference for tests),
    float32 as the reference computes it: each mean is the exact sum times
    the float32 reciprocal of the bin count (XLA compiles ``jnp.mean``'s
    division by the constant length so), each operation rounded once."""
    counts = counts.to(torch.float32)
    r = policy_math._recip32(counts.shape[-1])
    mean = counts.sum(dim=-1) * r
    var = torch.clamp((counts * counts).sum(dim=-1) * r - mean * mean,
                      min=0.0)
    return torch.where(mean > 0.0, policy_math._sqrt_rn(var)
                       / torch.clamp(mean, min=float(np.float32(1e-9))), 0.0)
