"""Public front of the port's kernels (the counterpart of
``repro/kernels/ops.py``; PyTorch runs eagerly, so nothing is jitted)."""
from __future__ import annotations

from .histogram import fused_hybrid_step

__all__ = ["fused_hybrid_step"]
