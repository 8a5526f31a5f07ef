"""Public front of the port's kernels (the counterpart of
``repro/kernels/ops.py``; PyTorch runs eagerly, so nothing is jitted).

Each takes the model's layout and dispatches on the device of its inputs:
the CUDA kernel on the card, its plain PyTorch version on the CPU."""
from __future__ import annotations

from .decode_attention import decode_attention
from .flash_attention import flash_attention
from .histogram import fused_hybrid_step, policy_update
from .rglru_scan import rglru_scan
from .rope_append import rope_append
from .ssd_scan import ssd_scan

__all__ = ["decode_attention", "flash_attention", "fused_hybrid_step",
           "policy_update", "rglru_scan", "rope_append", "ssd_scan"]
