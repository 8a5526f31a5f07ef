"""Modality frontend stubs (the port of ``repro/models/frontend.py``).

The VLM and audio configurations specify the transformer backbone only:
their frontend is a stub that provides precomputed patch or frame
embeddings of the right shape, ``0.02 * normal`` of ``[batch,
frontend_tokens, d_model]`` in fp32, from the caller's generator on the
caller's device (the card unless ``device="cpu"``).
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device

__all__ = ["vision_patches", "audio_frames"]


def _stub(cfg: ModelConfig, batch: int, gen: torch.Generator,
          device) -> torch.Tensor:
    dev = resolve_device(device)
    return 0.02 * torch.randn((batch, cfg.frontend_tokens, cfg.d_model),
                              generator=gen, dtype=torch.float32, device=dev)


def vision_patches(cfg: ModelConfig, batch: int, gen: torch.Generator,
                   device=None) -> torch.Tensor:
    """Anyres tiling stand-in: ``frontend_tokens`` patch embeddings an image
    (LLaVA-NeXT: a 672x672 image gives 2,880 patch tokens)."""
    return _stub(cfg, batch, gen, device)


def audio_frames(cfg: ModelConfig, batch: int, gen: torch.Generator,
                 device=None) -> torch.Tensor:
    """Speech feature-extractor stand-in: ``frontend_tokens`` frame
    embeddings an utterance (SeamlessM4T-medium: 1,024 frames)."""
    return _stub(cfg, batch, gen, device)
