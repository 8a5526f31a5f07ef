"""Gradient compression with error feedback (int8 quantized all-reduce);
the port of ``repro/distributed/compression.py``.

For cross-pod gradient reduction the wire cost dominates; gradients are
quantized to int8 with a per-block scale before the reduction and the
quantization error is carried into the next step (error feedback keeps the
*accumulated* update unbiased: Seide et al., Karimireddy et al.).

``compress``/``decompress`` are pure tensor functions. Their arithmetic is
the reference's, elementwise in f32, with ``torch.round`` rounding half to
even as ``jnp.round`` does, so payloads and scales are bit-equal to the
reference's. :class:`ErrorFeedback` threads the residual (one f32 tensor per
parameter, by name) through a train step. 4x wire reduction vs f32, 2x vs
bf16.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

__all__ = ["BLOCK", "Compressed", "compress", "decompress",
           "roundtrip_error", "ErrorFeedback"]

BLOCK = 256


class Compressed(NamedTuple):
    q: torch.Tensor        # int8 payload [n_blocks, block]
    scale: torch.Tensor    # f32 per-block scales [n_blocks]


def compress(x: torch.Tensor, block: int = BLOCK) -> Compressed:
    """Symmetric per-block int8 quantization of ``x`` flattened (zero-padded
    to a whole number of blocks)."""
    flat = x.to(torch.float32).reshape(-1)
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(-1, block)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return Compressed(q=q, scale=scale[:, 0])


def decompress(c: Compressed, shape, dtype=torch.float32) -> torch.Tensor:
    blocks = c.q.to(torch.float32) * c.scale[:, None]
    n = 1
    for d in shape:
        n *= d
    return blocks.reshape(-1)[:n].reshape(tuple(shape)).to(dtype)


def roundtrip_error(x: torch.Tensor) -> torch.Tensor:
    return x - decompress(compress(x), x.shape, x.dtype)


class ErrorFeedback:
    """Stateless helpers for error-feedback compression of gradients
    (``{name: tensor}``)."""

    @staticmethod
    def init(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in params.items()}

    @staticmethod
    def apply(grads: Dict[str, torch.Tensor],
              residual: Dict[str, torch.Tensor]
              ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """(compressed-then-decompressed grads, new residual). The payload
        that would cross the wire is the :class:`Compressed` pair; here the
        quantize -> dequantize round trip is modelled locally and the
        residual carries the quantization error to the next step."""
        g_hat, new_r = {}, {}
        for n, g in grads.items():
            g_fb = g.to(torch.float32) + residual[n]
            g_hat[n] = decompress(compress(g_fb), g.shape, torch.float32)
            new_r[n] = g_fb - g_hat[n]
        return g_hat, new_r
