"""Operations, bytes and peaks: the yardstick of the roofline and MFU
readers. Counted from shapes and the configuration file, never from the
program.

Worked example (the attention kernel's serving shape of the older chip
runs, two sequences of 4,096 tokens, Qwen2-7B's 28 query and 4 KV heads of
128): one causal launch needs ``2 * 128 * 28 * 4096 * 4097 * 2`` = 240.6
GFLOP and ``(2 * 28 + 2 * 4) * 4096 * 128 * 2 * 2`` = 134.2 MB, so on an
H100 (989 TFLOP/s bf16, 3.35 TB/s) its least time is 0.2433 ms, bound by
operations (the bytes alone take 0.0401 ms).
"""
from __future__ import annotations

from typing import Dict, Optional

__all__ = ["PEAKS", "peaks", "attention_flops", "attention_bytes",
           "attention_least_s", "layer_matmul_params", "prefill_flops",
           "decode_flops", "request_flops"]

#: Published dense peaks by the name ``torch.cuda.get_device_name()`` gives
#: (NVIDIA's H100 SXM data sheet: bf16 tensor cores without sparsity, HBM3
#: bandwidth), at the full 700 W power limit.
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12,
                              "hbm_bytes_per_s": 3.35e12},
}

BF16_BYTES = 2


def peaks(device_name: str) -> Optional[Dict[str, float]]:
    """The card's peaks, or None for a card the table does not hold."""
    return PEAKS.get(device_name)


def attention_flops(S: int, n_heads: int, head_dim: int, batch: int = 1
                    ) -> int:
    """Causal self-attention over S positions from 0: each of the S(S+1)/2
    (query, key) pairs a head costs 2*hd for the score and 2*hd for the
    value product."""
    return 2 * head_dim * n_heads * S * (S + 1) * batch


def attention_bytes(S: int, n_heads: int, n_kv_heads: int, head_dim: int,
                    batch: int = 1, elem: int = BF16_BYTES) -> int:
    """q and the output [S, Hq, hd], k and v [S, Hkv, hd], each byte read or
    written once."""
    return (2 * n_heads + 2 * n_kv_heads) * S * head_dim * elem * batch


def attention_least_s(S: int, n_heads: int, n_kv_heads: int, head_dim: int,
                      pk: Dict[str, float], batch: int = 1) -> float:
    """The least time of one launch: the larger of its operations at the
    bf16 peak and its bytes at the HBM peak."""
    return max(attention_flops(S, n_heads, head_dim, batch)
               / pk["bf16_flops"],
               attention_bytes(S, n_heads, n_kv_heads, head_dim, batch)
               / pk["hbm_bytes_per_s"])


def layer_matmul_params(m: dict) -> int:
    """Weights one token multiplies by in one layer: the attention
    projections, and the SwiGLU MLP or, for a mixture of experts, the router
    and ``top_k`` experts (active parameters only). ``m`` is the
    configuration file's ``model`` group."""
    D, hd = m["d_model"], m["head_dim"]
    attn = D * hd * (m["n_heads"] + 2 * m["n_kv_heads"]) \
        + m["n_heads"] * hd * D
    if m.get("n_experts", 0):
        return attn + D * m["n_experts"] + m["top_k"] * 3 * D * m["d_expert"]
    return attn + 3 * D * m["d_ff"]


def _head(m: dict) -> int:
    return m["d_model"] * m["vocab"]


def prefill_flops(m: dict, S: int) -> int:
    """A prompt of S tokens: every layer's products, causal attention, and
    the logits of the last position only (the program's prefill returns
    those)."""
    L = m["n_layers"]
    return (2 * L * layer_matmul_params(m) * S
            + L * attention_flops(S, m["n_heads"], m["head_dim"])
            + 2 * _head(m))


def decode_flops(m: dict, pos: int) -> int:
    """One decoded token at position ``pos`` (it attends to pos + 1 keys)."""
    L = m["n_layers"]
    return (2 * L * layer_matmul_params(m)
            + L * 4 * m["head_dim"] * m["n_heads"] * (pos + 1)
            + 2 * _head(m))


def request_flops(m: dict, S: int, new: int) -> int:
    """A request: its prefill, then ``new - 1`` decode steps at positions
    S .. S + new - 2 (the prefill gives the first new token)."""
    return prefill_flops(m, S) + sum(decode_flops(m, S + j)
                                     for j in range(new - 1))
