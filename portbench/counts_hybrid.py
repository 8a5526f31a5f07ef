"""Operations and bytes of the hybrid stack (Nemotron-H: Mamba-2, attention
and MoE layers as the model group's ``layer_pattern`` says): the yardstick
of ``ssd_roofline`` and ``mfu_hybrid``. Counted from shapes and the
configuration file, never from the program; peaks and the attention counts
are :mod:`portbench.counts`'.

Worked example (Nemotron-3-Nano's Mamba-2 layer, one prompt of 4,096
tokens: h 64, p 64, g 8, n 128, Q 128, bf16): the SSD scan counts as the
kernel's bound note counts it, C_i . B_j over the live pairs of each chunk
once a group (2 * 128 * 8 * 8,256 * 32 = 0.541 GFLOP), the masked product
with x once a head (2 * 64 * 64 * 8,256 * 32 = 2.164 GFLOP), C S_in and the
chunk states (2 * 2 * 4,096 * 128 * 64 * 64 = 8.590 GFLOP): 11.295 GFLOP,
0.01142 ms at 989 TFLOP/s; its bytes, x and y (2 * 4,096 * 64 * 64 * 2),
dt (4,096 * 64 * 4), B and C (2 * 4,096 * 8 * 128 * 2) and the final state
(64 * 128 * 64 * 4), are 87.03 MB, 0.02598 ms at 3.35 TB/s: bound by bytes.
"""
from __future__ import annotations

from typing import Dict

from .counts import attention_flops

__all__ = ["ssd_flops", "ssd_bytes", "ssd_least_s", "layer_counts",
           "prefill_flops", "decode_flops", "request_flops"]

BF16, F32 = 2, 4


def _ssd_dims(m: dict):
    H, P = m["ssm_heads"], m["ssm_head_dim"]
    return H, P, m["ssm_groups"], m["ssm_state"], m["ssm_chunk"]


def _pairs(l: int, Q: int) -> int:
    """The live (i, j <= i) pairs of the chunks of an l-step scan."""
    full, rest = divmod(l, Q)
    return full * Q * (Q + 1) // 2 + rest * (rest + 1) // 2


def ssd_flops(m: dict, l: int, batch: int = 1) -> int:
    """One scan of l steps: C B^T over the live pairs once a group, the
    masked product with x once a head, C S_in and the chunk states (2 l n
    p each a head)."""
    H, P, G, N, Q = _ssd_dims(m)
    pairs = _pairs(l, Q)
    return batch * (2 * N * G * pairs + 2 * P * H * pairs
                    + 2 * 2 * l * N * P * H)


def ssd_bytes(m: dict, l: int, batch: int = 1) -> int:
    """x and y [l, h, p] bf16, dt [l, h] f32, B and C [l, g, n] bf16 and the
    final state [h, n, p] f32, each read or written once."""
    H, P, G, N, _ = _ssd_dims(m)
    return batch * (2 * l * H * P * BF16 + l * H * F32 + 2 * l * G * N * BF16
                    + H * N * P * F32)


def ssd_least_s(m: dict, l: int, pk: Dict[str, float],
                batch: int = 1) -> float:
    """The least time of one scan: the larger of its operations at the bf16
    peak and its bytes at the HBM peak."""
    return max(ssd_flops(m, l, batch) / pk["bf16_flops"],
               ssd_bytes(m, l, batch) / pk["hbm_bytes_per_s"])


def layer_counts(m: dict) -> Dict[str, int]:
    """Per token: the weights each kind of layer multiplies by (``mamba``
    its in and out projections; ``attn`` q, k, v and o; ``moe_fixed`` the
    router and the shared expert; ``expert`` one routed expert), and the
    Mamba-2 conv's multiply-adds (``conv``)."""
    D, hd = m["d_model"], m["head_dim"]
    H, P, G, N, _ = _ssd_dims(m)
    DI = H * P
    return {"mamba": D * (2 * DI + 2 * G * N + H) + DI * D,
            "conv": m["conv_width"] * (DI + 2 * G * N),
            "attn": D * hd * (m["n_heads"] + 2 * m["n_kv_heads"])
            + m["n_heads"] * hd * D,
            "moe_fixed": D * m["n_experts"] + 2 * D * m["d_shared_expert"],
            "expert": 2 * D * m["d_expert"]}


def _kinds(m: dict) -> Dict[str, int]:
    pat = m["layer_pattern"]
    return {k: pat.count(k) for k in "ME*"}


def prefill_flops(m: dict, S: int, held_choices: int) -> int:
    """A prompt of S tokens: the Mamba-2 layers' projections, conv and
    scan, causal attention in the attention layers, the router and shared
    expert of each MoE layer, ``held_choices`` routed experts' products
    (the choices of every MoE layer that landed on held experts), and the
    logits of the last position only."""
    c, n = layer_counts(m), _kinds(m)
    return (n["M"] * (2 * (c["mamba"] + c["conv"]) * S + ssd_flops(m, S))
            + n["*"] * (2 * c["attn"] * S
                        + attention_flops(S, m["n_heads"], m["head_dim"]))
            + n["E"] * 2 * c["moe_fixed"] * S
            + held_choices * 2 * c["expert"]
            + 2 * m["d_model"] * m["vocab"])


def decode_flops(m: dict, pos: int) -> int:
    """One decoded token at position ``pos``: the Mamba-2 layers'
    projections and conv and their state's update and read-out (4 h n p),
    attention over pos + 1 keys, each MoE layer's router, shared expert
    and the expected held choices (``top_k * experts_held / n_experts``),
    and the logits."""
    c, n = layer_counts(m), _kinds(m)
    H, P, _, N, _ = _ssd_dims(m)
    E = m["n_experts"]
    held = (m.get("experts_held") or E) * m["top_k"] / E
    return int(n["M"] * (2 * (c["mamba"] + c["conv"]) + 4 * H * N * P)
               + n["*"] * (2 * c["attn"]
                           + 4 * m["head_dim"] * m["n_heads"] * (pos + 1))
               + n["E"] * (2 * c["moe_fixed"] + held * 2 * c["expert"])
               + 2 * m["d_model"] * m["vocab"])


def request_flops(m: dict, S: int, new: int, held_choices: int) -> int:
    """A request: its prefill, then ``new - 1`` decode steps at positions
    S .. S + new - 2."""
    return prefill_flops(m, S, held_choices) + sum(
        decode_flops(m, S + j) for j in range(new - 1))
