"""Nemotron-H (Mamba-2, GQA attention and sigmoid-routed MoE layers in one
stack): NVIDIA Nemotron-3-Nano-30B-A3B [hf:nvidia/NVIDIA-Nemotron-3-Nano-
30B-A3B-BF16; family paper arXiv:2504.03624]. The port's own family: the
reference package has none like it.

One mixer a block, as ``cfg.layer_pattern`` says (``M`` Mamba-2, ``E``
MoE, ``*`` attention), each ``x <- x + mixer(RMSNorm(x))``; after the last
block an RMSNorm and the untied head. The published equations:

  * Mamba-2 (:func:`mamba2.block_apply` with ``ssm_groups``, ``ssm_heads``
    and ``ssm_norm="gate_norm"``): ``[z | xBC | dt] = h W_in`` (widths
    4,096 | 6,144 | 64, no bias); ``xBC <- silu(conv1d(xBC))``, causal,
    depthwise, width 4, with bias; ``xBC = [x (64 heads of 64) | B (8 x
    128) | C (8 x 128)]``, head ``i`` reading group ``i // 8``; ``dt <-
    softplus(dt + dt_bias)`` (no clamp), ``A = -exp(A_log)``; the SSD
    recurrence ``S_t = exp(dt_t A) S_{t-1} + dt_t B_t x_t^T``, ``y_t = C_t
    . S_t + D x_t``; then ``y <- y * silu(z)`` and an RMSNorm over each
    group's 512 channels times a 4,096-wide scale (``MambaRMSNormGated``,
    ``norm_before_gate=False``); ``y W_out``.
  * Attention (:func:`layers.attention_apply` with ``use_rope=False``):
    q (32 x 128), k and v (2 x 128), causal softmax at ``1/sqrt(128)``,
    ``W_o``; no rotary embedding (the published modeling code applies
    none).
  * MoE (:func:`moe.dropless_apply`): ``s = sigmoid(h W_r)`` in f32 over
    128 experts; the top 6 of ``s + b_corr`` (the bias only chooses);
    ``w = s[chosen] / (sum s[chosen] + 1e-20) * 2.5``; ``sum_e w_e
    W_down,e(relu(W_up,e h)^2)`` over the chosen experts this device holds,
    plus the shared ``W_down,s(relu(W_up,s h)^2)``; dropless.

Over a prompt, the Mamba-2 layers take the SSD kernel when the length is a
whole number of ``ssm_chunk`` chunks and the attention layers the flash
kernel at whole 128-row tiles (``cfg.use_kernels``); decode steps the
Mamba-2 state and conv buffer by hand and reads the KV caches through the
decode kernel, with every position on the device, so that a CUDA graph of
the step replays at every position. The decode state holds two kinds side
by side: ``k``/``v`` per attention layer, ``ssm``/``conv`` per Mamba-2
layer (lists in layer order within each kind), and ``pos``.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..kernels import expert_gather, rope_append
from . import layers as L
from . import mamba2, moe
from .transformer import _init_params, _logits

__all__ = ["AttnBlock", "MoEBlock", "NemotronHParams", "kinds", "init",
           "forward", "loss_fn", "init_state", "prefill", "decode_step",
           "counters"]


def kinds(cfg: ModelConfig) -> str:
    """The mixer of each layer (``cfg.layer_pattern``, one of M, E, *)."""
    pat = cfg.layer_pattern
    if len(pat) != cfg.n_layers or set(pat) - set("ME*"):
        raise ValueError(f"layer_pattern {pat!r} must give one of M, E, * "
                         f"for each of the {cfg.n_layers} layers")
    return pat


class AttnBlock(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.ln = L.RMSNorm(cfg.d_model)
        self.attn = L.Attention(cfg)

    def init_(self, gen: torch.Generator) -> None:
        self.attn.init_(gen)


class MoEBlock(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.ln = L.RMSNorm(cfg.d_model)
        self.moe = moe.DroplessMoE(cfg)

    def init_(self, gen: torch.Generator) -> None:
        self.moe.init_(gen)


_BLOCKS = {"M": mamba2.Mamba2Block, "*": AttnBlock, "E": MoEBlock}


class NemotronHParams(nn.Module):
    """``embed``, ``layers`` (a :class:`mamba2.Mamba2Block`,
    :class:`AttnBlock` or :class:`MoEBlock` per layer, as the pattern
    says), ``ln_f`` and the untied ``head``."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.embed = L.Embedding(cfg.vocab, cfg.d_model)
        self.layers = nn.ModuleList(_BLOCKS[k](cfg) for k in kinds(cfg))
        self.ln_f = L.RMSNorm(cfg.d_model)
        self.head = L.Linear(cfg.d_model, cfg.vocab)


def init(cfg: ModelConfig, seed: int = 0, device=None) -> NemotronHParams:
    """Random fp32 parameters from ``seed`` on ``device``: normal /
    sqrt(fan_in) for the projections, experts and head, 0.02 for the
    embedding; Mamba-2's own (``A_log = log(linspace(1, 16, H))``, conv taps
    at 0.1, zero ``conv_b`` and ``dt_bias``, unit ``D``); a zero correction
    bias; unit norm scales."""
    p = _init_params(NemotronHParams, cfg, seed, resolve_device(device))
    with torch.no_grad():
        for name, t in p.named_parameters():
            leaf = name.rpartition(".")[2]
            if leaf in ("conv_b", "dt_bias", "e_bias"):
                t.zero_()
            elif leaf == "D":
                t.fill_(1.0)
    return p


def _mixer(cfg, kind, lp, x, positions, cache=None, state=None,
           use_kernel=True):
    """One block with its residual; returns (x, the Mamba-2 layer's new
    state or None)."""
    if kind == "M":
        return mamba2.block_apply(cfg, lp, x, state=state,
                                  use_kernel=use_kernel)
    h = L.rmsnorm(lp.ln, x, cfg.norm_eps)
    if kind == "*":
        return x + L.attention_apply(lp.attn, cfg, h, positions, cache=cache,
                                     use_rope=cfg.use_rope), None
    return x + moe.dropless_apply(cfg, lp.moe, h), None


def forward(cfg: ModelConfig, params: NemotronHParams, tokens):
    """Full-sequence logits [B, S, vocab] in the activation dtype."""
    x = L.embed(params.embed, tokens, L.compute_dtype(cfg))
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    for kind, lp in zip(kinds(cfg), params.layers):
        x = L.remat(cfg, lambda x, kind=kind, lp=lp: _mixer(
            cfg, kind, lp, x, positions)[0], x)
    return _logits(cfg, params, x)


def loss_fn(cfg: ModelConfig, params: NemotronHParams, batch: Dict):
    """Mean next-token cross-entropy of ``batch``."""
    logits = forward(cfg, params, batch["tokens"])
    return L.softmax_xent(logits, batch["labels"], batch.get("mask"))


def init_state(cfg: ModelConfig, batch: int, max_len: int, dtype,
               device=None) -> Dict:
    """Zero decode state: ``k``/``v`` [B, max_len, Hkv, hd] per attention
    layer, ``ssm`` [B, H, N, P] fp32 and ``conv`` [B, W-1, DI+2GN] per
    Mamba-2 layer; ``pos`` the host int 0."""
    pat = kinds(cfg)
    kv = L.make_cache(cfg, batch, max_len, pat.count("*"), dtype, device)
    ssm = mamba2.init_state(cfg.with_(n_layers=pat.count("M")), batch,
                            dtype, device)
    return {"k": kv["k"], "v": kv["v"], "ssm": ssm["ssm"],
            "conv": ssm["conv"], "pos": 0}


def prefill(cfg: ModelConfig, params: NemotronHParams, tokens,
            max_len: int = 0):
    """Prompt pass: last-token logits [B, 1, vocab] and the decode state
    (KV caches of capacity ``max_len``, 0: the prompt's length; the
    Mamba-2 layers' states; ``pos`` = S as a 0-d device tensor)."""
    x = L.embed(params.embed, tokens, L.compute_dtype(cfg))
    B, S, _ = x.shape
    max_len = max_len or S
    if max_len < S:
        raise ValueError(f"prefill: max_len {max_len} < prompt length {S}")
    pat = kinds(cfg)
    kv = L.make_cache(cfg, B, max_len, pat.count("*"), x.dtype, x.device)
    positions = torch.arange(S, device=x.device).expand(B, S)
    ssms, convs, a = [], [], 0
    for kind, lp in zip(pat, params.layers):
        cache = None
        if kind == "*":
            cache = {"k": kv["k"][a], "v": kv["v"][a], "pos": 0}
            a += 1
        x, ns = _mixer(cfg, kind, lp, x, positions, cache=cache)
        if ns is not None:
            ssms.append(ns["ssm"])
            convs.append(ns["conv"])
    state = {"k": kv["k"], "v": kv["v"], "ssm": ssms, "conv": convs,
             "pos": L.device_pos(S, x.device)}
    return _logits(cfg, params, x[:, -1:]), state


def decode_step(cfg: ModelConfig, params: NemotronHParams, token, cache):
    """One token per sequence (``token`` [B]) -> (logits [B, vocab], the
    state: the KV caches written in place, new Mamba-2 states, ``pos``
    advanced)."""
    x = L.embed(params.embed, token[:, None], L.compute_dtype(cfg))
    pos = cache["pos"]
    positions = L.step_positions(pos, x.shape[0], x.device)
    ssms, convs, a, m = [], [], 0, 0
    for kind, lp in zip(kinds(cfg), params.layers):
        kv = state = None
        # repro-lint: ignore[tracer-leak] -- kind is a character of the
        # configuration's layer pattern, a host str
        if kind == "*":
            kv = {"k": cache["k"][a], "v": cache["v"][a], "pos": pos}
            a += 1
        # repro-lint: ignore[tracer-leak] -- the same host str
        elif kind == "M":
            state = {"ssm": cache["ssm"][m], "conv": cache["conv"][m]}
            m += 1
        x, ns = _mixer(cfg, kind, lp, x, positions, cache=kv, state=state)
        if ns is not None:
            ssms.append(ns["ssm"])
            convs.append(ns["conv"])
    logits = _logits(cfg, params, x)[:, 0]
    return logits, {"k": cache["k"], "v": cache["v"], "ssm": ssms,
                    "conv": convs, "pos": pos + 1}


def counters(cfg: ModelConfig) -> Dict[str, int]:
    """The counters a request of this stack reports, as they stand: with
    Mamba-2 layers, the SSD scan kernel's calls (``ssd_launches``,
    :func:`mamba2.counters`); with MoE layers, the routed choices the
    prompt pass computed on held experts (``held_choices``) and the
    gathered-expert kernel's calls (``expert_gather_launches``); with
    attention layers, the rotary-and-append kernel's launches
    (``rope_append_launches``, here an append alone: the layers have no
    RoPE)."""
    pat = kinds(cfg)
    out = mamba2.counters(cfg) if "M" in pat else {}
    if "E" in pat:
        out["held_choices"] = moe.HELD_CHOICES
        out["expert_gather_launches"] = expert_gather.LAUNCHES
    if "*" in pat:
        out["rope_append_launches"] = rope_append.LAUNCHES
    return out
