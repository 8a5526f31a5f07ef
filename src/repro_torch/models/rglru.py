"""RecurrentGemma / Griffin hybrid: RG-LRU recurrent blocks + local attention
[arXiv:2402.19427]. The port of ``repro/models/rglru.py``.

Layer pattern ``(rec, rec, attn)`` repeating (one local-attention layer per
two recurrent layers), each temporal block followed by a SwiGLU MLP block;
``n_layers % 3`` trailing recurrent layers close the stack. The
reference's stacked ``[n_super, ...]`` block parameters are unrolled into a
``ModuleList`` of super-blocks, and the state of the super-blocks is a list
of per-block dicts.

  * the RG-LRU recurrence ``h_t = a_t h_{t-1} + b_t`` over a full sequence
    goes through ``kernels.ops.rglru_scan`` (the CUDA kernel on the card)
    when the config asks for kernels and the length is a multiple of 128,
    else through the plain doubling scan;
  * local attention over a full sequence goes through the banded attention
    kernel under the same switch; decode uses a ring-buffer KV cache of
    ``window`` slots;
  * training (``loss_fn``) re-computes each super-block in the backward
    under ``cfg.remat`` (the trailing layers are not, as in the
    reference, where they sit outside the scanned body).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..distributed import compat, ctx
from ..kernels import ops as kops
from ..kernels.rglru_scan import rglru_scan_plain
from . import layers as L

__all__ = ["rglru_scan_ref", "rglru_decode", "RecBlock", "MLPBlock",
           "SuperBlock", "HybridParams", "rec_apply", "attn_apply_local",
           "sblock_apply", "init", "forward", "loss_fn", "init_cache",
           "prefill", "decode_step", "counters"]

_C = 8.0  # RG-LRU "c" constant

#: The recurrence over a full sequence in plain PyTorch ops (the port of
#: the reference's ``rglru_scan_ref``).
rglru_scan_ref = rglru_scan_plain


def rglru_decode(h, x_gated, a):
    """One-step recurrence. h, x_gated, a: [B, D]."""
    return a * h + torch.sqrt(torch.clamp(1.0 - a * a, min=0.0)) * x_gated


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


class RecBlock(nn.Module):
    """Recurrent temporal block: norm, gate and input branches, a causal
    depthwise conv of width ``conv_width``, the RG-LRU, output projection."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        D = cfg.d_model
        DR = cfg.rglru_d_rnn or cfg.d_model
        self.ln = L.RMSNorm(D)
        self.wx = L.Linear(D, DR)
        self.wy = L.Linear(D, DR)
        self.conv_w = nn.Parameter(torch.empty(cfg.conv_width, DR))
        self.conv_b = nn.Parameter(torch.zeros(DR))
        self.wa = L.Linear(DR, DR)          # recurrence gate
        self.wi = L.Linear(DR, DR)          # input gate
        self.lam = nn.Parameter(torch.empty(DR))
        self.out = L.Linear(DR, D)

    def init_(self, gen: torch.Generator) -> None:
        self.wx.init_(gen)
        self.wy.init_(gen)
        L.normal_(self.conv_w, gen, scale=0.1)
        self.wa.init_(gen)
        self.wi.init_(gen)
        with torch.no_grad():
            self.lam.normal_(generator=gen).mul_(0.5).sub_(4.0)
        self.out.init_(gen)


class MLPBlock(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.ln = L.RMSNorm(cfg.d_model)
        self.ffn = L.MLP(cfg.d_model, cfg.d_ff)

    def init_(self, gen: torch.Generator) -> None:
        self.ffn.init_(gen)


class SuperBlock(nn.Module):
    """(rec + mlp, rec + mlp, local attn + mlp)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.rec1 = RecBlock(cfg)
        self.mlp1 = MLPBlock(cfg)
        self.rec2 = RecBlock(cfg)
        self.mlp2 = MLPBlock(cfg)
        self.attn_ln = L.RMSNorm(cfg.d_model)
        self.attn = L.Attention(cfg)
        self.mlp3 = MLPBlock(cfg)

    def init_(self, gen: torch.Generator) -> None:
        for m in (self.rec1, self.mlp1, self.rec2, self.mlp2, self.attn,
                  self.mlp3):
            m.init_(gen)


class HybridParams(nn.Module):
    """The whole model's parameters: ``embed``, ``blocks`` (one
    :class:`SuperBlock` per super-block), ``ln_f`` and the trailing
    ``tail_rec{i}`` / ``tail_mlp{i}``."""

    #: The module lists whose blocks the reference stacks on a leading
    #: axis (one leaf ``[n, ...]`` per parameter name).
    STACKED = ("blocks",)

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        n_super, n_tail = _structure(cfg)
        self.embed = L.Embedding(cfg.vocab, cfg.d_model)
        self.blocks = nn.ModuleList(SuperBlock(cfg) for _ in range(n_super))
        self.ln_f = L.RMSNorm(cfg.d_model)
        for i in range(n_tail):
            setattr(self, f"tail_rec{i}", RecBlock(cfg))
            setattr(self, f"tail_mlp{i}", MLPBlock(cfg))
        self.n_tail = n_tail

    def tail(self, i: int) -> Tuple[RecBlock, MLPBlock]:
        return getattr(self, f"tail_rec{i}"), getattr(self, f"tail_mlp{i}")


def _structure(cfg: ModelConfig) -> Tuple[int, int]:
    pat = len(cfg.block_pattern) or 3
    n_super = cfg.n_layers // pat
    return n_super, cfg.n_layers - n_super * pat   # trailing rec layers


def init(cfg: ModelConfig, seed: int = 0, device=None) -> HybridParams:
    """Random parameters from ``seed`` with the reference's distributions
    (normal / sqrt(fan_in) for linear weights, 0.02 for the embedding,
    0.1 for ``conv_w``, 0.5 normal - 4 for ``lam``, zero biases, unit norm
    scales), made on ``device`` in fp32. A ``torch.Generator`` does not
    give ``jax.random``'s numbers: tests carry the reference's weights
    across through ``interop.model_params_from_numpy``."""
    device = resolve_device(device)
    with torch.device("meta"):
        p = HybridParams(cfg)
    p = p.to_empty(device=device).requires_grad_(False)
    with torch.no_grad():
        for name, t in p.named_parameters():
            if name.endswith((".b", "conv_b")):
                t.zero_()
            elif name.endswith(".scale"):
                t.fill_(1.0)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    p.embed.init_(gen)
    for bp in p.blocks:
        bp.init_(gen)
    for i in range(p.n_tail):
        rec, mlp = p.tail(i)
        rec.init_(gen)
        mlp.init_(gen)
    return p


# ---------------------------------------------------------------------------
# Recurrent block
# ---------------------------------------------------------------------------


def _rglru_gates(p: RecBlock, u):
    """u [..., DR] conv output -> (a, gated input), both fp32."""
    r = torch.sigmoid(L.linear(p.wa, u).float())
    i = torch.sigmoid(L.linear(p.wi, u).float())
    log_a = -_C * F.softplus(p.lam) * r
    return torch.exp(log_a), i * u.float()


def rec_apply(cfg: ModelConfig, p: RecBlock, x, state: Optional[Dict] = None,
              use_kernel: bool = False):
    """Recurrent temporal block with its residual. ``state`` None runs the
    full sequence and returns the state after it; else one decode step from
    ``state = dict(h [B,DR] fp32, conv [B,W-1,DR])``."""
    h_in = L.rmsnorm(p.ln, x, cfg.norm_eps)
    gate = F.gelu(L.linear(p.wy, h_in), approximate="tanh")
    u = L.linear(p.wx, h_in)
    if state is None:
        u_raw = u
        u = L.causal_conv(u, p.conv_w, p.conv_b)
        a, b_in = _rglru_gates(p, u)
        if use_kernel and cfg.use_kernels and x.shape[1] % 128 == 0:
            h, h_last = kops.rglru_scan(b_in, a)
        elif ctx.active_mesh() is None:
            h, h_last = rglru_scan_ref(b_in, a)
        else:
            cs = ctx.spec(a.shape, "data", None, "model")
            h, h_last = compat.per_shard(
                rglru_scan_ref, (cs, cs),
                (cs, ctx.spec(a.shape[::2], "data", "model")), b_in, a)
        W = cfg.conv_width
        new_state = {"h": h_last, "conv": u_raw[:, u.shape[1] - (W - 1):, :]}
    else:
        conv_buf = torch.cat([state["conv"], u], dim=1)
        u1 = torch.einsum("bwc,wc->bc", conv_buf, p.conv_w.to(x.dtype))
        u1 = u1 + p.conv_b.to(x.dtype)
        a, b_in = _rglru_gates(p, u1[:, None])
        h1 = rglru_decode(state["h"], b_in[:, 0], a[:, 0])
        h = h1[:, None]
        new_state = {"h": h1, "conv": conv_buf[:, 1:]}
    y = h.to(x.dtype) * gate
    return x + L.linear(p.out, y), new_state


# ---------------------------------------------------------------------------
# Local attention with ring-buffer cache
# ---------------------------------------------------------------------------


def attn_apply_local(cfg: ModelConfig, p: L.Attention, x, positions, window,
                     ring: Optional[Dict] = None):
    """Full sequence (``ring`` None): banded attention through
    ``layers.attention_apply``. Decode: one token against the ring buffer
    ``ring = dict(k, v [B, window, Hkv, hd], pos)`` (``pos`` the absolute
    position of this token: a 0-d device tensor, read on the device only,
    or a host int); returns the output and the new ring (a new tensor pair:
    the input ring is left as it was)."""
    if ring is None:
        return L.attention_apply(p, cfg, x, positions, causal=True,
                                 window=window), None
    B, S, _ = x.shape
    hd = cfg.hd
    q = L._heads(L.linear(p.wq, x), cfg.n_heads, hd)
    k = L._heads(L.linear(p.wk, x), cfg.n_kv_heads, hd)
    v = L._heads(L.linear(p.wv, x), cfg.n_kv_heads, hd)
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)

    pos = ring["pos"]
    slot = pos % window
    group = cfg.n_heads // cfg.n_kv_heads

    def ring_attend(q, k, v, ck, cv):
        ck, cv = ck.clone(), cv.clone()
        L.write_rows(ck, slot, k)
        L.write_rows(cv, slot, v)
        # absolute position held by each slot j after the write
        j = torch.arange(window, device=q.device)
        valid = (pos - torch.remainder(slot - j, window)) >= 0
        qf = q.float() / math.sqrt(hd)
        qf = qf.reshape(q.shape[0], S, cfg.n_kv_heads, group, hd)
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, ck.float())
        logits = torch.where(valid, logits, -1e30)
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhgqk,bkhd->bqhgd", probs, cv.float())
        return out.reshape(q.shape[0], S, cfg.n_heads, hd).to(q.dtype), ck, cv

    if ctx.active_mesh() is None:
        out, ck, cv = ring_attend(q, k, v, ring["k"], ring["v"])
    else:
        # per shard, batch over data (DTensor has no rule for the grouped
        # einsum or the slot write)
        bs = ctx.spec(q.shape, "data", None, None, None)
        rs = ctx.spec(ring["k"].shape, "data", None, None, None)
        out, ck, cv = compat.per_shard(ring_attend, (bs, bs, bs, rs, rs),
                                       (bs, rs, rs), q, k, v, ring["k"],
                                       ring["v"])
    y = L.linear(p.wo, out.reshape(B, S, cfg.n_heads * hd))
    return y, {"k": ck, "v": cv, "pos": pos + 1}


# ---------------------------------------------------------------------------
# Super-block
# ---------------------------------------------------------------------------


def _mlp_res(cfg, p: MLPBlock, x):
    return x + L.mlp_apply(p.ffn, L.rmsnorm(p.ln, x, cfg.norm_eps))


def sblock_apply(cfg: ModelConfig, p: SuperBlock, x, positions, state=None,
                 use_kernel=False):
    """``state`` None (full sequence) or dict(h1, conv1, h2, conv2, ring_k,
    ring_v, pos) (one decode step). Returns (x, new state without pos)."""
    st = state or {}
    x, s1 = rec_apply(cfg, p.rec1, x,
                      state=None if state is None else
                      {"h": st["h1"], "conv": st["conv1"]},
                      use_kernel=use_kernel)
    x = _mlp_res(cfg, p.mlp1, x)
    x, s2 = rec_apply(cfg, p.rec2, x,
                      state=None if state is None else
                      {"h": st["h2"], "conv": st["conv2"]},
                      use_kernel=use_kernel)
    x = _mlp_res(cfg, p.mlp2, x)
    xa = L.rmsnorm(p.attn_ln, x, cfg.norm_eps)
    win = cfg.attn_window
    if state is None:
        h, _ = attn_apply_local(cfg, p.attn, xa, positions, win)
        # Fill the ring buffer with the last `window` keys/values, at their
        # absolute position mod window, so decode continues after prefill.
        B, S, _ = xa.shape
        hd = cfg.hd
        tail_len = min(S, win)
        xt = xa[:, S - tail_len:]
        pt = positions[:, S - tail_len:]
        kt = L.rope(L._heads(L.linear(p.attn.wk, xt), cfg.n_kv_heads, hd),
                    pt, cfg.rope_theta)
        vt = L._heads(L.linear(p.attn.wv, xt), cfg.n_kv_heads, hd)
        slots = torch.arange(S - tail_len, S, device=x.device) % win

        def fill(kt, vt):
            rk = kt.new_zeros((kt.shape[0], win) + kt.shape[2:])
            rv = torch.zeros_like(rk)
            rk[:, slots] = kt
            rv[:, slots] = vt
            return rk, rv

        if ctx.active_mesh() is None:
            rk, rv = fill(kt, vt)
        else:
            rs = ctx.spec(kt.shape, "data", None, None, None)
            rk, rv = compat.per_shard(fill, (rs, rs), (rs, rs), kt, vt)
    else:
        ring = {"k": st["ring_k"], "v": st["ring_v"], "pos": st["pos"]}
        h, nring = attn_apply_local(cfg, p.attn, xa, positions, win,
                                    ring=ring)
        rk, rv = nring["k"], nring["v"]
    new_state = {"h1": s1["h"], "conv1": s1["conv"], "h2": s2["h"],
                 "conv2": s2["conv"], "ring_k": rk, "ring_v": rv}
    x = x + h
    x = _mlp_res(cfg, p.mlp3, x)
    return ctx.hint(x, "data", "model", None), new_state


# ---------------------------------------------------------------------------
# Model: n_super super-blocks + trailing recurrent layers
# ---------------------------------------------------------------------------


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device).expand(B, S)


def forward(cfg: ModelConfig, params: HybridParams, tokens):
    """Full-sequence logits [B, S, vocab] in the activation dtype."""
    x = L.embed(params.embed, tokens, L.compute_dtype(cfg))
    B, S, _ = x.shape
    positions = _positions(B, S, x.device)
    for bp in params.blocks:
        x = L.remat(cfg, lambda x, bp=bp: sblock_apply(
            cfg, bp, x, positions, use_kernel=True)[0], x)
    for i in range(params.n_tail):
        rec, mlp = params.tail(i)
        x, _ = rec_apply(cfg, rec, x, use_kernel=True)
        x = _mlp_res(cfg, mlp, x)
    x = L.rmsnorm(params.ln_f, x, cfg.norm_eps)
    return L.unembed(params.embed, x)


def loss_fn(cfg: ModelConfig, params: HybridParams, batch: Dict):
    """Mean next-token cross-entropy of ``batch`` (``tokens``, ``labels``,
    optional ``mask``)."""
    logits = forward(cfg, params, batch["tokens"])
    return L.softmax_xent(logits, batch["labels"], batch.get("mask"))


def init_cache(cfg: ModelConfig, batch: int, dtype, device=None) -> Dict:
    """Zero decode state: per super-block h1/h2 [B, DR] fp32, conv1/conv2
    [B, W-1, DR], ring_k/ring_v [B, window, Hkv, hd]; per trailing layer h
    and conv; ``pos`` 0."""
    n_super, n_tail = _structure(cfg)
    DR = cfg.rglru_d_rnn or cfg.d_model
    W = cfg.conv_width
    device = resolve_device(device)
    z = lambda *shape, dt=dtype: torch.zeros(shape, dtype=dt, device=device)
    ring = (batch, cfg.attn_window, cfg.n_kv_heads, cfg.hd)
    blocks = [{"h1": z(batch, DR, dt=torch.float32), "conv1": z(batch, W - 1, DR),
               "h2": z(batch, DR, dt=torch.float32), "conv2": z(batch, W - 1, DR),
               "ring_k": z(*ring), "ring_v": z(*ring)}
              for _ in range(n_super)]
    tail = {f"tail{i}": {"h": z(batch, DR, dt=torch.float32),
                         "conv": z(batch, W - 1, DR)}
            for i in range(n_tail)}
    return {"blocks": blocks, "tail": tail, "pos": 0}


def prefill(cfg: ModelConfig, params: HybridParams, tokens,
            max_len: int = 0):
    """Prompt pass: last-token logits [B, 1, vocab] and the decode state
    (recurrent states, conv tails and ring buffers; ``pos`` = S, a 0-d
    device tensor). The state
    does not depend on ``max_len`` (the ring holds ``window`` slots)."""
    x = L.embed(params.embed, tokens, L.compute_dtype(cfg))
    B, S, _ = x.shape
    positions = _positions(B, S, x.device)
    bstates: List[Dict] = []
    for bp in params.blocks:
        x, ns = sblock_apply(cfg, bp, x, positions, use_kernel=True)
        bstates.append(ns)
    tail_state = {}
    for i in range(params.n_tail):
        rec, mlp = params.tail(i)
        x, s = rec_apply(cfg, rec, x, use_kernel=True)
        x = _mlp_res(cfg, mlp, x)
        tail_state[f"tail{i}"] = s
    x = L.rmsnorm(params.ln_f, x[:, -1:], cfg.norm_eps)
    logits = L.unembed(params.embed, x)
    return logits, {"blocks": bstates, "tail": tail_state,
                    "pos": L.device_pos(S, x.device)}


def decode_step(cfg: ModelConfig, params: HybridParams, token, cache):
    """One token per sequence (``token`` [B]) -> (logits [B, vocab], new
    state)."""
    x = L.embed(params.embed, token[:, None], L.compute_dtype(cfg))
    B = x.shape[0]
    pos = cache["pos"]
    positions = L.step_positions(pos, B, x.device)
    bstates = []
    for bp, st in zip(params.blocks, cache["blocks"]):
        x, ns = sblock_apply(cfg, bp, x, positions, state=dict(st, pos=pos))
        bstates.append(ns)
    tail_state = {}
    for i in range(params.n_tail):
        rec, mlp = params.tail(i)
        x, s = rec_apply(cfg, rec, x, state=cache["tail"][f"tail{i}"])
        x = _mlp_res(cfg, mlp, x)
        tail_state[f"tail{i}"] = s
    x = L.rmsnorm(params.ln_f, x, cfg.norm_eps)
    logits = L.unembed(params.embed, x)[:, 0]
    return logits, {"blocks": bstates, "tail": tail_state, "pos": pos + 1}


def counters(cfg: ModelConfig) -> Dict[str, int]:
    """The counters a request of this family reports: none."""
    return {}
