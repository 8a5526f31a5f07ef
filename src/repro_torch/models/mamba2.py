"""Mamba-2 (SSD, state-space duality) language model [arXiv:2405.21060].
The port of ``repro/models/mamba2.py``.

Each layer: rmsnorm, one input projection into ``z`` (gate), ``xBC``
(inputs and the B and C projections, shared by the heads) and ``dt``
(per-head steps), a causal depthwise conv over ``xBC``, the SSD scan, a
skip through ``D``, a gated rmsnorm and the output projection.
Nemotron-H's Mamba-2 layers (``models.nemotron_h``) set three options
whose defaults give the layer above: ``cfg.ssm_groups`` B/C groups (head
``i`` reads group ``i // (heads / groups)``), ``cfg.ssm_heads`` heads
whatever ``d_model`` is, and ``cfg.ssm_norm == "gate_norm"``, the
published ``MambaRMSNormGated(norm_before_gate=False)``: ``y * silu(z)``
first, then an rmsnorm over each group's ``d_inner / groups`` channels. The
reference's stacked ``[n_layers, ...]`` parameters are unrolled into a
``ModuleList`` of layers, and the decode state holds one tensor per layer.

  * over a full sequence the SSD scan goes through ``kernels.ops.ssd_scan``
    (the CUDA kernel on the card) when the config asks for kernels and the
    length is a multiple of ``ssm_chunk``, else through the plain chunked
    form (``kernels.ssd_scan.ssd_scan_plain``);
  * decode is O(1) a token: the state update ``S <- a S + dt B x^T`` and a
    rolling conv buffer, in plain PyTorch as in the reference;
  * training (``loss_fn``) re-computes each layer in the backward under
    ``cfg.remat``.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..distributed import compat, ctx
from ..kernels import ops as kops
from ..kernels import ssd_scan
from ..kernels.ssd_scan import ssd_scan_plain
from . import layers as L

__all__ = ["ssd_decode_step", "Mamba2Block", "SSMParams", "init",
           "block_apply", "forward", "loss_fn", "init_state", "prefill",
           "decode_step", "counters"]


def ssd_decode_step(S, x, dt, A, B, C):
    """One-token SSD update. S [b,h,n,p]; x [b,h,p]; dt [b,h]; A [h];
    B, C [b,g,n] (head ``i`` reads group ``i // (h // g)``) or [b,n]
    (shared by the heads: one group). Returns (y [b,h,p], new S)."""
    if B.dim() == 2:
        B, C = B[:, None], C[:, None]
    g = B.shape[1]
    heads = lambda t: t.unflatten(1, (g, -1))              # h -> (g, h/g)
    a = heads(torch.exp(dt * A[None, :]))                  # [b,g,r]
    S = heads(S) * a[..., None, None] + \
        B[:, :, None, :, None] * heads(dt[..., None] * x)[:, :, :, None, :]
    y = torch.einsum("bgn,bgrnp->bgrp", C, S)
    return y.flatten(1, 2), S.flatten(1, 2)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


class Mamba2Block(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        D, DI, H = cfg.d_model, cfg.d_inner, cfg.n_ssm_heads
        N = cfg.ssm_groups * cfg.ssm_state
        conv_dim = DI + 2 * N
        self.ln = L.RMSNorm(D)
        # in_proj -> [z (DI), xBC (DI + 2 G N), dt (H)]
        self.in_proj = L.Linear(D, 2 * DI + 2 * N + H)
        self.conv_w = nn.Parameter(torch.empty(cfg.conv_width, conv_dim))
        self.conv_b = nn.Parameter(torch.zeros(conv_dim))
        self.A_log = nn.Parameter(torch.empty(H))
        self.dt_bias = nn.Parameter(torch.zeros(H))
        self.D = nn.Parameter(torch.ones(H))
        self.norm = L.RMSNorm(DI)
        self.out_proj = L.Linear(DI, D)

    def init_(self, gen: torch.Generator) -> None:
        self.in_proj.init_(gen)
        L.normal_(self.conv_w, gen, scale=0.1)
        with torch.no_grad():
            H = self.A_log.shape[0]
            self.A_log.copy_(torch.log(torch.linspace(
                1.0, 16.0, H, dtype=torch.float32,
                device=self.A_log.device)))
        self.out_proj.init_(gen)


class SSMParams(nn.Module):
    """The whole model's parameters: ``embed``, ``layers`` (one
    :class:`Mamba2Block` per layer) and ``ln_f``."""

    #: The module lists whose blocks the reference stacks on a leading
    #: axis (one leaf ``[n, ...]`` per parameter name).
    STACKED = ("layers",)

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.embed = L.Embedding(cfg.vocab, cfg.d_model)
        self.layers = nn.ModuleList(Mamba2Block(cfg)
                                    for _ in range(cfg.n_layers))
        self.ln_f = L.RMSNorm(cfg.d_model)


def init(cfg: ModelConfig, seed: int = 0, device=None) -> SSMParams:
    """Random parameters from ``seed`` with the reference's distributions
    (normal / sqrt(fan_in) for the projections, 0.02 for the embedding,
    0.1 for ``conv_w``; ``A_log = log(linspace(1, 16, H))``; zero
    ``conv_b`` and ``dt_bias``; unit ``D`` and norm scales), made on
    ``device`` in fp32. A ``torch.Generator`` does not give
    ``jax.random``'s numbers: tests carry the reference's weights across
    through ``interop.model_params_from_numpy``."""
    device = resolve_device(device)
    with torch.device("meta"):
        p = SSMParams(cfg)
    p = p.to_empty(device=device).requires_grad_(False)
    with torch.no_grad():
        for name, t in p.named_parameters():
            leaf = name.rpartition(".")[2]
            if leaf in ("conv_b", "dt_bias"):
                t.zero_()
            elif leaf in ("scale", "D"):
                t.fill_(1.0)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    p.embed.init_(gen)
    for lp in p.layers:
        lp.init_(gen)
    return p


# ---------------------------------------------------------------------------
# Block
# ---------------------------------------------------------------------------


def _split_proj(cfg: ModelConfig, proj):
    DI, N = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state
    return proj[..., :DI], proj[..., DI: 2 * DI + 2 * N], \
        proj[..., 2 * DI + 2 * N:]


def _bc(cfg: ModelConfig, xBC, DI: int):
    """B and C of the conv output ``xBC`` [..., DI + 2 G N]: views [..., N]
    where one group serves every head, else [..., G, N]."""
    G, N = cfg.ssm_groups, cfg.ssm_state
    Bm, Cm = xBC[..., DI: DI + G * N], xBC[..., DI + G * N:]
    if G == 1:
        return Bm, Cm
    return (Bm.unflatten(-1, (G, N)), Cm.unflatten(-1, (G, N)))


def _gated_norm(cfg: ModelConfig, p: "Mamba2Block", y, z):
    """The gated rmsnorm of ``cfg.ssm_norm``: ``norm_gate`` (rmsnorm over
    the whole width, then times silu(z)) or ``gate_norm`` (times silu(z),
    then an rmsnorm over each group's channels; the product and the norm
    in f32, as the published ``MambaRMSNormGated`` computes them)."""
    if cfg.ssm_norm == "norm_gate":
        return L.rmsnorm(p.norm, y, cfg.norm_eps) * F.silu(z)
    if cfg.ssm_norm != "gate_norm":
        raise ValueError(f"unknown ssm_norm {cfg.ssm_norm!r}")
    g = (y.float() * F.silu(z.float())).unflatten(-1, (cfg.ssm_groups, -1))
    g = g * torch.rsqrt(g.square().mean(-1, keepdim=True) + cfg.norm_eps)
    return (g.flatten(-2) * p.norm.scale).to(y.dtype)


def _ssd_plain(cfg: ModelConfig, xs, dts, A, Bm, Cm):
    """``ssd_scan_plain``; under a mesh per shard (batch over data, heads
    over model: the scan has no cross-head term, and DTensor no rule for
    its merged-dim products)."""
    if ctx.active_mesh() is None:
        return ssd_scan_plain(xs, dts, A, Bm, Cm, cfg.ssm_chunk)
    hs = ctx.spec(xs.shape, "data", None, "model", None)
    ss = ctx.spec(dts.shape, "data", None, "model")
    bs = ctx.spec(Bm.shape, "data", *(None,) * (Bm.dim() - 1))
    return compat.per_shard(
        lambda *a: ssd_scan_plain(*a, cfg.ssm_chunk),
        (hs, ss, ctx.spec(A.shape, "model"), bs, bs),
        (hs, ctx.spec((xs.shape[0], xs.shape[2]), "data", "model", None,
                      None)), xs, dts, A, Bm, Cm)


def block_apply(cfg: ModelConfig, p: Mamba2Block, x, state=None,
                use_kernel: bool = False):
    """One layer with its residual. ``state`` None runs the full sequence
    and returns the state after it; else one decode step from
    ``state = dict(ssm [B,H,N,P] fp32, conv [B,W-1,DI+2N])``."""
    B_, Lq, _ = x.shape
    DI, H, P = cfg.d_inner, cfg.n_ssm_heads, cfg.ssm_head_dim
    h = L.rmsnorm(p.ln, x, cfg.norm_eps)
    proj = L.linear(p.in_proj, h)
    z, xBC, dt = _split_proj(cfg, proj)
    A = -torch.exp(p.A_log)

    if state is None:
        xBC_raw = xBC
        xBC = F.silu(L.causal_conv(xBC, p.conv_w, p.conv_b))
        xs = xBC[..., :DI].reshape(B_, Lq, H, P)      # views: no copy
        Bm, Cm = _bc(cfg, xBC, DI)
        dts = F.softplus(dt.float() + p.dt_bias)
        if use_kernel and cfg.use_kernels and Lq % cfg.ssm_chunk == 0:
            y, S_fin = kops.ssd_scan(xs, dts, A, Bm, Cm, chunk=cfg.ssm_chunk)
        else:
            y, S_fin = _ssd_plain(cfg, xs, dts, A, Bm, Cm)
        y = y.to(x.dtype)
        W = cfg.conv_width
        # a copy, so the state does not hold the whole projection alive
        new_state = {"ssm": S_fin.float(),
                     "conv": xBC_raw[:, Lq - (W - 1):, :].clone()}
    else:
        # decode: roll the conv buffer, single-step SSD
        conv_buf = torch.cat([state["conv"], xBC], dim=1)         # [B,W,C]
        xBC1 = torch.einsum("bwc,wc->bc", conv_buf, p.conv_w.to(x.dtype)) \
            + p.conv_b.to(x.dtype)
        xBC1 = F.silu(xBC1)
        xs = xBC1[..., :DI].reshape(B_, H, P)
        Bm, Cm = (v.float() for v in _bc(cfg, xBC1, DI))
        dts = F.softplus(dt[:, 0].float() + p.dt_bias)
        y1, S = ssd_decode_step(state["ssm"], xs.float(), dts, A, Bm, Cm)
        y = y1[:, None].to(x.dtype)
        xs = xs[:, None]
        new_state = {"ssm": S, "conv": conv_buf[:, 1:]}

    y = y + xs.reshape(B_, Lq, H, P) * p.D[None, None, :, None].to(x.dtype)
    y = y.reshape(B_, Lq, DI)
    y = _gated_norm(cfg, p, y, z)
    return (ctx.hint(x + L.linear(p.out_proj, y), "data", "model", None),
            new_state)


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


def forward(cfg: ModelConfig, params: SSMParams, tokens):
    """Full-sequence logits [B, S, vocab] in the activation dtype."""
    x = L.embed(params.embed, tokens, L.compute_dtype(cfg))
    for lp in params.layers:
        x = L.remat(cfg, lambda x, lp=lp: block_apply(cfg, lp, x,
                                                      use_kernel=True)[0], x)
    x = L.rmsnorm(params.ln_f, x, cfg.norm_eps)
    return L.unembed(params.embed, x)


def loss_fn(cfg: ModelConfig, params: SSMParams, batch: Dict):
    """Mean next-token cross-entropy of ``batch`` (``tokens``, ``labels``,
    optional ``mask``)."""
    logits = forward(cfg, params, batch["tokens"])
    return L.softmax_xent(logits, batch["labels"], batch.get("mask"))


def init_state(cfg: ModelConfig, batch: int, dtype, device=None) -> Dict:
    """Zero decode state: per layer ``ssm`` [B, H, N, P] fp32 and ``conv``
    [B, W-1, DI+2GN] in ``dtype``; ``pos`` 0."""
    N, H, P = cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_head_dim
    conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * N
    device = resolve_device(device)
    return {"ssm": [torch.zeros((batch, H, N, P), dtype=torch.float32,
                                device=device)
                    for _ in range(cfg.n_layers)],
            "conv": [torch.zeros((batch, cfg.conv_width - 1, conv_dim),
                                 dtype=dtype, device=device)
                     for _ in range(cfg.n_layers)],
            "pos": 0}


def prefill(cfg: ModelConfig, params: SSMParams, tokens, max_len: int = 0):
    """Prompt pass: last-token logits [B, 1, vocab] and the decode state
    (per layer ``ssm`` and ``conv``; ``pos`` = S, a 0-d device tensor).
    The state is O(1) in the
    sequence length and does not depend on ``max_len``."""
    x = L.embed(params.embed, tokens, L.compute_dtype(cfg))
    ssms, convs = [], []
    for lp in params.layers:
        x, ns = block_apply(cfg, lp, x, use_kernel=True)
        ssms.append(ns["ssm"])
        convs.append(ns["conv"])
    x = L.rmsnorm(params.ln_f, x[:, -1:], cfg.norm_eps)
    logits = L.unembed(params.embed, x)
    return logits, {"ssm": ssms, "conv": convs,
                    "pos": L.device_pos(tokens.shape[1], x.device)}


def decode_step(cfg: ModelConfig, params: SSMParams, token, cache):
    """One token per sequence (``token`` [B]) -> (logits [B, vocab], new
    state)."""
    x = L.embed(params.embed, token[:, None], L.compute_dtype(cfg))
    ssms, convs = [], []
    for lp, ssm, conv in zip(params.layers, cache["ssm"], cache["conv"]):
        x, ns = block_apply(cfg, lp, x, state={"ssm": ssm, "conv": conv})
        ssms.append(ns["ssm"])
        convs.append(ns["conv"])
    x = L.rmsnorm(params.ln_f, x, cfg.norm_eps)
    logits = L.unembed(params.embed, x)[:, 0]
    return logits, {"ssm": ssms, "conv": convs, "pos": cache["pos"] + 1}


def counters(cfg: ModelConfig) -> Dict[str, int]:
    """The counters a request of this family reports, as they stand:
    ``ssd_launches``, the SSD scan kernel's calls (a prompt pass takes it
    on the card; a decode step does not)."""
    return {"ssd_launches": ssd_scan.LAUNCHES}
