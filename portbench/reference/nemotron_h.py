"""Plain float32 reference of Nemotron-H (NVIDIA Nemotron-3-Nano-30B-A3B):
Mamba-2, GQA attention and sigmoid-routed mixture-of-experts layers in one
stack, as its configuration file states it (the model group's
``layer_pattern``: M Mamba-2, E MoE, * attention).

It imports nothing of the program, and has the interface of
:mod:`decoder`: ``param_layout(m)`` and ``forward_logits(m, fetch, seqs,
positions, transform=None, act=None)``. Matrices are ``[d_in, d_out]``
(``x @ w``); everything computes in float32 (the caller turns TF32 off);
one layer's weights are held at a time. Each sequence runs on its own.

A block: ``x <- x + mixer(RMSNorm(x))``; after the last, RMSNorm and the
untied head. The mixers:

  * Mamba-2: ``[z | xBC | dt] = h W_in``; ``xBC <- silu(causal depthwise
    conv1d(xBC) + bias)`` (width ``conv_width``); ``xBC = [x (H heads of
    P) | B (G groups of N) | C (G of N)]``, head ``i`` reading group ``i //
    (H / G)``; ``dt <- softplus(dt + dt_bias)``, ``A = -exp(A_log)``; the
    SSD recurrence ``S_t = exp(dt_t A) S_{t-1} + dt_t B_t x_t^T``, ``y_t =
    C_t . S_t + D x_t``, computed by the Mamba-2 paper's minimal chunked
    form (``ssd_minimal_discrete``, arXiv:2405.21060, written out here);
    ``y <- y * silu(z)``, then an RMSNorm over each group's ``H P / G``
    channels times the scale; ``y W_out``.
  * Attention: q, k, v projections without bias, causal softmax at
    ``1/sqrt(head_dim)``, GQA, no rotary embedding; ``W_o``.
  * MoE: ``s = sigmoid(h W_r)`` over all ``n_experts``; the ``top_k``
    largest of ``s + e_bias`` chosen (ties to the lower expert; the bias
    only chooses); weights ``s / (sum of the chosen s + 1e-20) *
    routed_scaling``; the sum over the chosen experts this device holds
    (the first ``experts_held``) of ``w_e W_down,e(relu(W_up,e h)^2)``, a
    loop over the held experts, nothing dropped; plus the shared expert
    ``W_down,s(relu(W_up,s h)^2)``.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

__all__ = ["param_layout", "forward_logits"]

Layout = List[Tuple[str, List[Tuple[str, Tuple[int, ...], str]]]]

#: Steps of one chunk of the minimal SSD (any length gives the same result
#: up to rounding; the sequence is padded at its end to a whole chunk).
SSD_BLOCK = 64


def _dims(m: dict):
    H, P = m["ssm_heads"], m["ssm_head_dim"]
    G, N = m["ssm_groups"], m["ssm_state"]
    return H, P, G, N, H * P


def param_layout(m: dict) -> Layout:
    """The weights as groups drawn one at a time: ``[(group, [(name, shape,
    kind), ...])]``, the embedding, one group a layer, the final norm and
    head; ``kind`` says how :mod:`portbench.weights` scales the draw.

    The kinds give a draw that exercises the state: ``A_log`` at ``embed``
    (N(0, 1): decay rates ``exp(A_log)`` spread over about two orders of
    magnitude, as the published init's A in [1, 16] does, so that some
    heads carry their state over hundreds of steps and others forget
    within a few); ``dt_bias`` and the router's correction ``e_bias`` at
    ``bias`` (not zero, so both paths are read: the bias moves some
    choices); ``D`` at ``norm`` (near one); the conv taps at ``in`` (1/2 a
    tap for width 4, so the conv's output keeps its input's scale); the
    output projections, ``W_o``, the experts' and shared expert's down
    projections at the depth-scaled ``out``/``experts_out``."""
    D, V, hd = m["d_model"], m["vocab"], m["head_dim"]
    Hq, Hkv = m["n_heads"], m["n_kv_heads"]
    H, P, G, N, DI = _dims(m)
    conv = DI + 2 * G * N
    groups: Layout = [("embed", [("embed.table", (V, D), "embed")])]
    for i, kind in enumerate(m["layer_pattern"]):
        p = f"layers.{i}."
        items = [(p + "ln.scale", (D,), "norm")]
        if kind == "M":
            items += [(p + "in_proj.w", (D, 2 * DI + 2 * G * N + H), "in"),
                      (p + "conv_w", (m["conv_width"], conv), "in"),
                      (p + "conv_b", (conv,), "bias"),
                      (p + "A_log", (H,), "embed"),
                      (p + "dt_bias", (H,), "bias"),
                      (p + "D", (H,), "norm"),
                      (p + "norm.scale", (DI,), "norm"),
                      (p + "out_proj.w", (DI, D), "out")]
        elif kind == "*":
            items += [(p + "attn.wq.w", (D, Hq * hd), "qk"),
                      (p + "attn.wk.w", (D, Hkv * hd), "qk"),
                      (p + "attn.wv.w", (D, Hkv * hd), "in"),
                      (p + "attn.wo.w", (Hq * hd, D), "out")]
        elif kind == "E":
            E, Fe, Fs = m["n_experts"], m["d_expert"], m["d_shared_expert"]
            held = m["experts_held"] or E
            items += [(p + "moe.router.w", (D, E), "in"),
                      (p + "moe.e_bias", (E,), "bias"),
                      (p + "moe.wi", (held, D, Fe), "experts_in"),
                      (p + "moe.wo", (held, Fe, D), "experts_out"),
                      (p + "moe.shared.wi.w", (D, Fs), "in"),
                      (p + "moe.shared.wo.w", (Fs, D), "out")]
        else:
            raise ValueError(f"unknown layer kind {kind!r}")
        groups.append((f"layers.{i}", items))
    groups.append(("final", [("ln_f.scale", (D,), "norm"),
                             ("head.w", (D, V), "in")]))
    return groups


def _rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def _segsum(x):
    """x [..., T] -> [..., T, T]: the sum of x over (j, i] at [i, j] for j
    <= i, -inf above the diagonal (the paper's stable ``segsum``)."""
    T = x.shape[-1]
    x = x[..., None].expand(*x.shape, T)
    lower = torch.ones(T, T, dtype=torch.bool, device=x.device).tril(-1)
    s = torch.cumsum(x.masked_fill(~lower, 0.0), dim=-2)
    diag = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    return s.masked_fill(~diag, -math.inf)


def _ssd_minimal(X, A, B, C, block: int):
    """The Mamba-2 paper's ``ssd_minimal_discrete`` for one sequence: X [L,
    H, P] (x dt), A [L, H] (A dt), B and C [L, H, N] -> y [L, H, P]; L a
    whole number of ``block``s, zero initial state."""
    L_, H, P = X.shape
    c = L_ // block
    X, A, B, C = (t.reshape(c, block, *t.shape[1:]) for t in (X, A, B, C))
    A = A.permute(2, 0, 1)                                  # [H, c, l]
    A_cum = torch.cumsum(A, dim=-1)
    # 1. the outputs inside each chunk (the diagonal blocks)
    Lm = torch.exp(_segsum(A))                              # [H, c, l, s]
    CB = torch.einsum("clhn,cshn->hcls", C, B)
    Y_diag = torch.einsum("hcls,cshp->clhp", CB * Lm, X)
    # 2. each chunk's state from its own steps
    decay = torch.exp(A_cum[..., -1:] - A_cum)              # [H, c, l]
    states = torch.einsum("clhn,hcl,clhp->chpn", B, decay, X)
    # 3. the recurrence across chunks
    states = torch.cat([torch.zeros_like(states[:1]), states], dim=0)
    decay_chunk = torch.exp(_segsum(F.pad(A_cum[..., -1], (1, 0))))
    states = torch.einsum("hzc,chpn->zhpn", decay_chunk, states)[:-1]
    # 4. the state entering each chunk, read out
    Y_off = torch.einsum("clhn,chpn,hcl->clhp", C, states, torch.exp(A_cum))
    return (Y_diag + Y_off).reshape(L_, H, P)


def _mamba(m, w, p, x, mm):
    """One Mamba-2 mixer over one sequence x [L, D] (already normed)."""
    H, P, G, N, DI = _dims(m)
    L_ = x.shape[0]
    zxbcdt = mm(x, w[p + "in_proj.w"])
    z, xBC, dt = torch.split(zxbcdt, [DI, DI + 2 * G * N, H], dim=-1)
    cw = w[p + "conv_w"]
    W = cw.shape[0]
    pad = F.pad(xBC, (0, 0, W - 1, 0))
    xBC = sum(pad[i:i + L_] * cw[i] for i in range(W)) + w[p + "conv_b"]
    xBC = F.silu(xBC)
    xs, Bm, Cm = torch.split(xBC, [DI, G * N, G * N], dim=-1)
    xs = xs.reshape(L_, H, P)
    Bh = Bm.reshape(L_, G, N).repeat_interleave(H // G, dim=1)
    Ch = Cm.reshape(L_, G, N).repeat_interleave(H // G, dim=1)
    dt = F.softplus(dt + w[p + "dt_bias"])                  # [L, H]
    A = -torch.exp(w[p + "A_log"])
    n = -(-L_ // SSD_BLOCK) * SSD_BLOCK
    padL = lambda t: F.pad(t, (0, 0) * (t.dim() - 1) + (0, n - L_))
    y = _ssd_minimal(padL(xs * dt[..., None]), padL(A * dt), padL(Bh),
                     padL(Ch), SSD_BLOCK)[:L_]
    y = y + xs * w[p + "D"][:, None]
    y = y.reshape(L_, DI) * F.silu(z)
    y = _rmsnorm(y.reshape(L_, G, DI // G), 1.0, m["norm_eps"])
    y = y.reshape(L_, DI) * w[p + "norm.scale"]
    return mm(y, w[p + "out_proj.w"])


def _attention(m, w, p, x, mm, q_block: int = 1024):
    """Causal GQA self-attention of one sequence x [N, D], no RoPE."""
    N = x.shape[0]
    Hq, Hkv, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    q = mm(x, w[p + "attn.wq.w"]).view(N, Hq, hd) / math.sqrt(hd)
    k = mm(x, w[p + "attn.wk.w"]).view(N, Hkv, hd)
    v = mm(x, w[p + "attn.wv.w"]).view(N, Hkv, hd)
    k = k.repeat_interleave(Hq // Hkv, dim=1)
    v = v.repeat_interleave(Hq // Hkv, dim=1)
    out = torch.empty_like(q)
    keys = torch.arange(N, device=x.device)
    for s in range(0, N, q_block):
        e = min(s + q_block, N)
        scores = torch.einsum("qhd,khd->hqk", q[s:e], k[:e])
        later = keys[None, :e] > torch.arange(s, e, device=x.device)[:, None]
        scores = scores.masked_fill(later[None], float("-inf"))
        out[s:e] = torch.einsum("hqk,khd->qhd", torch.softmax(scores, -1),
                                v[:e])
    return mm(out.reshape(N, Hq * hd), w[p + "attn.wo.w"])


def _moe(m, w, p, x, mm):
    """The held experts' share of the routed MoE, plus the shared expert,
    over tokens x [T, D]."""
    k = m["top_k"]
    s = torch.sigmoid(x @ w[p + "moe.router.w"])            # [T, E]
    _, idx = torch.sort(s + w[p + "moe.e_bias"], dim=-1, descending=True,
                        stable=True)
    idx = idx[:, :k]
    g = torch.gather(s, 1, idx)
    g = g / (g.sum(-1, keepdim=True) + 1e-20) * m["routed_scaling"]
    wi, wo = w[p + "moe.wi"], w[p + "moe.wo"]
    relu2 = lambda t: torch.square(F.relu(t))
    out = torch.zeros_like(x)
    for e in range(wi.shape[0]):                            # held experts
        tok, choice = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel():
            ye = mm(relu2(mm(x[tok], wi[e])), wo[e])
            out.index_add_(0, tok, ye * g[tok, choice][:, None])
    shared = mm(relu2(mm(x, w[p + "moe.shared.wi.w"])),
                w[p + "moe.shared.wo.w"])
    return out + shared


def forward_logits(m: dict, fetch: Callable[[str], Dict[str, torch.Tensor]],
                   seqs: Sequence[Tuple[torch.Tensor, int]],
                   positions: Sequence[torch.Tensor],
                   transform: Callable = None,
                   act: Callable = None) -> List[torch.Tensor]:
    """Logits [len(positions[r]), vocab] (float32) at the given positions of
    each sequence ``seqs[r] = (tokens [N_r], n_prompt_r)``.

    The weights come one group of :func:`param_layout` at a time from
    ``fetch(group)`` (name -> float32 tensor on the sequences' device). The
    precision control's hooks, where given: ``transform(name, w)`` is
    applied to every weight as it arrives, ``act(x)`` to the input of
    every product with a weight matrix (the router's aside)."""
    eps = m["norm_eps"]
    mm = (lambda x, w: act(x) @ w) if act else (lambda x, w: x @ w)

    def weights(group):
        got = fetch(group)
        return {n: transform(n, t) for n, t in got.items()} \
            if transform else got

    w = weights("embed")
    hs = [w["embed.table"][tok] for tok, _ in seqs]
    del w
    for i, kind in enumerate(m["layer_pattern"]):
        w = weights(f"layers.{i}")
        p = f"layers.{i}."
        h = [_rmsnorm(x, w[p + "ln.scale"], eps) for x in hs]
        if kind == "M":
            ys = [_mamba(m, w, p, x, mm) for x in h]
        elif kind == "*":
            ys = [_attention(m, w, p, x, mm) for x in h]
        else:
            y = _moe(m, w, p, torch.cat(h), mm)
            ys = list(torch.split(y, [x.shape[0] for x in h]))
        hs = [x + y for x, y in zip(hs, ys)]
        del w
    w = weights("final")
    return [mm(_rmsnorm(h[pos], w["ln_f.scale"], eps), w["head.w"])
            for h, pos in zip(hs, positions)]
