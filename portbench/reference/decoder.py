"""Plain float32 reference of the decoder-only families the cells serve:
the dense GQA decoder (Qwen2) and the top-k mixture of experts (OLMoE),
as their configuration files state them.

It imports nothing of the program. Its inputs are the benchmark's own: the
configuration file's ``model`` group, the weights the benchmark draws
(:mod:`portbench.weights`, handed over one group at a time through
``fetch``) and the tokens. Matrices are ``[d_in, d_out]`` (``x @ w``), as
the weights are laid out; everything computes in float32 (the caller
turns TF32 off).

A block: RMSNorm, GQA self-attention with rotary embeddings (the halves
rotated, ``theta ** (-i / (hd / 2))``) and, where ``qkv_bias``, biases on
q, k and v; the residual; RMSNorm, then the SwiGLU MLP ``wo(silu(wg x) *
wi x)`` or the mixture of experts; the residual. Then RMSNorm and an untied
head.

The mixture of experts routes as the configuration states it: a float32
softmax router, the ``top_k`` largest gates (ties to the lower expert),
renormalised to sum to one, and GShard capacity: tokens in groups of
``moe_group_size``, ``C = max(int(moe_capacity_factor * top_k * T / E), 1)``
slots per expert and group, the choices admitted in priority order (the
first choices of every token before the second ones, tokens in order), the
rest dropped. A served request is routed the way it was served: its
prompt in groups of ``min(moe_group_size, prompt)`` consecutive tokens,
and each generated token alone (a group of one, where nothing is dropped).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

__all__ = ["param_layout", "forward_logits"]

Layout = List[Tuple[str, List[Tuple[str, Tuple[int, ...], str]]]]


def param_layout(m: dict) -> Layout:
    """The weights as groups drawn one at a time: ``[(group, [(name, shape,
    kind), ...])]`` with the embedding first, one group a layer, then the
    final norm and the head. ``kind`` says how :mod:`portbench.weights`
    scales the draw."""
    D, hd, V = m["d_model"], m["head_dim"], m["vocab"]
    Hq, Hkv = m["n_heads"], m["n_kv_heads"]
    groups: Layout = [("embed", [("embed.table", (V, D), "embed")])]
    for i in range(m["n_layers"]):
        p = f"layers.{i}."
        items = [(p + "ln1.scale", (D,), "norm")]
        for name, width, kind in (("wq", Hq * hd, "qk"),
                                  ("wk", Hkv * hd, "qk"),
                                  ("wv", Hkv * hd, "in")):
            items.append((p + f"attn.{name}.w", (D, width), kind))
            if m.get("qkv_bias"):
                items.append((p + f"attn.{name}.b", (width,), "bias"))
        items += [(p + "attn.wo.w", (Hq * hd, D), "out"),
                  (p + "ln2.scale", (D,), "norm")]
        if m.get("n_experts", 0):
            E, Fe = m["n_experts"], m["d_expert"]
            items += [(p + "moe.wi", (E, D, Fe), "experts_in"),
                      (p + "moe.wg", (E, D, Fe), "experts_in"),
                      (p + "moe.wo", (E, Fe, D), "experts_out"),
                      (p + "moe.router.w", (D, E), "in")]
        else:
            Fd = m["d_ff"]
            items += [(p + "mlp.wi.w", (D, Fd), "in"),
                      (p + "mlp.wg.w", (D, Fd), "in"),
                      (p + "mlp.wo.w", (Fd, D), "out")]
        groups.append((f"layers.{i}", items))
    groups.append(("final", [("ln_f.scale", (D,), "norm"),
                             ("head.w", (D, V), "in")]))
    return groups


def _rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def _rope(x, theta: float):
    """x [N, H, hd] at positions 0 .. N-1."""
    N, _, hd = x.shape
    half = hd // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = torch.arange(N, dtype=torch.float32, device=x.device)[:, None] \
        * freq
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(m, w, p, x, mm, q_block: int = 1024):
    """Causal GQA self-attention of one sequence x [N, D]."""
    N = x.shape[0]
    Hq, Hkv, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]

    def proj(name, heads):
        y = mm(x, w[p + f"attn.{name}.w"])
        if m.get("qkv_bias"):
            y = y + w[p + f"attn.{name}.b"]
        return y.view(N, heads, hd)

    q = _rope(proj("wq", Hq), m["rope_theta"]) / math.sqrt(hd)
    k = _rope(proj("wk", Hkv), m["rope_theta"])
    v = proj("wv", Hkv)
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


def _route(m, xg, router_w):
    """GShard routing of token groups xg [G, T, D]: (expert [G, T, k],
    gate [G, T, k], kept [G, T, k])."""
    G, T, _ = xg.shape
    E, k = m["n_experts"], m["top_k"]
    C = max(int(m["moe_capacity_factor"] * k * T / E), 1)
    gates = torch.softmax(xg @ router_w, dim=-1)
    val, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    val, idx = val[..., :k], idx[..., :k]
    if m.get("norm_topk_prob", True):
        val = val / val.sum(-1, keepdim=True).clamp_min(1e-9)
    taken = torch.zeros(G, E, dtype=torch.int64, device=xg.device)
    kept = []
    for j in range(k):
        onehot = F.one_hot(idx[..., j], E)                      # [G, T, E]
        slot = torch.cumsum(onehot, 1) - onehot + taken[:, None]
        kept.append(torch.gather(slot, -1, idx[..., j:j + 1])[..., 0] < C)
        taken = taken + onehot.sum(1)
    return idx, val, torch.stack(kept, -1)


def _experts(m, w, p, xs, mm):
    """The mixture of experts over sequences ``xs = [(x [N, D], n_prompt)]``,
    each routed on its own, the experts run once over all their tokens."""
    k = m["top_k"]
    router = w[p + "moe.router.w"]
    idx, val, kept = [], [], []
    for x, n_prompt in xs:
        N, D = x.shape
        T = min(m["moe_group_size"], n_prompt)
        if n_prompt % T:
            raise ValueError(f"a prompt of {n_prompt} tokens is not a whole "
                             f"number of routing groups of {T}")
        parts = [_route(m, x[:n_prompt].view(n_prompt // T, T, D), router)]
        if N > n_prompt:
            parts.append(_route(m, x[n_prompt:].view(N - n_prompt, 1, D),
                                router))
        for a, b, c in parts:
            idx.append(a.reshape(-1, k))
            val.append(b.reshape(-1, k))
            kept.append(c.reshape(-1, k))
    idx, val, kept = torch.cat(idx), torch.cat(val), torch.cat(kept)
    x = torch.cat([x for x, _ in xs])
    out = torch.zeros_like(x)
    wi, wg, wo = w[p + "moe.wi"], w[p + "moe.wg"], w[p + "moe.wo"]
    for e in range(m["n_experts"]):
        tok, choice = torch.nonzero((idx == e) & kept, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok]
        ye = mm(F.silu(mm(xe, wg[e])) * mm(xe, wi[e]), wo[e])
        out.index_add_(0, tok, ye * val[tok, choice][:, None])
    return out


def forward_logits(m: dict, fetch: Callable[[str], Dict[str, torch.Tensor]],
                   seqs: Sequence[Tuple[torch.Tensor, int]],
                   positions: Sequence[torch.Tensor],
                   transform: Callable = None,
                   act: Callable = None) -> List[torch.Tensor]:
    """Logits [len(positions[r]), vocab] (float32) at the given positions of
    each sequence ``seqs[r] = (tokens [N_r], n_prompt_r)``.

    The weights come one group of :func:`param_layout` at a time from
    ``fetch(group)`` (name -> float32 tensor on the sequences' device), so
    that only one layer is held at once. The precision control's hooks,
    where given: ``transform(name, w)`` is applied to every weight as it
    arrives, ``act(x)`` to the input of every product with a weight matrix
    (the router's aside)."""
    eps = m["norm_eps"]
    mm = (lambda x, w: act(x) @ w) if act else (lambda x, w: x @ w)

    def weights(group):
        got = fetch(group)
        return {n: transform(n, t) for n, t in got.items()} \
            if transform else got

    w = weights("embed")
    hs = [w["embed.table"][tok] for tok, _ in seqs]
    del w
    for i in range(m["n_layers"]):
        w = weights(f"layers.{i}")
        p = f"layers.{i}."
        hs = [x + _attention(m, w, p, _rmsnorm(x, w[p + "ln1.scale"], eps),
                             mm)
              for x in hs]
        h = [_rmsnorm(x, w[p + "ln2.scale"], eps) for x in hs]
        if m.get("n_experts", 0):
            y = _experts(m, w, p, [(x, n) for x, (_, n) in zip(h, seqs)], mm)
        else:
            x = torch.cat(h)
            y = mm(F.silu(mm(x, w[p + "mlp.wg.w"])) * mm(x, w[p + "mlp.wi.w"]),
                   w[p + "mlp.wo.w"])
        hs = list(torch.split(torch.cat(hs) + y, [x.shape[0] for x in hs]))
        del w
    w = weights("final")
    return [mm(_rmsnorm(h[pos], w["ln_f.scale"], eps), w["head.w"])
            for h, pos in zip(hs, positions)]
