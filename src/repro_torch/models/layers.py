"""Shared layers of the ported families, as functions on parameter modules.

The counterpart of ``repro/models/layers.py``, kept to what the serving
paths of the dense (Qwen2, SmolLM, the LLaVA backbone), MoE (OLMoE,
Qwen3-MoE), encoder-decoder (SeamlessM4T), hybrid (RecurrentGemma) and SSM
(Mamba-2) families need. Conventions, as in the reference:

  * parameters are ``nn.Module`` trees whose names follow the reference's
    parameter pytree (``interop.model_params_from_numpy`` maps one onto
    the other); linear weights are ``[d_in, d_out]`` (``x @ w``);
  * activations flow in ``cfg.dtype``; parameters are stored fp32 and cast
    to the activation dtype at use (linear weights and biases, the
    embedding table, the conv taps), while those in ``FP32_AT_USE`` stay
    fp32 and ``rmsnorm`` computes in fp32 before the final cast;
  * attention is GQA with RoPE; ``window > 0`` masks to a local band;
    ``kv_source`` makes it cross-attention over a memory (no RoPE, no
    cache, not causal);
  * a KV cache is ``{"k": [per layer [B, max_len, Hkv, hd]], "v": ...,
    "pos": int}``: one preallocated tensor pair per layer (the reference
    stacks them ``[n_layers, ...]``), written in place, with ``pos`` a host
    int.

Training: the cross-entropy losses (:func:`softmax_xent`, and
:func:`softmax_xent_chunked`, which never holds the ``[B, S, V]`` logits)
compute in f32, and :func:`remat` re-computes a block in the backward
(``cfg.remat``, as the reference wraps its scanned body in
``jax.checkpoint``).

Left out (on no path): the distributed-decode branch of
``attention_apply`` (``dist_decode.applicable`` is false on one device),
and ``scan_blocks`` (the port loops over layers in Python).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..kernels import ops as kops
from ..kernels.flash_attention import sdpa

__all__ = ["FP32_AT_USE", "fp32_at_use", "compute_dtype", "Linear",
           "RMSNorm", "Attention", "MLP", "Embedding", "normal_", "linear",
           "rmsnorm", "causal_conv", "rope", "attention_apply", "make_cache",
           "mlp_apply", "embed", "unembed", "_sdpa", "remat", "softmax_xent",
           "softmax_xent_chunked"]

#: Parameter names that stay fp32 at use, matched against the last parts of
#: a parameter's dotted name (:func:`fp32_at_use`): the ``rmsnorm`` scales,
#: the RG-LRU ``lam``, Mamba-2's ``A_log`` and ``dt_bias`` (``A =
#: -exp(A_log)`` and ``softplus(dt + dt_bias)`` are f32 in the reference)
#: and the MoE router's weight (the reference routes in f32: ``xg.astype(
#: f32) @ router.w``). Every other parameter is cast to the activation
#: dtype where it is used.
FP32_AT_USE = ("scale", "lam", "A_log", "dt_bias", "router.w")


def fp32_at_use(name: str) -> bool:
    """Whether the parameter of dotted ``name`` stays fp32 at use: its last
    parts equal an entry of ``FP32_AT_USE`` (``layers.3.moe.router.w``
    matches ``router.w``; ``layers.3.attn.wq.w`` matches nothing)."""
    return any(name == e or name.endswith("." + e) for e in FP32_AT_USE)


#: The reference's plain attention (``layers._sdpa``, with its query-blocked
#: form from 8,192 query rows): the model's branch when the kernels are
#: off, and the function the attention kernel computes.
_sdpa = sdpa


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def normal_(t: torch.Tensor, gen: torch.Generator, scale=None) -> None:
    """The reference's ``_init``: normal times ``scale``, by default
    1/sqrt(fan_in) with fan_in the first dimension of a matrix (1 for a
    vector). For stacked weights (the MoE experts' ``[E, D, F]``) the
    first dimension is not the fan-in: pass ``scale``."""
    fan_in = t.shape[0] if t.dim() > 1 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    with torch.no_grad():
        t.normal_(generator=gen).mul_(scale)


# ---------------------------------------------------------------------------
# Parameter modules (names as in the reference's pytree)
# ---------------------------------------------------------------------------


class Linear(nn.Module):
    def __init__(self, d_in: int, d_out: int, bias: bool = False):
        super().__init__()
        self.w = nn.Parameter(torch.empty(d_in, d_out))
        if bias:
            self.b = nn.Parameter(torch.zeros(d_out))

    def init_(self, gen: torch.Generator) -> None:
        normal_(self.w, gen)


class RMSNorm(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d))


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        hd = cfg.hd
        self.wq = Linear(cfg.d_model, cfg.n_heads * hd, cfg.qkv_bias)
        self.wk = Linear(cfg.d_model, cfg.n_kv_heads * hd, cfg.qkv_bias)
        self.wv = Linear(cfg.d_model, cfg.n_kv_heads * hd, cfg.qkv_bias)
        self.wo = Linear(cfg.n_heads * hd, cfg.d_model)

    def init_(self, gen: torch.Generator) -> None:
        for lin in (self.wq, self.wk, self.wv, self.wo):
            lin.init_(gen)


class MLP(nn.Module):
    """SwiGLU: ``wo(silu(wg x) * wi x)``."""

    def __init__(self, d_model: int, d_ff: int):
        super().__init__()
        self.wi = Linear(d_model, d_ff)
        self.wg = Linear(d_model, d_ff)
        self.wo = Linear(d_ff, d_model)

    def init_(self, gen: torch.Generator) -> None:
        for lin in (self.wi, self.wg, self.wo):
            lin.init_(gen)


class Embedding(nn.Module):
    def __init__(self, vocab: int, d_model: int):
        super().__init__()
        self.table = nn.Parameter(torch.empty(vocab, d_model))

    def init_(self, gen: torch.Generator) -> None:
        # GPT-style 0.02 scale: keeps tied-unembedding logits O(1) at init
        normal_(self.table, gen, scale=0.02)


# ---------------------------------------------------------------------------
# Functions
# ---------------------------------------------------------------------------


def linear(p: Linear, x: torch.Tensor) -> torch.Tensor:
    y = x @ p.w.to(x.dtype)
    if hasattr(p, "b"):
        y = y + p.b.to(x.dtype)
    return y


def rmsnorm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p.scale).to(x.dtype)


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                ) -> torch.Tensor:
    """Causal depthwise conv over time: x [B, S, C], w [W, C], b [C]; one
    tap at a time, accumulating in x's dtype as the reference does."""
    W = w.shape[0]
    pad = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros_like(x)
    for i in range(W):
        out = out + pad[:, i: i + x.shape[1], :] * w[i].to(x.dtype)
    return out + b.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embedding. x [B, S, H, hd]; positions [B, S] (int)."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[..., None].float() * freq               # [B,S,half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1.to(x.dtype), y2.to(x.dtype)], dim=-1)


def attention_apply(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor, *, causal: bool = True,
                    window: int = 0, cache=None, kv_source=None,
                    use_rope: bool = True) -> torch.Tensor:
    """Self- or cross-attention.

    With ``kv_source`` [B, S_mem, D] (cross-attention, the encoder's
    states): K and V come from the memory, no RoPE, no cache, not causal,
    through the plain ``_sdpa``, as in the reference (its attention kernel
    serves causal self-attention only). ``use_rope=False`` leaves RoPE out
    of self-attention too.

    With no ``cache``: over the whole sequence; the kernel branch is taken
    under the reference's condition (``use_kernels``, S a multiple of 128,
    hd a multiple of 8, causal), otherwise the plain ``_sdpa``.

    With ``cache = {"k", "v": [B, max_len, Hkv, hd], "pos": int}`` (one
    layer's pair): this step's K/V are written IN PLACE at ``pos`` and the
    queries attend over the cache, ``_sdpa(q, ck, cv, causal, q_offset=pos,
    kv_len=pos+S)`` as in the reference; the caller advances ``pos``. Under
    ``use_kernels`` (and no window) the kernel computing that function is
    taken instead: at ``pos == 0`` under the condition above (the prefill),
    ``flash_attention`` over the cache rows just written (every row at or
    past S is masked); at ``S == 1`` (decode), ``decode_attention`` with
    ``kv_len = pos + 1``."""
    B, S, _ = x.shape
    hd = cfg.hd
    q = linear(p.wq, x).reshape(B, S, cfg.n_heads, hd)
    kv_in = x if kv_source is None else kv_source
    S_kv = kv_in.shape[1]
    k = linear(p.wk, kv_in).reshape(B, S_kv, cfg.n_kv_heads, hd)
    v = linear(p.wv, kv_in).reshape(B, S_kv, cfg.n_kv_heads, hd)
    if kv_source is not None:
        out = _sdpa(q, k, v, causal=False, window=0, q_offset=0)
        return linear(p.wo, out.reshape(B, S, cfg.n_heads * hd))
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    flash_ok = S % 128 == 0 and hd % 8 == 0 and causal
    if cache is None:
        if cfg.use_kernels and flash_ok:
            out = kops.flash_attention(q, k, v, window=window)
        else:
            out = _sdpa(q, k, v, causal=causal, window=window, q_offset=0)
    else:
        pos = int(cache["pos"])
        ck, cv = cache["k"], cache["v"]
        if pos + S > ck.shape[1]:
            raise ValueError(f"KV cache of {ck.shape[1]} positions is full: "
                             f"{S} more at position {pos}")
        ck[:, pos:pos + S] = k.to(ck.dtype)
        cv[:, pos:pos + S] = v.to(cv.dtype)
        kernels = cfg.use_kernels and not window
        if kernels and pos == 0 and flash_ok:
            out = kops.flash_attention(q, ck[:, :S], cv[:, :S])
        elif kernels and S == 1:
            out = kops.decode_attention(q, ck, cv, pos + 1)
        else:
            out = _sdpa(q, ck, cv, causal=causal, window=window,
                        q_offset=pos, kv_len=pos + S)
    return linear(p.wo, out.reshape(B, S, cfg.n_heads * hd))


def make_cache(cfg: ModelConfig, batch: int, max_len: int, n_layers: int,
               dtype, device=None):
    """Zero KV cache of capacity ``max_len``: per layer ``k`` and ``v``
    ``[batch, max_len, Hkv, hd]`` in ``dtype``; ``pos`` 0."""
    device = resolve_device(device)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    z = lambda: torch.zeros(shape, dtype=dtype, device=device)
    return {"k": [z() for _ in range(n_layers)],
            "v": [z() for _ in range(n_layers)], "pos": 0}


def mlp_apply(p: MLP, x: torch.Tensor) -> torch.Tensor:
    return linear(p.wo, F.silu(linear(p.wg, x)) * linear(p.wi, x))


def embed(p: Embedding, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return p.table.to(dtype)[tokens]


def unembed(p: Embedding, x: torch.Tensor) -> torch.Tensor:
    """Tied unembedding; logits in the activation dtype."""
    return x @ p.table.to(x.dtype).T


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def remat(cfg: ModelConfig, fn, *args):
    """``fn(*args)``, re-computed in the backward instead of keeping its
    activations when ``cfg.remat`` is set and autograd is recording (the
    reference's ``jax.checkpoint`` around each scanned block). Under
    ``torch.no_grad()``/``torch.inference_mode()`` (serving) it is a plain
    call."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _token_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-token ``logsumexp - label logit`` in f32; the label logit taken
    by an index compare and a masked sum, as the reference does (no gather
    across the vocabulary)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    ll = torch.where(vocab == labels[..., None], logits, 0.0).sum(dim=-1)
    return logz - ll


def _mean_loss(loss: torch.Tensor, mask) -> torch.Tensor:
    if mask is not None:
        loss = loss * mask
        return loss.sum() / torch.clamp(mask.sum().to(loss.dtype), min=1.0)
    return loss.mean()


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask=None) -> torch.Tensor:
    """Mean token cross-entropy in f32 over logits [..., V] and integer
    ``labels`` [...]; with ``mask`` (same shape as ``labels``) the masked
    mean, ``sum(loss * mask) / max(sum(mask), 1)``."""
    return _mean_loss(_token_xent(logits, labels), mask)


def softmax_xent_chunked(x: torch.Tensor, table: torch.Tensor,
                         labels: torch.Tensor, mask=None,
                         transpose_table: bool = False,
                         chunk: int = 512) -> torch.Tensor:
    """:func:`softmax_xent` of the logits ``x @ table.T`` (``table`` the
    tied ``[V, D]`` embedding) or ``x @ table`` (``transpose_table``: an
    untied head ``[D, V]``) over the final hidden ``x`` [B, S, D], one
    sequence chunk at a time: each chunk's ``[B, chunk, V]`` logits are
    reduced to per-token losses and dropped, and re-computed in the
    backward (``torch.utils.checkpoint``, as the reference's
    ``jax.checkpoint``), so the ``[B, S, V]`` logits never exist. The
    chunk is the largest divisor of S no larger than ``chunk``."""
    B, S, _ = x.shape
    chunk = min(chunk, S)
    while S % chunk:
        chunk -= 1

    def body(xc, lc):
        w = table.to(xc.dtype)
        return _token_xent(xc @ w if transpose_table else xc @ w.T, lc)

    parts = []
    for i in range(0, S, chunk):
        xc, lc = x[:, i:i + chunk], labels[:, i:i + chunk]
        parts.append(checkpoint(body, xc, lc, use_reentrant=False)
                     if torch.is_grad_enabled() else body(xc, lc))
    return _mean_loss(torch.cat(parts, dim=1), mask)
