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
    "pos": ...}``: one preallocated tensor pair per layer (the reference
    stacks them ``[n_layers, ...]``), written in place. ``pos`` is a 0-d
    int64 tensor on the cache's device after a prefill (the reference's
    jitted steps carry it as an array), so that a decode step reads it on
    the device only and a CUDA graph of the step replays at every
    position (:func:`step_positions`, :func:`write_rows`); the zero
    stand-ins of ``make_cache`` and the dry-run keep a host int 0.

Training: the cross-entropy losses (:func:`softmax_xent`, and
:func:`softmax_xent_chunked`, which never holds the ``[B, S, V]`` logits)
compute in f32, and :func:`remat` re-computes a block in the backward
(``cfg.remat``, as the reference wraps its scanned body in
``jax.checkpoint``).

Under a mesh (``distributed.ctx``) the parameters and activations are
DTensors and the layers run on them as they are; the attention is the one
place that goes through ``compat.shard_map`` (:func:`_sdpa_sharded`: DTensor
has no sharding rule for the ``[B, H]``-merged products of its einsums),
and ``ctx.hint`` pins the reference's activation layouts. Without a mesh
both are no-ops. Left out (on no path): ``scan_blocks`` (the port loops
over layers in Python).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor import zeros as dtensor_zeros

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..distributed import compat, ctx, dist_decode
from ..kernels import ops as kops
from ..kernels.flash_attention import sdpa

__all__ = ["FP32_AT_USE", "fp32_at_use", "compute_dtype", "Linear",
           "RMSNorm", "Attention", "MLP", "Embedding", "normal_", "linear",
           "rmsnorm", "causal_conv", "rope", "device_pos", "step_positions",
           "write_rows", "attention_apply", "make_cache", "mlp_apply",
           "embed", "unembed", "_sdpa", "remat", "softmax_xent",
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


def _sdpa(q, k, v, *, causal: bool, window: int, q_offset=0, kv_len=None):
    """The reference's plain attention (``layers._sdpa``, with its
    query-blocked form from 8,192 query rows): the model's branch when the
    kernels are off, and the function the attention kernel computes. On
    DTensors (under a mesh) it runs per shard (:func:`_sdpa_sharded`)."""
    if isinstance(q, DTensor):
        return _sdpa_sharded(q, k, v, causal=causal, window=window,
                             q_offset=q_offset, kv_len=kv_len)
    return sdpa(q, k, v, causal=causal, window=window, q_offset=q_offset,
                kv_len=kv_len)


def _sdpa_sharded(q, k, v, *, causal: bool, window: int, q_offset: int = 0,
                  kv_len=None):
    """:func:`sdpa` of DTensors, one shard at a time (``compat.shard_map``):
    the batch over the data axes, and over "model" the query heads when
    they divide it, else the query sequence (the reference's sequence
    parallelism; a rank's queries start at its offset), else nothing. Each
    shard takes K/V whole along heads and sequence and picks the KV head of
    each of its query heads (head h reads h // (Hq/Hkv)), so every row is
    computed by the same ops as on one device. The two splits are the
    layouts of the reference's hints on the logits (``layers.py:139-141``,
    ``188-190``), which here fall inside the shard."""
    mesh = q.device_mesh
    Sq, Hq = q.shape[1], q.shape[2]
    group = Hq // k.shape[2]
    m = ctx.axis_size("model")
    if m > 1 and Hq % m == 0:
        mode, roles = "heads", ("data", None, "model", None)
    elif m > 1 and Sq % m == 0:
        mode, roles = "seq", ("data", "model", None, None)
    else:
        mode, roles = None, ("data", None, None, None)
    qspec = ctx.spec(q.shape, *roles)
    kvspec = ctx.spec(k.shape, "data", None, None, None)

    def body(ql, kl, vl):
        r = compat.axis_index(mesh, "model") if mode else 0
        off = q_offset
        if mode == "heads":
            idx = (torch.arange(ql.shape[2], device=ql.device)
                   + r * ql.shape[2]) // group
            kl, vl = kl[:, :, idx], vl[:, :, idx]
        elif group > 1:
            kl = kl.repeat_interleave(group, dim=2)
            vl = vl.repeat_interleave(group, dim=2)
        if mode == "seq":
            off = q_offset + r * ql.shape[1]
        return sdpa(ql, kl, vl, causal=causal, window=window, q_offset=off,
                    kv_len=kv_len)

    return compat.shard_map(body, mesh, (qspec, kvspec, kvspec), qspec)(
        q, k, v)


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


def _gather_inner(x: torch.Tensor) -> torch.Tensor:
    """``x`` [B, ..., D] as it is; a DTensor sharded on a dim between the
    batch and the last (the sequence-sharded residual stream) gathered
    there first: DTensor has no rule for a product over leading dims
    sharded on two mesh axes (Megatron-SP's all-gather before a
    column-parallel product)."""
    if not isinstance(x, DTensor) or x.dim() <= 2:
        return x
    want = [Replicate() if isinstance(p, Shard) and 0 < p.dim < x.dim() - 1
            else p for p in x.placements]
    if want == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def _pin(y: torch.Tensor) -> torch.Tensor:
    """``y``; a DTensor passed through a redistribution to its own
    placements, which does nothing forward and brings its gradient back to
    them (not sequence-sharded) before the product's backward."""
    if not isinstance(y, DTensor):
        return y
    return y.redistribute(y.device_mesh, y.placements)


def _heads(y: torch.Tensor, n_heads: int, hd: int) -> torch.Tensor:
    """y [B, S, n_heads * hd] as [B, S, n_heads, hd]. A DTensor sharded on
    its last dim over more ranks than divide the heads (Qwen2-7B's 28 heads
    over 16) is gathered there first: a shard would cut a head, which
    DTensor's view refuses (the reference's compiler reshards the same
    way)."""
    if isinstance(y, DTensor):
        sizes = y.device_mesh.shape
        want = [Replicate() if isinstance(p, Shard) and p.dim == y.dim() - 1
                and n_heads % sizes[i] else p
                for i, p in enumerate(y.placements)]
        if want != list(y.placements):
            y = y.redistribute(y.device_mesh, want)
    return y.reshape(y.shape[0], y.shape[1], n_heads, hd)


def linear(p: Linear, x: torch.Tensor) -> torch.Tensor:
    x = _gather_inner(x)
    y = _pin(x @ p.w.to(x.dtype))
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


def device_pos(n: int, device) -> torch.Tensor:
    """A decode state's ``pos`` as a prefill leaves it: the 0-d int64 ``n``
    on ``device``, made there by a fill (no host-to-device copy)."""
    return torch.full((), n, dtype=torch.int64, device=device)


def step_positions(pos, B: int, device) -> torch.Tensor:
    """The [B, 1] int64 positions of a decode step at ``pos``: a 0-d device
    tensor expanded (no host read), or a host int filled in."""
    if isinstance(pos, torch.Tensor):
        return pos.reshape(1, 1).expand(B, 1)
    return torch.full((B, 1), pos, dtype=torch.int64, device=device)


def write_rows(cache: torch.Tensor, at, x: torch.Tensor) -> None:
    """``cache[:, at:at + S] = x`` in place (x [B, S, ...], cast to the
    cache's dtype): a slice at a host int ``at``; at a 0-d device tensor,
    ``index_copy_`` into the rows ``at + arange(S)``, read on the device
    only."""
    x = x.to(cache.dtype)
    if isinstance(at, torch.Tensor):
        rows = torch.arange(x.shape[1], device=cache.device) + at
        cache.index_copy_(1, rows, x)
    else:
        cache[:, at:at + x.shape[1]] = x


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

    With ``cache = {"k", "v": [B, max_len, Hkv, hd], "pos": ...}`` (one
    layer's pair; ``pos`` the prefill's host int 0, or a decode step's 0-d
    device tensor): this step's K/V are written IN PLACE at ``pos``
    (:func:`write_rows`) and the queries attend over the cache,
    ``_sdpa(q, ck, cv, causal, q_offset=pos, kv_len=pos+S)`` as in the
    reference; the caller advances ``pos``. The cache's capacity is the
    caller's to respect (``ServeEngine.generate`` checks it on the host):
    a device ``pos`` is never read here. Under ``use_kernels`` (and no
    window) the kernel computing that function is taken instead: at
    ``pos == 0`` under the condition above (the prefill), ``flash_attention``
    over the cache rows just written (every row at or past S is masked); at
    ``S == 1`` (decode), ``decode_attention`` with ``kv_len = pos + 1``
    (a device tensor where ``pos`` is one)."""
    B, S, _ = x.shape
    hd = cfg.hd
    x = _gather_inner(x)           # once for the three projections
    q = _heads(linear(p.wq, x), cfg.n_heads, hd)
    kv_in = x if kv_source is None else kv_source
    k = _heads(linear(p.wk, kv_in), cfg.n_kv_heads, hd)
    v = _heads(linear(p.wv, kv_in), cfg.n_kv_heads, hd)
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
        pos = cache["pos"]
        ck, cv = cache["k"], cache["v"]
        sharded = dist_decode.applicable(ck.shape[1], S)
        if not sharded:
            write_rows(ck, pos, k)
            write_rows(cv, pos, v)
        kernels = cfg.use_kernels and not window
        if sharded:
            # sequence-sharded cache: the owning rank writes, every rank
            # attends over its block, log-sum-exp merge (dist_decode, which
            # takes a host position)
            out, _, _ = dist_decode.decode_attention(q, k, v, ck, cv,
                                                     int(pos))
        elif kernels and flash_ok and pos == 0:
            # (flash_ok first: a decode step's device pos is never compared
            # on the host)
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
    ``[batch, max_len, Hkv, hd]`` in ``dtype``; ``pos`` the host int 0 (a
    prefill hands its cache on with a device ``pos``). Under a mesh
    each is a DTensor placed by ``sharding.cache_specs_tree``."""
    device = resolve_device(device)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    mesh = ctx.active_mesh()
    if mesh is None:
        z = lambda: torch.zeros(shape, dtype=dtype, device=device)
        return {"k": [z() for _ in range(n_layers)],
                "v": [z() for _ in range(n_layers)], "pos": 0}
    # under a mesh: DTensors in the serving layout (the reference's prefill
    # out_shardings), each rank making only its shard
    from ..distributed.sharding import cache_specs_tree, placements
    spec = cache_specs_tree(cfg, {"k": [torch.empty(shape, device="meta")]},
                            mesh)["k"][0]
    z = lambda: dtensor_zeros(shape, dtype=dtype, device_mesh=mesh,
                              placements=placements(spec, mesh))
    return {"k": [z() for _ in range(n_layers)],
            "v": [z() for _ in range(n_layers)], "pos": 0}


def mlp_apply(p: MLP, x: torch.Tensor) -> torch.Tensor:
    x = _gather_inner(x)           # once for both input projections
    return linear(p.wo, F.silu(linear(p.wg, x)) * linear(p.wi, x))


def embed(p: Embedding, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """The rows of ``tokens``. Under a mesh the lookup runs per shard
    (:func:`_embed_sharded`) and leaves in the residual stream's layout
    (batch over data, sequence over model), which the reference's layer
    scan gives its carry from the first block on."""
    table = p.table.to(dtype)
    if not isinstance(table, DTensor):
        return table[tokens]
    return ctx.hint(_embed_sharded(table, tokens), "data", "model", None)


def _embed_sharded(table, tokens):
    """``table[tokens]`` with the vocabulary rows over "model" (the table's
    TP spec) and the tokens' batch over data, per shard: each model rank
    looks up the tokens in its rows, zeroes the others, and the ranks' rows
    are summed (Megatron's vocabulary-parallel embedding). DTensor's own
    rule for the lookup's backward (``index_put``) fails in some PyTorch
    releases; on one rank along "model" this is the plain lookup."""
    mesh = table.device_mesh
    ts = ctx.spec(table.shape, "model", None)
    xs = ctx.spec(tokens.shape, "data", *(None,) * (tokens.dim() - 1))

    def body(tab, tok):
        if ts[0] is None:
            return tab[tok]
        lo = compat.axis_index(mesh, "model") * tab.shape[0]
        local = tok - lo
        mine = (local >= 0) & (local < tab.shape[0])
        rows = tab[torch.where(mine, local, 0)] * mine[..., None].to(tab.dtype)
        return compat.psum_replicated(rows, mesh, "model")

    return compat.shard_map(body, mesh, (ts, xs),
                            ctx.spec(tuple(tokens.shape) + (1,), "data"))(
        table, tokens)


def unembed(p: Embedding, x: torch.Tensor) -> torch.Tensor:
    """Tied unembedding; logits in the activation dtype."""
    return _pin(_gather_inner(x) @ p.table.to(x.dtype).T)


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
    across the vocabulary). Under a mesh per shard, the vocabulary over
    "model" (:func:`_token_xent_sharded`)."""
    if isinstance(logits, DTensor):
        return _token_xent_sharded(logits, labels)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    ll = torch.where(vocab == labels[..., None], logits, 0.0).sum(dim=-1)
    return logz - ll


def _token_xent_sharded(logits, labels):
    """:func:`_token_xent` of DTensor logits laid out as the reference's
    hint puts them (batch over data, vocabulary over "model"), per shard:
    the masked reduce partitions cleanly, as the reference's comment says —
    each rank's partial exp-sum (under the max over the ranks) and label
    logit, summed over "model" (vocabulary-parallel cross-entropy). DTensor's
    own rules for the backward gather the batch or the vocabulary (tens of
    GB a device at train_4k). On one rank along "model" this is the plain
    function."""
    mesh = logits.device_mesh
    ls = ctx.spec(logits.shape, "data", *(None,) * (logits.dim() - 2),
                  "model")
    ys = ctx.spec(labels.shape, "data", *(None,) * (labels.dim() - 1))

    def body(lg, lab):
        if ls[-1] is None:
            return _token_xent(lg, lab)
        lg = lg.float()
        m = compat.pmax(lg.detach().amax(dim=-1), mesh, "model")
        e = torch.exp(lg - m[..., None]).sum(dim=-1)
        logz = m + torch.log(compat.psum_replicated(e, mesh, "model"))
        v0 = compat.axis_index(mesh, "model") * lg.shape[-1]
        vocab = v0 + torch.arange(lg.shape[-1], device=lg.device)
        ll = torch.where(vocab == lab[..., None], lg, 0.0).sum(dim=-1)
        return logz - compat.psum_replicated(ll, mesh, "model")

    return compat.shard_map(body, mesh, (ls, ys), ys)(logits, labels)


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
        xc = _gather_inner(xc)
        w = table.to(xc.dtype)
        return _token_xent(_pin(xc @ w if transpose_table else xc @ w.T), lc)

    parts = []
    for i in range(0, S, chunk):
        xc, lc = x[:, i:i + chunk], labels[:, i:i + chunk]
        parts.append(checkpoint(body, xc, lc, use_reentrant=False)
                     if torch.is_grad_enabled() else body(xc, lc))
    return _mean_loss(torch.cat(parts, dim=1), mask)
