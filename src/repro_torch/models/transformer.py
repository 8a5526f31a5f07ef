"""Dense decoder-only transformer (the llama/Qwen family, also the VLM
backbone) and the encoder-decoder (SeamlessM4T). The port of
``repro/models/transformer.py``.

Each block: rmsnorm, GQA self-attention with RoPE (and QKV biases where the
config has them), residual; rmsnorm, SwiGLU MLP, residual. The reference's
stacked ``[n_layers, ...]`` block parameters are unrolled into a
``ModuleList``, and the KV cache holds one ``[B, max_len, Hkv, hd]`` pair
per layer (``layers.make_cache``), written in place.

  * over a full sequence (``forward``) attention goes through
    ``kernels.ops.flash_attention`` under the reference's kernel condition;
  * the prompt pass (``prefill``) and each decode step attend through the
    cache branch of ``layers.attention_apply``, as in the reference: with
    ``use_kernels``, the prefill through ``flash_attention`` and each decode
    step through ``kernels.ops.decode_attention`` (the CUDA kernels on the
    card), else the plain ``_sdpa`` over the cache.

The unembedding is tied to the embedding table (``tie_embeddings``, e.g.
SmolLM) or a separate ``head`` (Qwen2). ``forward`` and ``prefill`` take
frontend ``embeds`` [B, S_f, D] (the VLM's patch embeddings, from
``models.frontend``), prepended to the token embeddings.

The encoder-decoder: an encoder of dense blocks over frame embeddings
(non-causal, so its attention is the plain ``_sdpa``), then decoder blocks
with a cross-attention residual (``ln_x``, ``xattn``) over the encoder's
states. Its prefill cache carries those states as ``"enc"``; the decoder's
self-attention takes the kernel branches as the dense family does, and
the cross-attention the plain ``_sdpa`` (the reference takes its attention
kernel for causal self-attention only).

Training (``loss_fn``, ``encdec_loss``): the full-sequence forwards run
each block under ``layers.remat`` (``cfg.remat``) when autograd records,
and the loss is ``layers.softmax_xent`` over the logits, or
``softmax_xent_chunked`` over the final hidden (``cfg.chunked_xent``).
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..distributed import ctx
from ..kernels import rope_append
from . import layers as L

__all__ = ["DenseBlock", "DenseParams", "EncDecBlock", "EncDecParams", "init",
           "block_apply", "forward", "loss_fn", "prefill", "decode_step",
           "encdec_init", "encode", "encdec_forward", "encdec_loss",
           "encdec_prefill", "encdec_decode_step", "counters"]


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


class DenseBlock(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.d_model)
        self.attn = L.Attention(cfg)
        self.ln2 = L.RMSNorm(cfg.d_model)
        self.mlp = L.MLP(cfg.d_model, cfg.d_ff)

    def init_(self, gen: torch.Generator) -> None:
        self.attn.init_(gen)
        self.mlp.init_(gen)


class DenseParams(nn.Module):
    """The whole model's parameters: ``embed``, ``layers`` (one
    :class:`DenseBlock` per layer), ``ln_f`` and, when the unembedding is
    not tied, ``head``."""

    #: The module lists whose blocks the reference stacks on a leading
    #: axis (one leaf ``[n, ...]`` per parameter name).
    STACKED = ("layers",)

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.embed = L.Embedding(cfg.vocab, cfg.d_model)
        self.layers = nn.ModuleList(DenseBlock(cfg)
                                    for _ in range(cfg.n_layers))
        self.ln_f = L.RMSNorm(cfg.d_model)
        if not cfg.tie_embeddings:
            self.head = L.Linear(cfg.d_model, cfg.vocab)


class EncDecBlock(DenseBlock):
    """A decoder block of the encoder-decoder: a dense block plus the
    cross-attention's ``ln_x`` and ``xattn``."""

    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        self.ln_x = L.RMSNorm(cfg.d_model)
        self.xattn = L.Attention(cfg)

    def init_(self, gen: torch.Generator) -> None:
        super().init_(gen)
        self.xattn.init_(gen)


class EncDecParams(nn.Module):
    """``embed``, ``enc_layers`` (dense blocks), ``enc_ln``, ``layers``
    (:class:`EncDecBlock`), ``ln_f`` and ``head``."""

    #: The module lists whose blocks the reference stacks on a leading
    #: axis (one leaf ``[n, ...]`` per parameter name).
    STACKED = ("enc_layers", "layers")

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.embed = L.Embedding(cfg.vocab, cfg.d_model)
        self.enc_layers = nn.ModuleList(DenseBlock(cfg)
                                        for _ in range(cfg.n_encoder_layers))
        self.enc_ln = L.RMSNorm(cfg.d_model)
        self.layers = nn.ModuleList(EncDecBlock(cfg)
                                    for _ in range(cfg.n_layers))
        self.ln_f = L.RMSNorm(cfg.d_model)
        self.head = L.Linear(cfg.d_model, cfg.vocab)


def _init_params(module: type, cfg: ModelConfig, seed: int, device):
    """``module(cfg)`` on ``device`` in fp32 with the reference's
    distributions: zero biases, unit norm scales, then each submodule's
    ``init_`` (normal / sqrt(fan_in) for linear weights, 0.02 for the
    embedding) from one generator seeded with ``seed``."""
    device = resolve_device(device)
    with torch.device("meta"):
        p = module(cfg)
    p = p.to_empty(device=device).requires_grad_(False)
    with torch.no_grad():
        for name, t in p.named_parameters():
            if name.endswith(".b"):
                t.zero_()
            elif name.endswith(".scale"):
                t.fill_(1.0)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    for m in p.children():
        if isinstance(m, nn.ModuleList):
            for lp in m:
                lp.init_(gen)
        elif hasattr(m, "init_"):
            m.init_(gen)
    return p


def init(cfg: ModelConfig, seed: int = 0, device=None) -> DenseParams:
    """Random parameters from ``seed`` with the reference's distributions
    (normal / sqrt(fan_in) for linear weights and the head, 0.02 for the
    embedding, zero QKV biases, unit norm scales), made on ``device`` in
    fp32. A ``torch.Generator`` does not give ``jax.random``'s numbers:
    tests carry the reference's weights across through
    ``interop.model_params_from_numpy``."""
    return _init_params(DenseParams, cfg, seed, device)


def encdec_init(cfg: ModelConfig, seed: int = 0,
                device=None) -> EncDecParams:
    """The encoder-decoder's parameters, as :func:`init` makes them."""
    return _init_params(EncDecParams, cfg, seed, device)


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


def block_apply(cfg: ModelConfig, p: DenseBlock, x, positions, cache=None,
                *, causal: bool = True, enc=None):
    """One block with its residuals; ``cache`` (one layer's ``k``, ``v``
    and ``pos``) is written in place. With ``enc`` (the encoder's states)
    the block is a decoder block of the encoder-decoder and adds the
    cross-attention residual after the self-attention's. Under a mesh the
    residual stream leaves the block sequence-sharded over "model"
    (Megatron-SP, the reference's hint after each scanned block)."""
    x = x + L.attention_apply(p.attn, cfg, L.rmsnorm(p.ln1, x, cfg.norm_eps),
                              positions, causal=causal, cache=cache)
    if enc is not None:
        x = x + L.attention_apply(p.xattn, cfg,
                                  L.rmsnorm(p.ln_x, x, cfg.norm_eps),
                                  positions, kv_source=enc, use_rope=False)
    x = x + L.mlp_apply(p.mlp, L.rmsnorm(p.ln2, x, cfg.norm_eps))
    return ctx.hint(x, "data", "model", None)


def _logits(cfg: ModelConfig, params: DenseParams, x):
    x = L.rmsnorm(params.ln_f, x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return L.unembed(params.embed, x)
    return L.linear(params.head, x)


def _embed_inputs(cfg: ModelConfig, params, tokens, embeds, dtype):
    """Token embeddings, with frontend embeddings (VLM patches) prepended."""
    parts = []
    if embeds is not None:
        parts.append(embeds.to(dtype))
    if tokens is not None:
        parts.append(L.embed(params.embed, tokens, dtype))
    if not parts:
        raise ValueError("give tokens, embeds or both")
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def forward(cfg: ModelConfig, params: DenseParams, tokens=None, embeds=None,
            return_hidden: bool = False):
    """Full-sequence causal logits [B, S, vocab] in the activation dtype
    (S counts the ``embeds`` rows prepended to the tokens); with
    ``return_hidden`` the final hidden after ``ln_f`` [B, S, D] instead."""
    x = _embed_inputs(cfg, params, tokens, embeds, L.compute_dtype(cfg))
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    if cfg.pipeline_stages > 1:
        # GPipe over the "pod" axis (distributed.pipeline); as in the
        # reference, this branch returns the logits
        from ..distributed.pipeline import pipeline_scan

        def block_fn(lp, h):
            return L.remat(cfg, lambda h: block_apply(
                cfg, lp, h, positions[: h.shape[0]]), h)

        x = pipeline_scan(block_fn, list(params.layers), x,
                          n_stages=cfg.pipeline_stages,
                          n_microbatches=cfg.pipeline_microbatches)
        return _logits(cfg, params, x)
    for lp in params.layers:
        x = L.remat(cfg, lambda x, lp=lp: block_apply(cfg, lp, x, positions),
                    x)
    if return_hidden:
        return L.rmsnorm(params.ln_f, x, cfg.norm_eps)
    return _logits(cfg, params, x)


def loss_fn(cfg: ModelConfig, params: DenseParams, batch: Dict):
    """Mean next-token cross-entropy of ``batch`` (``tokens``, ``labels``,
    optional ``embeds`` and ``mask``); the frontend rows carry no labels,
    so the loss reads the last ``labels.shape[1]`` positions."""
    labels = batch["labels"]
    n = labels.shape[1]
    if cfg.chunked_xent:
        h = forward(cfg, params, batch.get("tokens"), batch.get("embeds"),
                    return_hidden=True)[:, -n:]
        if cfg.tie_embeddings:
            return L.softmax_xent_chunked(h, params.embed.table, labels,
                                          batch.get("mask"))
        return L.softmax_xent_chunked(h, params.head.w, labels,
                                      batch.get("mask"), transpose_table=True)
    logits = forward(cfg, params, batch.get("tokens"), batch.get("embeds"))
    return L.softmax_xent(logits[:, -n:], labels, batch.get("mask"))


def prefill(cfg: ModelConfig, params: DenseParams, tokens,
            max_len: int = 0, embeds=None):
    """Prompt pass: last-token logits [B, 1, vocab] and a KV cache of
    capacity ``max_len`` (0: the prompt's length) holding the prompt's keys
    and values, ``pos`` = S as a 0-d device tensor (``embeds`` rows
    prepended, as in :func:`forward`)."""
    x = _embed_inputs(cfg, params, tokens, embeds, L.compute_dtype(cfg))
    B, S, _ = x.shape
    max_len = max_len or S
    if max_len < S:
        raise ValueError(f"prefill: max_len {max_len} < prompt length {S}")
    cache = L.make_cache(cfg, B, max_len, cfg.n_layers, x.dtype, x.device)
    positions = torch.arange(S, device=x.device).expand(B, S)
    for lp, ck, cv in zip(params.layers, cache["k"], cache["v"]):
        x = block_apply(cfg, lp, x, positions,
                        cache={"k": ck, "v": cv, "pos": 0})
    cache["pos"] = L.device_pos(S, x.device)
    return _logits(cfg, params, x[:, -1:]), cache


def decode_step(cfg: ModelConfig, params: DenseParams, token, cache: Dict):
    """One token per sequence (``token`` [B]) against the cache -> (logits
    [B, vocab], the cache with ``pos`` advanced: a new 0-d tensor where
    ``pos`` is one, never read on the host). The cache's tensors are
    written in place: the returned cache shares them with ``cache``."""
    x = L.embed(params.embed, token[:, None], L.compute_dtype(cfg))
    B = x.shape[0]
    pos = cache["pos"]
    positions = L.step_positions(pos, B, x.device)
    for lp, ck, cv in zip(params.layers, cache["k"], cache["v"]):
        x = block_apply(cfg, lp, x, positions,
                        cache={"k": ck, "v": cv, "pos": pos})
    logits = _logits(cfg, params, x)[:, 0]
    return logits, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}


# ---------------------------------------------------------------------------
# Encoder-decoder (the SeamlessM4T backbone)
# ---------------------------------------------------------------------------


def encode(cfg: ModelConfig, params: EncDecParams, frames):
    """The encoder over frontend frame embeddings [B, S_enc, D] (the audio
    stub's): non-causal dense blocks, then ``enc_ln``."""
    x = frames.to(L.compute_dtype(cfg))
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    for lp in params.enc_layers:
        x = L.remat(cfg, lambda x, lp=lp: block_apply(cfg, lp, x, positions,
                                                      causal=False), x)
    return L.rmsnorm(params.enc_ln, x, cfg.norm_eps)


def _encdec_logits(cfg: ModelConfig, params: EncDecParams, x):
    return L.linear(params.head, L.rmsnorm(params.ln_f, x, cfg.norm_eps))


def encdec_forward(cfg: ModelConfig, params: EncDecParams, tokens, frames,
                   return_hidden: bool = False):
    """Decoder logits [B, S, vocab] over ``tokens``, cross-attending to
    the encoding of ``frames``; with ``return_hidden`` the final hidden
    after ``ln_f`` instead."""
    enc = encode(cfg, params, frames)
    x = L.embed(params.embed, tokens, L.compute_dtype(cfg))
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    for lp in params.layers:
        x = L.remat(cfg, lambda x, lp=lp: block_apply(cfg, lp, x, positions,
                                                      enc=enc), x)
    if return_hidden:
        return L.rmsnorm(params.ln_f, x, cfg.norm_eps)
    return _encdec_logits(cfg, params, x)


def encdec_loss(cfg: ModelConfig, params: EncDecParams, batch: Dict):
    """Mean cross-entropy of the decoder over ``batch`` (``tokens``,
    ``embeds`` the frames, ``labels``, optional ``mask``)."""
    if cfg.chunked_xent:
        h = encdec_forward(cfg, params, batch["tokens"], batch["embeds"],
                           return_hidden=True)
        return L.softmax_xent_chunked(h, params.head.w, batch["labels"],
                                      batch.get("mask"), transpose_table=True)
    logits = encdec_forward(cfg, params, batch["tokens"], batch["embeds"])
    return L.softmax_xent(logits, batch["labels"], batch.get("mask"))


def encdec_prefill(cfg: ModelConfig, params: EncDecParams, tokens,
                   max_len: int = 0, embeds=None):
    """Encode ``embeds`` (the frames), run the prompt through the decoder:
    last-token logits [B, 1, vocab] and a cache of capacity ``max_len``
    (0: the prompt's length) that also carries the encoder's states as
    ``"enc"``."""
    if embeds is None:
        raise ValueError("encdec_prefill: the encoder needs frame embeddings "
                         "(embeds)")
    enc = encode(cfg, params, embeds)
    x = L.embed(params.embed, tokens, L.compute_dtype(cfg))
    B, S, _ = x.shape
    max_len = max_len or S
    if max_len < S:
        raise ValueError(f"prefill: max_len {max_len} < prompt length {S}")
    cache = L.make_cache(cfg, B, max_len, cfg.n_layers, x.dtype, x.device)
    positions = torch.arange(S, device=x.device).expand(B, S)
    for lp, ck, cv in zip(params.layers, cache["k"], cache["v"]):
        x = block_apply(cfg, lp, x, positions,
                        cache={"k": ck, "v": cv, "pos": 0}, enc=enc)
    cache["pos"] = L.device_pos(S, x.device)
    cache["enc"] = enc
    return _encdec_logits(cfg, params, x[:, -1:]), cache


def encdec_decode_step(cfg: ModelConfig, params: EncDecParams, token,
                       cache: Dict):
    """One decoder token per sequence against the cache and its ``"enc"``
    -> (logits [B, vocab], the cache with ``pos`` advanced)."""
    x = L.embed(params.embed, token[:, None], L.compute_dtype(cfg))
    B = x.shape[0]
    pos = cache["pos"]
    enc = cache["enc"]
    positions = L.step_positions(pos, B, x.device)
    for lp, ck, cv in zip(params.layers, cache["k"], cache["v"]):
        x = block_apply(cfg, lp, x, positions,
                        cache={"k": ck, "v": cv, "pos": pos}, enc=enc)
    logits = _encdec_logits(cfg, params, x)[:, 0]
    return logits, {"k": cache["k"], "v": cache["v"], "pos": pos + 1,
                    "enc": enc}


def counters(cfg: ModelConfig) -> Dict[str, int]:
    """The counters a request of this family reports, as they stand:
    ``rope_append_launches``, the rotary-and-append kernel's launches (one
    a cached self-attention layer a prefill and a decode step on the
    card)."""
    return {"rope_append_launches": rope_append.LAUNCHES}
