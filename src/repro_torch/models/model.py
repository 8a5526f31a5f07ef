"""The model interface (the port of ``repro/models/model.py``).

``Model(cfg)`` exposes, for every family of ``configs.ARCHS`` (dense:
Qwen2, SmolLM, DeepSeek, the LLaVA backbone; MoE: OLMoE, Qwen3-MoE;
encoder-decoder: SeamlessM4T; hybrid: RecurrentGemma; SSM: Mamba-2) and of
``configs.PORT_ARCHS`` (Nemotron-H: Mamba-2, attention and MoE layers in
one stack):

  * ``init(seed, device, scheme="reference")`` — parameter module (fp32):
    the reference's distributions, or for the MoE family
    ``"depth_scaled"`` (:func:`moe.depth_scale_`)
  * ``loss(params, batch)`` — scalar LM loss (train; MoE: plus the
    router's weighted aux loss)
  * ``forward(params, tokens, embeds=None)`` — full-sequence logits (MoE:
    ``(logits, aux)``, as the reference returns them)
  * ``prefill(params, tokens, max_len, embeds=None)`` — (last-token
    logits, state)
  * ``decode_step(params, token, cache)`` — (logits, state)
  * ``counters()`` — the counters its requests report, as they stand
  * ``frontend(tokens)`` — the reference's frontend stub for a prompt
  * ``n_params()`` — analytic parameter count (the weight matrices and
    tables; no norm scales, biases or the recurrent families' vectors)
  * ``param_count(params)`` — the parameters a module holds, counted
  * ``input_specs(shape)``, ``cache_specs(batch, kv_len)`` — the dry-run's
    stand-ins (:class:`TensorSpec` records, the port's cache layout), and
    ``make_inputs(shape, seed=)`` — concrete random inputs matching them

Frontend ``embeds`` [B, frontend_tokens, D] (``models.frontend``) are the
VLM backbone's prepended patches and the encoder-decoder's frames, which
it needs (a ``ValueError`` without them); the other families take none.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Tuple

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..device import resolve_device
from . import layers as L
from . import mamba2, moe, nemotron_h, rglru, transformer

__all__ = ["Model", "build", "n_params", "INIT_SCHEMES", "TensorSpec"]


class TensorSpec(NamedTuple):
    """Shape and dtype of a tensor the dry-run stands in for (the
    reference's ``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def _as_specs(tree):
    """Every tensor of a (dict / list) tree as a :class:`TensorSpec`."""
    if isinstance(tree, dict):
        return {k: _as_specs(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_specs(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return TensorSpec(tuple(tree.shape), tree.dtype)
    return tree

#: The draws ``Model.init`` makes: the reference's distributions, and
#: ``"depth_scaled"`` (MoE family only; :func:`moe.depth_scale_`).
INIT_SCHEMES = ("reference", "depth_scaled")

_FAMILIES = {"dense": transformer, "moe": moe, "encdec": transformer,
             "hybrid": rglru, "ssm": mamba2, "nemotron_h": nemotron_h}


def n_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Analytic parameter count (active = top_k experts only for MoE; the
    held experts only where a device holds a share of them)."""
    D, V = cfg.d_model, cfg.vocab
    hd = cfg.hd
    attn = D * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) + cfg.n_heads * hd * D
    if cfg.family == "dense":
        per_layer = attn + 3 * D * cfg.d_ff
        total = cfg.n_layers * per_layer + V * D * (
            1 if cfg.tie_embeddings else 2)
    elif cfg.family == "moe":
        e = cfg.top_k if active_only else cfg.n_experts
        per_layer = attn + e * 3 * D * cfg.d_expert + D * cfg.n_experts
        total = cfg.n_layers * per_layer + 2 * V * D
    elif cfg.family == "ssm":
        DI, N, H = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
        per_layer = D * (2 * DI + 2 * N + H) + DI * D
        total = cfg.n_layers * per_layer + V * D
    elif cfg.family == "hybrid":
        DR = cfg.rglru_d_rnn or D
        rec = 2 * D * DR + 2 * DR * DR + DR * D
        mlp = 3 * D * cfg.d_ff
        n_super, n_tail = rglru._structure(cfg)
        total = (n_super * (2 * rec + attn + 3 * mlp) +
                 n_tail * (rec + mlp) + V * D)
    elif cfg.family == "nemotron_h":
        pat = nemotron_h.kinds(cfg)
        DI, H = cfg.d_inner, cfg.n_ssm_heads
        GN = cfg.ssm_groups * cfg.ssm_state
        e = cfg.top_k if active_only else cfg.n_held
        mamba = D * (2 * DI + 2 * GN + H) + DI * D
        # relu² experts: an up and a down matrix each, no gate
        moe_l = (e * 2 * D * cfg.d_expert + D * cfg.n_experts
                 + 2 * D * cfg.d_shared_expert)
        total = (pat.count("M") * mamba + pat.count("*") * attn
                 + pat.count("E") * moe_l + 2 * V * D)
    elif cfg.family == "encdec":
        per_enc = attn + 3 * D * cfg.d_ff
        per_dec = 2 * attn + 3 * D * cfg.d_ff
        total = (cfg.n_encoder_layers * per_enc + cfg.n_layers * per_dec
                 + 2 * V * D)
    else:
        raise ValueError(cfg.family)
    return int(total)


class Model:
    def __init__(self, cfg: ModelConfig):
        if cfg.family not in _FAMILIES:
            raise ValueError(f"unknown family {cfg.family!r}")
        self.cfg = cfg
        self._m = _FAMILIES[cfg.family]

    def init(self, seed: int = 0, device=None, scheme: str = "reference"):
        """Random fp32 parameters from ``seed`` on ``device`` (the card
        unless ``device="cpu"``), drawn as ``scheme`` (``INIT_SCHEMES``)
        says."""
        if scheme not in INIT_SCHEMES:
            raise ValueError(f"unknown init scheme {scheme!r}")
        if scheme == "depth_scaled" and self.cfg.family != "moe":
            raise ValueError(f"the depth_scaled draw is the MoE family's; "
                             f"not {self.cfg.family!r}")
        if self.cfg.family == "encdec":
            return transformer.encdec_init(self.cfg, seed, device)
        params = self._m.init(self.cfg, seed, device)
        if scheme == "depth_scaled":
            moe.depth_scale_(self.cfg, params)
        return params

    def _check_embeds(self, embeds) -> None:
        fam = self.cfg.family
        if fam == "encdec" and embeds is None:
            raise ValueError("the encoder-decoder needs frame embeddings: "
                             "pass embeds [B, frontend_tokens, d_model]")
        if fam not in ("dense", "encdec") and embeds is not None:
            raise ValueError(f"family {fam!r} takes no frontend embeddings")

    def loss(self, params, batch):
        """Scalar loss of ``batch`` (``tokens``, ``labels``, optional
        ``mask``; ``embeds`` for the VLM backbone and the
        encoder-decoder's frames), differentiable in ``params``."""
        cfg = self.cfg
        self._check_embeds(batch.get("embeds"))
        if cfg.family == "encdec":
            return transformer.encdec_loss(cfg, params, batch)
        return self._m.loss_fn(cfg, params, batch)

    def forward(self, params, tokens=None, embeds=None):
        cfg = self.cfg
        self._check_embeds(embeds)
        if cfg.family == "encdec":
            return transformer.encdec_forward(cfg, params, tokens, embeds)
        if cfg.family == "dense":
            return transformer.forward(cfg, params, tokens, embeds)
        return self._m.forward(cfg, params, tokens)

    def prefill(self, params, tokens, max_len: int = 0, embeds=None):
        """Last-token logits and the decode state; ``max_len`` is the KV
        cache's capacity for the attention families (0: the prompt's
        length) and is not used by the others, whose state does not grow."""
        cfg = self.cfg
        self._check_embeds(embeds)
        if cfg.family == "encdec":
            return transformer.encdec_prefill(cfg, params, tokens, max_len,
                                              embeds=embeds)
        if cfg.family == "dense":
            return transformer.prefill(cfg, params, tokens, max_len,
                                       embeds=embeds)
        return self._m.prefill(cfg, params, tokens, max_len)

    def decode_step(self, params, token, cache):
        if self.cfg.family == "encdec":
            return transformer.encdec_decode_step(self.cfg, params, token,
                                                  cache)
        return self._m.decode_step(self.cfg, params, token, cache)

    def counters(self) -> Dict[str, int]:
        """The counters a request of this model reports, as they stand
        (a request reports their differences over it): from the family's
        module, where its layers do that work, ``ssd_launches`` (Mamba-2
        layers), ``held_choices`` (dropless MoE layers) and
        ``expert_gather_launches`` (MoE layers); none for the others. Host
        counts: nothing is read from the device."""
        return self._m.counters(self.cfg)

    def frontend(self, tokens: torch.Tensor):
        """The reference's modality frontend stub for prompts ``tokens``
        [B, S]: zero frame embeddings [B, max(frontend_tokens, 1),
        d_model] (f32, on the tokens' device) for the encoder-decoder's
        encoder; ``None`` for every other family (a VLM backbone serves
        text only)."""
        cfg = self.cfg
        if cfg.family != "encdec":
            return None
        return torch.zeros((tokens.shape[0], max(cfg.frontend_tokens, 1),
                            cfg.d_model), dtype=torch.float32,
                           device=tokens.device)

    def n_params(self, active_only: bool = False) -> int:
        return n_params(self.cfg, active_only)

    def param_count(self, params) -> int:
        """The number of parameters in ``params`` (every element of every
        tensor, as the reference counts the leaves of its pytree): more
        than :meth:`n_params` by the norm scales, biases and other vectors
        that the analytic count leaves out."""
        return int(sum(p.numel() for p in params.parameters()))

    # -- dry-run stand-ins ----------------------------------------------------

    def input_specs(self, shape: ShapeConfig) -> Dict[str, Any]:
        """:class:`TensorSpec` stand-ins for the step this shape runs.

        train/prefill: the full batch. decode: one new token per sequence
        and the cache (:meth:`cache_specs`). Modality frontends are STUBS —
        ``embeds`` are precomputed frame/patch embeddings with the model's
        d_model."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        f32, i32 = torch.float32, torch.int32
        specs: Dict[str, Any] = {}
        if shape.kind in ("train", "prefill"):
            s_text = S - cfg.frontend_tokens if cfg.frontend == "vision" else S
            specs["tokens"] = TensorSpec((B, s_text), i32)
            if cfg.frontend == "vision" or cfg.family == "encdec":
                specs["embeds"] = TensorSpec(
                    (B, cfg.frontend_tokens, cfg.d_model), f32)
            if shape.kind == "train":
                specs["labels"] = TensorSpec((B, s_text), i32)
        else:  # decode: one new token against a cache of length S
            specs["token"] = TensorSpec((B,), i32)
            specs["cache"] = self.cache_specs(B, S)
        return specs

    def cache_specs(self, batch: int, kv_len: int):
        """The decode cache at a KV capacity of ``kv_len``, in the port's
        layout (one entry per layer where the reference stacks them), each
        tensor a :class:`TensorSpec`; ``pos`` 0, as the reference's zero
        stand-in."""
        cfg = self.cfg
        dtype = L.compute_dtype(cfg)
        if cfg.family == "ssm":
            return _as_specs(mamba2.init_state(cfg, batch, dtype, "meta"))
        if cfg.family == "nemotron_h":
            return _as_specs(nemotron_h.init_state(cfg, batch, kv_len, dtype,
                                                   "meta"))
        if cfg.family == "hybrid":
            return _as_specs(rglru.init_cache(cfg, batch, dtype, "meta"))
        kv = TensorSpec((batch, kv_len, cfg.n_kv_heads, cfg.hd), dtype)
        cache = {"k": [kv] * cfg.n_layers, "v": [kv] * cfg.n_layers,
                 "pos": 0}
        if cfg.family == "encdec":
            cache["enc"] = TensorSpec(
                (batch, cfg.frontend_tokens, cfg.d_model), dtype)
        return cache

    def make_inputs(self, shape: ShapeConfig, seed: int = 0,
                    concrete_batch=None, device=None) -> Dict[str, Any]:
        """Concrete random inputs matching :meth:`input_specs` (of
        ``concrete_batch`` sequences when given) on ``device`` (the card
        unless ``"cpu"``), drawn from one ``torch.Generator`` seeded with
        ``seed``: token ids uniform in the vocabulary, embeddings 0.02 x a
        normal, the cache zero."""
        dev = resolve_device(device)
        if concrete_batch is not None:
            shape = dataclasses.replace(shape, global_batch=concrete_batch)
        gen = torch.Generator(device=dev).manual_seed(int(seed))

        def zeros(tree):
            if isinstance(tree, dict):
                return {k: zeros(v) for k, v in tree.items()}
            if isinstance(tree, list):
                return [zeros(v) for v in tree]
            if isinstance(tree, TensorSpec):
                return torch.zeros(tree.shape, dtype=tree.dtype, device=dev)
            return tree

        out = {}
        for name, spec in self.input_specs(shape).items():
            if name == "cache":
                out[name] = zeros(spec)
            elif spec.dtype == torch.int32:
                out[name] = torch.randint(0, self.cfg.vocab, spec.shape,
                                          generator=gen, device=dev,
                                          dtype=torch.int32)
            else:
                out[name] = 0.02 * torch.randn(spec.shape, generator=gen,
                                               device=dev, dtype=spec.dtype)
        return out


def build(cfg: ModelConfig) -> Model:
    return Model(cfg)
