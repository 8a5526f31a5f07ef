"""The model interface (the port of ``repro/models/model.py``).

``Model(cfg)`` exposes, for every family of ``configs.ARCHS`` (dense:
Qwen2, SmolLM, DeepSeek, the LLaVA backbone; MoE: OLMoE, Qwen3-MoE;
encoder-decoder: SeamlessM4T; hybrid: RecurrentGemma; SSM: Mamba-2):

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
  * ``n_params()`` — analytic parameter count

Frontend ``embeds`` [B, frontend_tokens, D] (``models.frontend``) are the
VLM backbone's prepended patches and the encoder-decoder's frames, which
it needs (a ``ValueError`` without them); the other families take none.
"""
from __future__ import annotations

from ..configs.base import ModelConfig
from . import mamba2, moe, rglru, transformer

__all__ = ["Model", "build", "n_params", "INIT_SCHEMES"]

#: The draws ``Model.init`` makes: the reference's distributions, and
#: ``"depth_scaled"`` (MoE family only; :func:`moe.depth_scale_`).
INIT_SCHEMES = ("reference", "depth_scaled")

_FAMILIES = {"dense": transformer, "moe": moe, "encdec": transformer,
             "hybrid": rglru, "ssm": mamba2}


def n_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Analytic parameter count (active = top_k experts only for MoE)."""
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

    def n_params(self, active_only: bool = False) -> int:
        return n_params(self.cfg, active_only)


def build(cfg: ModelConfig) -> Model:
    return Model(cfg)
