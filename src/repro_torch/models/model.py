"""The model interface (the port of ``repro/models/model.py``).

``Model(cfg)`` exposes, for the dense (Qwen2, SmolLM), hybrid
(RecurrentGemma) and SSM (Mamba-2) families:

  * ``init(seed, device)``                  — parameter module (fp32)
  * ``forward(params, tokens)``             — full-sequence logits
  * ``prefill(params, tokens, max_len)``    — (last-token logits, state)
  * ``decode_step(params, token, cache)``   — (logits, state)
  * ``n_params()``                          — analytic parameter count

The MoE and encoder-decoder families are not ported yet: ``Model(cfg)``
raises ``NotImplementedError`` naming the ROADMAP item that ports them, and
so do ``forward`` and ``prefill`` given frontend ``embeds`` (the VLM
path). :func:`n_params` is plain arithmetic and covers every family.
"""
from __future__ import annotations

from ..configs.base import ModelConfig
from . import mamba2, rglru, transformer

__all__ = ["Model", "build", "n_params", "FAMILY_NOT_PORTED",
           "EMBEDS_NOT_PORTED"]

FAMILY_NOT_PORTED = (
    "model family {family!r} is not ported to repro_torch yet (ROADMAP "
    "Queue A item 2: the MoE and encoder-decoder families are left); "
    "the dense, hybrid and SSM families are")
EMBEDS_NOT_PORTED = (
    "frontend embeddings (the VLM path of the dense family) are not ported "
    "to repro_torch yet (ROADMAP Queue A item 2: frontend.py)")

_FAMILIES = {"dense": transformer, "hybrid": rglru, "ssm": mamba2}


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
            raise NotImplementedError(
                FAMILY_NOT_PORTED.format(family=cfg.family))
        self.cfg = cfg
        self._m = _FAMILIES[cfg.family]

    def init(self, seed: int = 0, device=None):
        """Random fp32 parameters from ``seed`` on ``device`` (the card
        unless ``device="cpu"``)."""
        return self._m.init(self.cfg, seed, device)

    def forward(self, params, tokens, embeds=None):
        if embeds is not None:
            raise NotImplementedError(EMBEDS_NOT_PORTED)
        return self._m.forward(self.cfg, params, tokens)

    def prefill(self, params, tokens, max_len: int = 0, embeds=None):
        """Last-token logits and the decode state; ``max_len`` is the KV
        cache's capacity for the dense family (0: the prompt's length) and
        is not used by the others, whose state does not grow."""
        if embeds is not None:
            raise NotImplementedError(EMBEDS_NOT_PORTED)
        return self._m.prefill(self.cfg, params, tokens, max_len)

    def decode_step(self, params, token, cache):
        return self._m.decode_step(self.cfg, params, token, cache)

    def n_params(self, active_only: bool = False) -> int:
        return n_params(self.cfg, active_only)


def build(cfg: ModelConfig) -> Model:
    return Model(cfg)
