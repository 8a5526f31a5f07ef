"""Deterministic synthetic data pipeline (the port of
``repro/training/data.py``; pure numpy, so its batches are the
reference's bit for bit).

Batches are a pure function of (seed, step), which is the property fault
tolerance needs: after a restart from step k the pipeline regenerates batch
k+1 bit-identically, with no data-loader state to checkpoint. The batch is
made on the host; the training loop moves it to the device each step.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from ..configs.base import ModelConfig, ShapeConfig

__all__ = ["DataConfig", "batch_at", "batches"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    vocab: int = 32_000
    # Markov-chain-ish synthetic text: token t+1 depends on t (so the LM loss
    # actually goes down during the example runs).
    order_bias: float = 0.7


def batch_at(step: int, cfg: ModelConfig, shape: ShapeConfig,
             dcfg: DataConfig = DataConfig(),
             batch_override: Optional[int] = None) -> Dict[str, np.ndarray]:
    """The (seed, step)-determined global batch as host numpy arrays:
    ``tokens`` and ``labels`` int32 (the labels the tokens shifted by one),
    and for the vision and encoder-decoder frontends ``embeds`` [B,
    frontend_tokens, d_model] f32 (the VLM's text is ``seq_len -
    frontend_tokens`` long)."""
    B = batch_override or shape.global_batch
    S = shape.seq_len
    rng = np.random.default_rng((dcfg.seed << 20) ^ step)
    vocab = min(dcfg.vocab, cfg.vocab)
    if cfg.frontend == "vision":
        s_text = S - cfg.frontend_tokens
        toks = _markov(rng, B, s_text + 1, vocab, dcfg.order_bias)
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
            "embeds": rng.normal(0, 0.02, (B, cfg.frontend_tokens,
                                           cfg.d_model)).astype(np.float32),
        }
    if cfg.family == "encdec":
        toks = _markov(rng, B, S + 1, vocab, dcfg.order_bias)
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
            "embeds": rng.normal(0, 0.02, (B, cfg.frontend_tokens,
                                           cfg.d_model)).astype(np.float32),
        }
    toks = _markov(rng, B, S + 1, vocab, dcfg.order_bias)
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


def _markov(rng, B, S, vocab, bias):
    toks = np.empty((B, S), np.int64)
    toks[:, 0] = rng.integers(0, vocab, B)
    jumps = rng.integers(0, vocab, (B, S))
    stay = rng.uniform(0, 1, (B, S)) < bias
    for t in range(1, S):
        nxt = (toks[:, t - 1] * 7 + 13) % vocab
        toks[:, t] = np.where(stay[:, t], nxt, jumps[:, t])
    return toks


def batches(cfg: ModelConfig, shape: ShapeConfig, start_step: int = 0,
            dcfg: DataConfig = DataConfig(),
            batch_override: Optional[int] = None) -> Iterator[Dict]:
    step = start_step
    while True:
        yield batch_at(step, cfg, shape, dcfg, batch_override)
        step += 1
