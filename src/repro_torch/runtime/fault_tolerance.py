"""Fault-tolerance orchestration (the port of
``repro/runtime/fault_tolerance.py``).

Two failure domains:

  * **Training workers** — checkpoint/restart: `run_with_restarts` drives
    the training loop, catching (injected or real) worker failures and
    resuming from the latest durable checkpoint. Deterministic data keyed
    by step (and deterministic kernels, ``train_loop``) make the loss
    trajectory bit-identical to an uninterrupted run once re-executed steps
    are accounted for.

  * **Serving controller** — the warm pool + policy state (histograms,
    learned windows, ARIMA observations) is checkpointed via
    `WarmPool.state_dict()`; a controller restart therefore does NOT reset
    every application to the conservative standard keep-alive.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

from ..configs.base import ModelConfig, ShapeConfig
from ..training import optimizer as opt
from ..training import train_loop

__all__ = ["RestartReport", "run_with_restarts"]


@dataclasses.dataclass
class RestartReport:
    attempts: int
    total_steps_run: int
    result: Dict


def run_with_restarts(cfg: ModelConfig, shape: ShapeConfig,
                      loop: train_loop.LoopConfig,
                      opt_cfg: opt.OptConfig = opt.OptConfig(),
                      batch_override: Optional[int] = None,
                      fault_at_step: Optional[int] = None,
                      max_restarts: int = 3,
                      log: Callable[[str], None] = print,
                      device=None) -> RestartReport:
    """Run training to completion on ``device`` (the card unless
    ``device="cpu"``), restarting on failure.

    fault_at_step injects a crash once (the retry runs clean), emulating a
    preempted/failed node; requires loop.checkpoint_dir for recovery.
    """
    attempts = 0
    injected = fault_at_step
    while True:
        attempts += 1
        try:
            result = train_loop.train(cfg, shape, loop, opt_cfg,
                                      batch_override=batch_override,
                                      fault_at_step=injected, log=log,
                                      device=device)
            return RestartReport(attempts=attempts,
                                 total_steps_run=loop.steps,
                                 result=result)
        except RuntimeError as e:
            log(f"[fault-tolerance] caught failure: {e}; restarting "
                f"(attempt {attempts + 1})")
            injected = None   # the injected fault fires only once
            if attempts > max_restarts:
                raise
