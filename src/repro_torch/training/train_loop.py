"""Fault-tolerant training loop (the port of
``repro/training/train_loop.py``).

Restart semantics: the loop is a pure function of (checkpoint, data seed).
On startup it restores the latest checkpoint (if any) and resumes from the
recorded step; the deterministic pipeline regenerates exactly the batches
that follow. A preemption signal (or injected fault) between steps loses
at most ``checkpoint_every`` steps of work, and the resumed losses equal
the uninterrupted run's bit for bit: the loop runs under
``torch.use_deterministic_algorithms(True)`` (on the card cuBLAS then
needs ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` set before its first call, which
``launch.train`` does). The final state is saved once: the reference
writes it a second time when the last step is a checkpoint step.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..device import resolve_device
from ..launch.steps import make_train_step
from ..models import build
from . import checkpoint as ckpt
from . import data as data_lib
from . import optimizer as opt

__all__ = ["LoopConfig", "train", "to_device"]


@dataclasses.dataclass
class LoopConfig:
    steps: int = 100
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    keep_last: int = 3
    log_every: int = 10
    seed: int = 0


def to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A host numpy batch as tensors on ``device`` (integer arrays as
    int64 indices)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(v)
        out[k] = (t.long() if not t.is_floating_point() else t).to(device)
    return out


def train(cfg: ModelConfig, shape: ShapeConfig, loop: LoopConfig,
          opt_cfg: opt.OptConfig = opt.OptConfig(),
          batch_override: Optional[int] = None,
          fault_at_step: Optional[int] = None,
          log: Callable[[str], None] = print, device=None) -> Dict:
    """Run (or resume) training on ``device`` (the card unless
    ``device="cpu"``); returns the first and final loss, every step's loss,
    the step it resumed from and each step's host seconds (ending in the
    loss's readback)."""
    dev = resolve_device(device)
    deterministic = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        return _train(cfg, shape, loop, opt_cfg, batch_override,
                      fault_at_step, log, dev)
    finally:
        torch.use_deterministic_algorithms(deterministic, warn_only=warn_only)


def _train(cfg, shape, loop, opt_cfg, batch_override, fault_at_step, log,
           dev) -> Dict:
    model = build(cfg)
    dcfg = data_lib.DataConfig(seed=loop.seed)
    state = opt.init_state(model.init(loop.seed, dev))
    start = 0
    if loop.checkpoint_dir:
        last = ckpt.latest_step(loop.checkpoint_dir)
        if last is not None:
            state = ckpt.restore(loop.checkpoint_dir, last, state)
            start = last
            log(f"[restore] resumed from step {last}")

    step_fn = make_train_step(model, opt_cfg)
    losses, seconds = [], []
    saved = None
    t0 = time.time()
    for step in range(start, loop.steps):
        t_step = time.perf_counter()
        batch = to_device(data_lib.batch_at(step, cfg, shape, dcfg,
                                            batch_override), dev)
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        seconds.append(time.perf_counter() - t_step)
        losses.append(loss)
        if (step + 1) % loop.log_every == 0:
            log(f"step {step + 1:5d} loss {loss:.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} "
                f"({(time.time() - t0) / max(step - start + 1, 1):.2f}s/step)")
        if loop.checkpoint_dir and (step + 1) % loop.checkpoint_every == 0:
            ckpt.save(loop.checkpoint_dir, step + 1, state, loop.keep_last)
            saved = step + 1
        if fault_at_step is not None and step + 1 == fault_at_step:
            raise RuntimeError(f"injected fault at step {step + 1}")
    if loop.checkpoint_dir and saved != loop.steps:
        ckpt.save(loop.checkpoint_dir, loop.steps, state, loop.keep_last)
    return {"final_loss": losses[-1] if losses else float("nan"),
            "first_loss": losses[0] if losses else float("nan"),
            "losses": losses, "resumed_from": start,
            "step_seconds": seconds}
