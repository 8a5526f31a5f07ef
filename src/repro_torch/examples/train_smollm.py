"""End-to-end training with checkpoints and a restart (the port of
``examples/train_smollm.py``).

Trains a SmolLM-family model on the synthetic deterministic pipeline,
checkpoints every 50 steps, and (optionally) injects a mid-run crash to
show a bit-exact restart. The default is a ~10M-parameter reduction;
``--full`` trains the real 135M config.

  PYTHONPATH=src python -m repro_torch.examples.train_smollm --steps 200
  PYTHONPATH=src python -m repro_torch.examples.train_smollm --steps 200 --crash-at 120
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
from typing import Callable, Dict, Optional

from ..configs import SHAPES, get
from ..runtime.fault_tolerance import run_with_restarts
from ..training import optimizer as opt
from ..training.train_loop import LoopConfig, train

__all__ = ["config", "run", "main"]


def config(full: bool = False):
    """SmolLM-135M, or (the default) its ~10M-parameter float32 reduction."""
    cfg = get("smollm-135m")
    if not full:
        cfg = cfg.with_(n_layers=8, d_model=256, n_heads=8, n_kv_heads=4,
                        head_dim=32, d_ff=688, vocab=8192, dtype="float32",
                        remat=False)
    return cfg


def run(steps: int = 200, batch: int = 8, seq: int = 256,
        full: bool = False, crash_at: Optional[int] = None,
        checkpoint_dir: Optional[str] = None, *, device="cuda",
        checkpoint_every: int = 50,
        log: Callable[[str], None] = print) -> Dict:
    """Train as the command line says on ``device``; returns the loop's
    result with ``attempts`` (2 after a crash) and ``checkpoint_dir``.
    ``checkpoint_every`` is the script's 50 steps."""
    # deterministic cuBLAS products (train_loop), set before its first call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cfg = config(full)
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=seq,
                                global_batch=batch)
    ckdir = checkpoint_dir or tempfile.mkdtemp(prefix="smollm_ckpt_")
    loop = LoopConfig(steps=steps, checkpoint_every=checkpoint_every,
                      checkpoint_dir=ckdir, log_every=10)
    opt_cfg = opt.OptConfig(lr=6e-4, warmup_steps=20, total_steps=steps)
    if crash_at:
        report = run_with_restarts(cfg, shape, loop, opt_cfg,
                                   fault_at_step=crash_at, log=log,
                                   device=device)
        res, attempts = report.result, report.attempts
    else:
        res, attempts = train(cfg, shape, loop, opt_cfg, log=log,
                              device=device), 1
    return dict(res, attempts=attempts, checkpoint_dir=ckdir)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--full", action="store_true",
                    help="the real 135M config")
    ap.add_argument("--crash-at", type=int, default=None)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    res = run(args.steps, args.batch, args.seq, args.full, args.crash_at,
              args.checkpoint_dir, device=args.device)
    if args.crash_at:
        print(f"\nsurvived {res['attempts'] - 1} crash(es); "
              f"resumed from step {res['resumed_from']}")
    print(f"loss: {res['first_loss']:.3f} -> {res['final_loss']:.3f} "
          f"(checkpoints in {res['checkpoint_dir']})")


if __name__ == "__main__":
    main()
