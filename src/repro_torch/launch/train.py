"""Training launcher (the port of ``repro/launch/train.py``).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
      --steps 50 --reduced --batch 8 --seq 256 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
      --steps 20 --batch 8 --checkpoint-dir build/ckpt     # on the card
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Callable, Dict

from .. import configs
from ..configs.base import SHAPES
from ..runtime.fault_tolerance import run_with_restarts
from ..training import optimizer as opt
from ..training import train_loop

__all__ = ["run", "main"]


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test-sized config (CPU friendly)")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--fault-at-step", type=int, default=None,
                    help="inject a crash (tests restart)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    return ap


def run(argv=None, log: Callable[[str], None] = print) -> Dict:
    """Train as the command line ``argv`` says; returns the loop's result
    with ``attempts`` (1 unless ``--fault-at-step`` made it restart)."""
    args = _parser().parse_args(argv)
    # deterministic cuBLAS products (train_loop), set before its first call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = configs.reduced(cfg)
    shape = SHAPES[args.shape]
    if args.seq:
        shape = dataclasses.replace(shape, seq_len=args.seq)
    loop = train_loop.LoopConfig(
        steps=args.steps, checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every)
    opt_cfg = opt.OptConfig(lr=args.lr, total_steps=args.steps)
    if args.fault_at_step:
        report = run_with_restarts(cfg, shape, loop, opt_cfg,
                                   batch_override=args.batch,
                                   fault_at_step=args.fault_at_step,
                                   log=log, device=args.device)
        return dict(report.result, attempts=report.attempts)
    res = train_loop.train(cfg, shape, loop, opt_cfg,
                           batch_override=args.batch, log=log,
                           device=args.device)
    return dict(res, attempts=1)


def main(argv=None) -> int:
    res = run(argv)
    done = ("[done]" if res["attempts"] == 1
            else f"[done after {res['attempts']} attempts]")
    print(f"{done} loss {res['first_loss']:.4f} -> {res['final_loss']:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
