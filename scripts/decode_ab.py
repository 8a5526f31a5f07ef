"""Decode milliseconds a step of the port's serving path, for holding two
trees of the port against each other on one card.

Each architecture named runs at full width (random weights from seed 0,
bf16, ``use_kernels``) behind ``ServeEngine.generate``, with the shape of
``chip_smoke.py``'s serve phases: batch 2, a 4,096-token prompt and 16 new
tokens (one prefill and 15 decode steps). One warm-up generation, then
``--reps`` timed ones; each gives the decode milliseconds a step (the
engine's ``last_times["decode_s"]`` over 15). No other work runs in the
process meanwhile.

    python scripts/decode_ab.py --src SRC --label NAME [--reps 7]
        [--arch qwen2-7b recurrentgemma-2b]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported (the
default: this checkout's). Prints the card's ``nvidia-smi`` name and power
limit, then one JSON line per architecture. To compare two trees, run them
alternately, each in its own process, one after another on one card
(A, B, B, A).
"""
import argparse
import json
import os
import statistics
import subprocess
import sys

BATCH, PROMPT, NEW = 2, 4096, 16


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--arch", nargs="+",
                    default=["qwen2-7b", "recurrentgemma-2b"])
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("decode_ab: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.configs import get
    from repro_torch.kernels import build
    from repro_torch.serving import ModelEndpoint, Registry, ServeEngine
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    build.build_all()
    device = torch.device("cuda")
    for arch in args.arch:
        cfg = get(arch).with_(use_kernels=True)
        reg = Registry()
        reg.register(ModelEndpoint(arch, cfg, seed=0, init="reference"))
        engine = ServeEngine(reg, device=device)
        engine.load(arch)
        tokens = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab, (BATCH, PROMPT))).to(device)
        ms, prefill = [], []
        for rep in range(args.reps + 1):
            engine.generate(arch, tokens, max_new=NEW, max_len=PROMPT + NEW)
            if rep:
                ms.append(1e3 * engine.last_times["decode_s"] / (NEW - 1))
                prefill.append(engine.last_times["prefill_s"])
        print(json.dumps({
            "label": args.label, "src": os.path.dirname(
                os.path.dirname(os.path.abspath(repro_torch.__file__))),
            "arch": arch, "batch": BATCH, "prompt": PROMPT, "new": NEW,
            "decode_ms_per_step": ms,
            "decode_ms_per_step_median": statistics.median(ms),
            "prefill_s": prefill, "device": smi}), flush=True)
        engine.unload(arch)
        del engine, reg
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
