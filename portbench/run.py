#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device`` and, traced, ``breakdown``; ``checks`` comes
last, each compared number beside its limit, which the last lines of
standard error repeat. It exits non-zero, printing no result, where the
card is missing, where the program cannot be imported, or where ``jax``,
``jaxlib``, ``flax`` or the JAX package ``repro`` has been loaded.

``--control 1`` also reads the precision controls (``portbench.check``)
and judges the float8 one in the program's place, so that such a run
comes out not correct; the benchmark's own runs never pass it.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: Top-level module names that may not be loaded in a run.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    t_torch = time.perf_counter()
    from portbench import cell as cell_mod

    bench = cell_mod.load_spec(ROOT)
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}
    if args.workload not in chips:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < chips[args.workload]:
        print(f"the cell needs {chips[args.workload]} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 3
    t_cuda = time.perf_counter()
    import repro_torch  # noqa: F401  (fails here in a tree without the port)
    import repro_torch.serving  # noqa: F401
    t_port = time.perf_counter()
    print(f"imports: torch {t_torch - T0:.3f} s, the card "
          f"{t_cuda - t_torch:.3f} s, the port {t_port - t_cuda:.3f} s",
          file=sys.stderr)

    res = cell_mod.run_cell(bench, args.workload, args.seed, args.seconds,
                            bool(args.trace), device="cuda:0", t0=T0,
                            control=bool(args.control))
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 4
    report = res.pop("report")
    res["card"] = power_limit()
    res["checks"] = res.pop("checks")           # the last key
    print(f"card: {res['card']}", file=sys.stderr)
    for line in report:                         # the checks come last
        print(line, file=sys.stderr)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
