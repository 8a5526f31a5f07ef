"""Seconds of the port's single-config replay at ``chip_smoke.py``'s scale
point, for holding two trees of the port against each other on one card.

The scale point is ``chip_smoke.py``'s: 1,000,000 apps over 14 days (at
most 64 events an app, seed 1) replayed by the default hybrid policy
(ARIMA off) through ``run(engine="kernel")`` in one chunk. The process
times its first replay (the one ``chip_smoke.py`` reports), then
``--reps`` more; each replay's scan launches are timed with CUDA events.
One further replay (the first one with ``--profile-first``) runs under
``cProfile`` and gives the host's cumulative seconds of the functions that
took the most.

    python scripts/scale_point_ab.py --src SRC --label NAME [--reps 7]
        [--profile-first] [--out FILE]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported (the
default: this checkout's). Prints the card's ``nvidia-smi`` name and power
limit, then one JSON line (also appended to ``--out`` when given). To
compare two trees, run them alternately, each in its own process, one after
another on one card (A, B, B, A).
"""
import argparse
import cProfile
import json
import os
import pstats
import statistics
import subprocess
import sys
import time

SCALE_APPS = 1_000_000
TOP = 25


def _profile(fn):
    prof = cProfile.Profile()
    prof.enable()
    fn()
    prof.disable()
    stats = pstats.Stats(prof).stats
    rows = sorted(((ct, nc, f"{os.path.basename(f)}:{ln}({name})")
                   for (f, ln, name), (_, nc, _, ct, _) in stats.items()),
                  reverse=True)[:TOP]
    return [{"fn": where, "calls": nc, "cum_s": ct} for ct, nc, where in rows]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--profile-first", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        print("scale_point_ab: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.core.experiment import EngineOptions, HybridSpec, run
    from repro_torch.core.workload_spec import WorkloadSpec
    from repro_torch.kernels import build
    from repro_torch.kernels import histogram as H
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    build.build_all()
    build_s = time.perf_counter() - t0
    device = torch.device("cuda")
    trace = WorkloadSpec.uniform(SCALE_APPS, days=14.0, seed=1,
                                 max_events=64, min_events=1).materialize()
    spec = HybridSpec(use_arima=False)
    opts = EngineOptions(app_chunk=SCALE_APPS, device=device)

    events = []
    launch = H._scan_launch

    def timed_launch(*a, **k):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        out = launch(*a, **k)
        end.record()
        events.append((start, end))
        return out
    H._scan_launch = timed_launch

    def replay():
        torch.cuda.synchronize()
        t = time.perf_counter()
        run(trace, spec, engine="kernel", options=opts)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    def scan_ms():
        torch.cuda.synchronize()
        ms = sum(s.elapsed_time(e) for s, e in events)
        events.clear()
        return ms

    profile = None
    if args.profile_first:
        profile = _profile(replay)
        first_s = None
    else:
        first_s = replay()
    first_scan_ms = scan_ms()
    seconds, scans = [], []
    for _ in range(args.reps):
        seconds.append(replay())
        scans.append(scan_ms())
    if profile is None:
        profile = _profile(replay)
        scan_ms()
    line = json.dumps({
        "label": args.label, "src": os.path.dirname(
            os.path.dirname(os.path.abspath(repro_torch.__file__))),
        "n_apps": SCALE_APPS, "build_s": build_s,
        "first_seconds": first_s, "first_scan_ms": first_scan_ms,
        "seconds": seconds, "seconds_median": statistics.median(seconds),
        "scan_ms": scans, "scan_ms_median": statistics.median(scans),
        "profiled": "first" if args.profile_first else "after the reps",
        "profile_top": profile, "device": smi})
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
