#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc, plain
C interface), holds every kernel against its plain PyTorch version on the
card, replays the hybrid keep-alive policy over a 1M-app, 14-day trace
through ``repro_torch.core.experiment.run(engine="kernel")`` and checks it
against the float64 engine and the scalar oracle, runs the 32-config policy
sweep, and times the kernel beside its bound. Each phase prints one JSON
line; any mismatch raises. The last lines are the kernel table, the card's
name and power limit (``nvidia-smi``), and ``{"ok": true, "device": ...}``.

Exits non-zero without a result where there is no CUDA device or no
``src/repro_torch`` beside this file. Imports nothing of JAX or ``repro``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)
# H100 SXM rate of plain scalar instructions outside the tensor cores: the
# data sheet's 67e12 float32 rate counts a fused multiply-add as two
# operations, and the step's multiplies, compares and adds (mostly int32)
# issue at one per lane per clock, half of that
SCALAR_OPS_PER_S = 33.5e12
SCALE_APPS = 1_000_000
SWEEP_APPS = 100_000


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


# ---------------------------------------------------------------------------
# Kernel parity on random state
# ---------------------------------------------------------------------------


def random_step_inputs(rng, S, n, n_bins, device):
    """A valid random sweep-step state (nondecreasing cum rows, Welford sums
    consistent with the counts) and S random configs, as tensors; the time
    layer in float64."""
    import torch
    from repro_torch.core import policy_math

    counts = rng.integers(0, 3, (S, n, n_bins))
    counts[rng.uniform(size=(S, n)) < 0.2] = 0            # empty histograms
    cum = np.cumsum(counts, axis=-1).astype(np.int32)
    cv_sum = counts.sum(-1).astype(np.float32)
    cv_sum_sq = (counts.astype(np.int64) ** 2).sum(-1).astype(np.float32)
    oob = rng.integers(0, 30, (S, n)).astype(np.int32)

    bins = rng.choice([0.5, 1.0, 2.0], S)
    rows_i, rows_f = [], []
    for s in range(S):
        h, t = [(0.0, 100.0), (5.0, 99.0), (10.0, 95.0), (1.0, 99.9)][
            rng.integers(4)]
        rng_min = float(bins[s] * n_bins)
        c = policy_math.HybridStepConfig.from_host(
            n_bins=n_bins, head_pct=h, tail_pct=t,
            margin=float(rng.choice([0.0, 0.1, 0.2])),
            bin_minutes=float(bins[s]), range_minutes=rng_min,
            cv_threshold=float(rng.choice([0.5, 1.0, 2.0, 4.0])),
            min_samples=int(rng.choice([1, 5, 10])),
            oob_threshold=float(rng.choice([0.25, 0.5, 0.75])),
            standard_keep=rng_min)
        rows_i.append([c.n_bins, c.head_numer, c.tail_numer, c.min_samples])
        rows_f.append([c.margin_lo, c.margin_hi, c.bin_f32, c.range_f32,
                       c.cv_threshold, c.oob_threshold, c.standard_keep])

    prev = rng.uniform(0.0, 5000.0, (S, n))
    prev[rng.uniform(size=(S, n)) < 0.1] = -np.inf         # first events
    # one clock per app: the trace column is shared by the configs
    prev[:] = prev[0]
    gap = np.where(rng.uniform(size=n) < 0.7,
                   rng.uniform(0.0, 1.2 * bins.max() * n_bins, n),
                   rng.integers(0, n_bins, n).astype(np.float64))  # bin edges
    t_now = prev[0] + gap
    t_now[~np.isfinite(prev[0])] = rng.uniform(0.0, 5000.0)
    t_now[rng.uniform(size=n) < 0.25] = np.inf             # no event
    prewarm = np.where(rng.uniform(size=(S, n)) < 0.5, 0.0,
                       rng.uniform(0.0, 60.0, (S, n)))
    unload = prewarm + rng.uniform(0.0, 300.0, (S, n))
    cold = rng.integers(0, 64, (S, n)).astype(np.int32)
    waste = rng.uniform(0.0, 1e4, (S, n))

    as_t = lambda a, dt: torch.tensor(a, dtype=dt, device=device)
    tdt, i32 = torch.float64, torch.int32
    return [as_t(t_now, tdt), as_t(prev, tdt), as_t(cum, i32),
            as_t(oob, i32), as_t(cv_sum, tdt), as_t(cv_sum_sq, tdt),
            as_t(prewarm, tdt), as_t(unload, tdt), as_t(cold, i32),
            as_t(waste, tdt), as_t(np.asarray(rows_i, np.int32), i32),
            as_t(np.asarray(rows_f, np.float32), torch.float32)]


def kernel_parity(rng, device):
    """One kernel step vs the plain version on the same state: every output
    must be torch.equal. Returns the largest absolute difference seen."""
    import torch
    from repro_torch.kernels import histogram as H

    worst = 0.0
    for S, n, n_bins in ((4, 100_003, 240), (32, 4_099, 60)):
        args = random_step_inputs(rng, S, n, n_bins, device)
        plain_args = list(args)
        plain_args[2] = args[2].clone()
        got = H.fused_hybrid_sweep_step(*args)
        want = H.fused_hybrid_sweep_step_plain(*plain_args)
        torch.cuda.synchronize()
        names = ("prev_t", "cum", "oob", "cv_sum", "cv_sum_sq", "prewarm",
                 "unload_at", "cold", "waste")
        for name, g, w in zip(names, got, want):
            if not torch.equal(g, w):
                diff = (g.double() - w.double()).abs()
                raise AssertionError(
                    f"kernel != plain on {name} at S={S} n={n} "
                    f"n_bins={n_bins}: {int((diff > 0).sum())} elements "
                    f"differ, max {float(diff.max())}")
            worst = max(worst, float((g.double() - w.double()).abs().max()))
        emit("kernel_parity", S=S, n=n, n_bins=n_bins, outputs=len(names),
             torch_equal=True)
    return worst


def event_stream_parity(device):
    """The S=1 kernel driven event by event (5 identical apps) against the
    scalar AppHistogram / HybridHistogramPolicy path after every event."""
    import torch
    from repro_torch.core.histogram import AppHistogram, HistogramConfig
    from repro_torch.core.policy import HybridConfig, HybridHistogramPolicy
    from repro_torch.kernels import ops

    cfg = HistogramConfig()
    hyb = HybridConfig(histogram=cfg, use_arima=False)
    rng = np.random.default_rng(11)
    its = [max(round(v * 64.0) / 64.0, 0.0) for v in np.concatenate(
        [rng.uniform(0.5, 40.0, 30), [10.0, 30.0] * 10,
         rng.uniform(250.0, 500.0, 8), rng.integers(0, 240, 12)])]
    lanes, n_bins, f64 = 5, cfg.n_bins, torch.float64
    z = lambda dt: torch.zeros(lanes, dtype=dt, device=device)
    state = (torch.full((lanes,), -np.inf, dtype=f64, device=device),
             torch.zeros((lanes, n_bins), dtype=torch.int32, device=device),
             z(torch.int32), z(f64), z(f64), z(f64),
             torch.full((lanes,), hyb.standard_keep_alive, dtype=f64,
                        device=device),
             z(torch.int32), z(f64))
    policy, hist = HybridHistogramPolicy(hyb), AppHistogram(cfg)
    t = 0.0
    for k, it in enumerate(its):
        t += it
        state = ops.fused_hybrid_step(
            torch.full((lanes,), t, dtype=f64, device=device), *state,
            head_pct=cfg.head_percentile, tail_pct=cfg.tail_percentile,
            margin=cfg.margin, bin_minutes=cfg.bin_minutes,
            range_minutes=cfg.range_minutes, cv_threshold=hyb.cv_threshold,
            min_samples=hyb.min_samples,
            oob_threshold=hyb.oob_fraction_threshold,
            standard_keep=hyb.standard_keep_alive)
        w = policy.on_invocation("a", None if k == 0 else float(it))
        if k > 0:
            hist.record(float(it))
        cum = state[1].cpu().numpy()
        pre, ub = state[5].cpu().numpy(), state[6].cpu().numpy()
        counts = np.diff(np.concatenate([[0], cum[0].astype(np.int64)]))
        ok = (np.array_equal(counts, hist.counts)
              and int(state[2][0]) == hist.oob
              and float(pre[0]) == w.prewarm
              and float(ub[0]) - float(pre[0]) == w.keep_alive
              and (cum == cum[:1]).all() and (pre == pre[0]).all())
        if not ok:
            raise AssertionError(f"S=1 kernel stream != scalar path at "
                                 f"event {k} (it={it})")
    emit("event_stream_parity", events=len(its), n_bins=n_bins, equal=True)


# ---------------------------------------------------------------------------
# The main path at full size
# ---------------------------------------------------------------------------


def app_steps(counts: np.ndarray) -> int:
    """Apps x scan columns summed over the event-count buckets."""
    from repro_torch.core.simulator import _buckets
    times = np.zeros((len(counts), 1), np.float32)
    return int(sum(len(sel) * int(counts[sel].max())
                   for sel, _ in _buckets(times, counts)))


def assert_rows_equal(a, b, what: str) -> None:
    """Every output equal, waste included: every engine keeps float64
    time."""
    for field in ("cold", "invocations", "final_prewarm",
                  "final_keep_alive", "wasted_minutes"):
        if not np.array_equal(getattr(a, field), getattr(b, field)):
            bad = int((getattr(a, field) != getattr(b, field)).sum())
            raise AssertionError(f"{what}: {field} differs in {bad} apps")


def scale_point(device):
    import torch
    from repro_torch.core.experiment import EngineOptions, HybridSpec, run
    from repro_torch.core.policy import HybridConfig, HybridHistogramPolicy
    from repro_torch.core.simulator import simulate_scalar
    from repro_torch.core.workload_spec import WorkloadSpec
    from repro_torch.kernels import histogram as H

    t0 = time.perf_counter()
    trace = WorkloadSpec.uniform(SCALE_APPS, days=14.0, seed=1,
                                 max_events=64, min_events=1).materialize()
    gen_s = time.perf_counter() - t0
    times, counts = trace.to_padded()
    spec = HybridSpec(use_arima=False)
    opts = EngineOptions(app_chunk=SCALE_APPS, device=device)

    torch.cuda.reset_peak_memory_stats()
    H.LAUNCHES = 0                       # count the main path's launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = run(trace, spec, engine="kernel", options=opts)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = H.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    if launches <= 0:
        raise AssertionError("the kernel engine launched no kernel")

    t0 = time.perf_counter()
    fused = run(trace, spec, engine="fused", options=opts)
    fused_s = time.perf_counter() - t0
    assert_rows_equal(got, fused, "kernel vs fused (1M apps)")

    rng = np.random.default_rng(5)
    sample = np.sort(rng.choice(SCALE_APPS, 1000, replace=False))
    oracle = simulate_scalar(trace, HybridHistogramPolicy(
        HybridConfig(use_arima=False)), app_indices=sample)
    for field in ("cold", "final_prewarm", "final_keep_alive"):
        if not np.array_equal(getattr(got, field)[sample],
                              getattr(oracle, field)[sample]):
            raise AssertionError(f"kernel vs scalar oracle: {field}")
    # host share: the engine's per-chunk preparation of the one chunk
    # (bucket slice, contiguous copy, pinned staging buffer)
    from repro_torch.core.simulator import _chunked_buckets
    t0 = time.perf_counter()
    for _, sub in _chunked_buckets(times, counts, SCALE_APPS):
        torch.from_numpy(np.ascontiguousarray(sub)).pin_memory()
    prep_s = time.perf_counter() - t0
    steps = app_steps(counts)
    emit("scale_point", n_apps=SCALE_APPS, days=14.0, width=times.shape[1],
         app_steps=steps, invocations=int(counts.sum()),
         trace_gen_seconds=gen_s, seconds=seconds, host_prep_seconds=prep_s,
         app_steps_per_s=steps / seconds, kernel_launches=launches,
         peak_device_bytes=peak, fused_seconds=fused_s,
         cold_p75_pct=got.cold_pct_percentile(75),
         always_cold_fraction=got.always_cold_fraction,
         equal_to_fused=True, equal_to_scalar_on_sample=len(sample))
    return trace, launches, dict(seconds=seconds, app_steps=steps)


def policy_sweep(device):
    from repro_torch.core.experiment import (EngineOptions, FixedSpec,
                                             HybridSpec, NoUnloadSpec, run,
                                             sweep)
    from repro_torch.core.workload_spec import WorkloadSpec

    trace = WorkloadSpec.uniform(SWEEP_APPS, days=14.0, seed=3,
                                 max_events=64, min_events=1).materialize()
    grid = [HybridSpec(range_minutes=60.0, head_percentile=h,
                       tail_percentile=t, cv_threshold=cv, margin=m,
                       use_arima=False)
            for m in (0.10, 0.20) for cv in (0.5, 1.0, 2.0, 4.0)
            for (h, t) in ((0.0, 100.0), (5.0, 99.0), (10.0, 95.0),
                           (15.0, 90.0))]
    specs = grid + [FixedSpec(10.0), NoUnloadSpec()]
    opts = EngineOptions(device=device)
    t0 = time.perf_counter()
    res = sweep(trace, specs, engine="kernel", options=opts)
    seconds = time.perf_counter() - t0
    fused = sweep(trace, specs, engine="fused", options=opts)
    for s in range(len(specs)):
        assert_rows_equal(res.row(s), fused.row(s), f"sweep row {s} vs fused")
    singles = (0, 13, 31, 32)
    for s in singles:
        one = run(trace, specs[s], engine="kernel", options=opts)
        assert_rows_equal(res.row(s), one, f"sweep row {s} vs run()")
    emit("sweep", n_apps=SWEEP_APPS, configs=len(specs), seconds=seconds,
         rows_equal_to_fused=len(specs), rows_equal_to_single_run=len(singles))


# ---------------------------------------------------------------------------
# Times
# ---------------------------------------------------------------------------


def time_kernel(host: np.ndarray, device):
    """Kernel and plain-version ms per launch over the event columns of
    ``host`` [n, width] float64 (CUDA events), and the bound those columns
    give."""
    import torch
    from repro_torch.core.policy import HybridConfig
    from repro_torch.core.simulator import _build_cfg_blocks
    from repro_torch.kernels import histogram as H

    cols = torch.from_numpy(np.ascontiguousarray(host.T)).to(device)
    tdt = cols.dtype
    ci, cf = (torch.from_numpy(x).to(device)
              for x in _build_cfg_blocks([HybridConfig(use_arima=False)]))
    S, n, n_bins = 1, cols.shape[1], int(ci[0, 0])

    def fresh():
        z = lambda dt: torch.zeros((S, n), dtype=dt, device=device)
        return (torch.full((S, n), -np.inf, dtype=tdt, device=device),
                torch.zeros((S, n, n_bins), dtype=torch.int32,
                            device=device),
                z(torch.int32), z(tdt), z(tdt), z(tdt),
                cf[:, 6:7].to(tdt).repeat(1, n), z(torch.int32), z(tdt))

    def replay(step):
        step(cols[0], *fresh(), ci, cf)                  # warm-up
        torch.cuda.synchronize()
        state, total_ms = fresh(), 0.0
        for t_now in cols:
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            state = step(t_now, *state, ci, cf)
            b.record()
            b.synchronize()
            total_ms += a.elapsed_time(b)
        return total_ms / cols.shape[0], state

    kernel_ms, k_state = replay(H.fused_hybrid_sweep_step)
    plain_ms, p_state = replay(H.fused_hybrid_sweep_step_plain)
    for g, w in zip(k_state, p_state):
        if not torch.equal(g, w):
            raise AssertionError("timed kernel replay != plain replay")

    # Least bytes each launch must move: the event column, the 8 [S, n]
    # states read and written (6 in the time dtype, 2 int32), the config
    # blocks, the cum rows of apps with an event read, and the suffix of
    # each recorded bin written. Least operations: per row with an event,
    # the two scaled percentile compares over every bin (a multiply and a
    # compare each), one add per suffix bin written, and about 40 scalar
    # operations (verdict, Welford update, windows, gate).
    tb = cols.element_size()
    per_state = S * n * (6 * tb + 2 * 4)
    binm = float(cf[0, 2])
    bytes_total = ops_total = 0.0
    prev = torch.full((n,), -np.inf, dtype=torch.float64, device=device)
    for t_now in cols.double():
        valid = torch.isfinite(t_now)
        rec = valid & torch.isfinite(prev)
        q = torch.floor((t_now - prev) / binm)
        inb = rec & (q < n_bins)
        written = float(torch.where(inb, n_bins - q.clamp(0, n_bins - 1),
                                    0.0).sum())
        active = S * int(valid.sum())
        bytes_total += (tb * n + 2 * per_state + 44 * S
                        + 4 * n_bins * active + 4 * written)
        ops_total += (4 * n_bins + 40) * active + written
        prev = torch.where(valid, t_now, prev)
    launches = cols.shape[0]
    bytes_ms = bytes_total / launches / HBM_BYTES_PER_S * 1e3
    ops_ms = ops_total / launches / SCALAR_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    all_rows_ms = (tb * n + 2 * per_state + 44 * S + 8 * n_bins * S * n) \
        / HBM_BYTES_PER_S * 1e3
    emit("times", shape=[S, n, n_bins],
         launches_timed=launches, kernel_ms_per_launch=kernel_ms,
         plain_ms_per_launch=plain_ms, bound_ms_per_launch=bound_ms,
         bound_by=bound_by, bytes_bound_ms=bytes_ms, ops_bound_ms=ops_ms,
         bound_all_rows_ms=all_rows_ms, library_ms=None,
         library_note="no single PyTorch call computes this step")
    return kernel_ms, plain_ms, bound_ms, bound_by


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a CUDA device only", file=sys.stderr)
        return 2
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    from repro_torch.kernels import build
    device = torch.device("cuda")

    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(), nvidia_smi=smi)
    built = build.build_all()
    emit("build", **{stem: {"seconds": b["seconds"],
                            "ptxas": [ln.strip() for ln in b["log"].splitlines()
                                      if "registers" in ln or "spill" in ln]}
                     for stem, b in built.items()})

    max_err = kernel_parity(np.random.default_rng(0), device)
    event_stream_parity(device)
    trace, launches, e2e = scale_point(device)
    policy_sweep(device)
    # time the kernel on the scale trace's columns, as the main path ran it
    times, counts = trace.to_padded()
    kernel_ms, plain_ms, bound_ms, bound_by = time_kernel(
        times[:, :int(counts.max())].astype(np.float64), device)

    print(json.dumps({"kernels": [{
        "name": "fused_hybrid_sweep_step", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/hybrid_sweep_step.cu",
        "replaces": "src/repro/kernels/histogram.py:245",
        "launches": launches, "max_abs_err": max_err, "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None}]}), flush=True)
    emit("done", seconds=time.perf_counter() - t_start,
         scale_point_seconds=e2e["seconds"])
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
