"""Print the figures behind the port's forecast bounds and its Queue C
entry: the port's ARIMA fit against the reference's, and hybrid+ARIMA runs
against the reference's.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/torch_forecast_report.py

Runs on the CPU with both packages (as the tests do): the reference is
imported with ``jax.experimental.enable_x64`` aliased to
``jax.enable_x64`` where that name is gone. Part 1 fits the 256-window
bank of ``tests/test_torch_forecast_conformance.py`` with both packages
and prints, for the port as it is and for two faults (one LM iteration
fewer; each start dropped), the 99th percentiles and maxima of |dAIC| and
relative |dpred| over the valid (window, order) pairs, the share of
selected forecasts beyond 1e-4 and the selected orders changed. Part 2
runs ``HybridSpec(use_arima=True)`` on the reference's three replay seeds
and the three golden traces in both packages and prints, for every app
whose final windows differ, the reference's and the port's values.
"""
import dataclasses
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.join(os.path.dirname(HERE), "src"), HERE]

import jax  # noqa: E402
import jax.experimental  # noqa: E402

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import torch  # noqa: E402

import golden_traces as gt  # noqa: E402
from repro.core import experiment as RE  # noqa: E402
from repro.core.policy import HybridConfig as RefHybridConfig  # noqa: E402
from repro.forecast import fit_arima_grid as ref_fit  # noqa: E402
from repro_torch.core import experiment as E  # noqa: E402
from repro_torch.forecast import arima_batched as A  # noqa: E402
from repro_torch.interop import trace_from_numpy  # noqa: E402
from test_torch_forecast_conformance import (  # noqa: E402
    SELECTED_PRED_TOL, SELECTION_DELTA, _window_bank)


def fit_stats(want, got) -> str:
    both = want.valid & got.valid
    with np.errstate(invalid="ignore"):
        d_aic = np.abs(want.aic - got.aic)[both]
    rel = lambda a, b: np.abs(a - b) / np.maximum(np.abs(a), 1e-6)
    d_pred = rel(want.pred, got.pred)[both]
    has = want.valid.any(1)
    aic_w = np.where(want.valid, want.aic, np.inf)[has]
    sel_w = aic_w.argmin(1)
    sel_g = np.where(got.valid, got.aic, np.inf)[has].argmin(1)
    two = np.sort(aic_w, 1)[:, :2]
    rows = np.arange(len(sel_w))
    d_sel = rel(want.pred[has][rows, sel_w], got.pred[has][rows, sel_w])
    changed = (sel_w != sel_g) & (two[:, 1] - two[:, 0] >= SELECTION_DELTA)
    return (f"valid equal {int((want.valid == got.valid).sum())}/"
            f"{want.valid.size}; |dAIC| p99 {np.percentile(d_aic, 99):.3g} "
            f"max {d_aic.max():.3g}; rel |dpred| p99 "
            f"{np.percentile(d_pred, 99):.3g} max {d_pred.max():.3g}; "
            f"selected beyond {SELECTED_PRED_TOL:g}: "
            f"{np.mean(d_sel > SELECTED_PRED_TOL):.4f} (max "
            f"{d_sel.max():.3g}); orders changed {int(changed.sum())}")


def port_trace(t):
    if t.times is not None:
        return trace_from_numpy(t.times, duration_minutes=t.duration_minutes)
    times, counts = t.to_padded()
    return trace_from_numpy(times, counts,
                            duration_minutes=t.duration_minutes)


def main() -> int:
    torch.set_num_threads(1)
    rows, lens = _window_bank()
    want = ref_fit(rows, lens)
    fit = lambda: A.fit_arima_grid(rows, lens, device="cpu")
    print("fit, port:", fit_stats(want, fit()))
    iters, starts = A._GN_ITERS, A._STARTS
    A._GN_ITERS = iters - 1
    print("fit, one LM iteration fewer:", fit_stats(want, fit()))
    A._GN_ITERS = iters
    for k in range(len(starts)):
        A._STARTS = starts[:k] + starts[k + 1:]
        print(f"fit, start {k} dropped:", fit_stats(want, fit()))
    A._STARTS = starts

    cases = [(f"seed {s}", gt.coarse_twoweek(n_apps=12, seed=s),
              RefHybridConfig(histogram=gt.CFG48.histogram, use_arima=True,
                              cv_threshold=1.9)) for s in (3, 11, 29)]
    cases += [(name, make(), dataclasses.replace(cfg, use_arima=True))
              for name, (make, cfg) in gt.GOLDEN_TRACES.items()]
    print("| case | app | cold (both) | reference | port | rel. | "
          "waste ref / port |")
    total = 0
    for name, rtrace, rcfg in cases:
        spec = RE.HybridSpec.from_config(rcfg)
        ref = RE.run(rtrace, spec, engine="fused")
        got = E.run(port_trace(rtrace), E.HybridSpec(**vars(spec)),
                    engine="fused", options=E.EngineOptions(device="cpu"))
        assert np.array_equal(ref.cold, got.cold), name
        differ = np.nonzero((ref.final_prewarm != got.final_prewarm)
                            | (ref.final_keep_alive
                               != got.final_keep_alive))[0]
        total += len(differ)
        for i in differ:
            rel = abs(ref.final_prewarm[i] - got.final_prewarm[i]) \
                / ref.final_prewarm[i]
            print(f"| {name} | {i} | {ref.cold[i]} | "
                  f"{ref.final_prewarm[i]:.6f} / {ref.final_keep_alive[i]:.6f}"
                  f" | {got.final_prewarm[i]:.6f} / "
                  f"{got.final_keep_alive[i]:.6f} | {rel:.2e} | "
                  f"{ref.wasted_minutes[i]:.3f} / {got.wasted_minutes[i]:.3f}"
                  f" |")
    print(f"apps whose final windows differ: {total} (cold counts equal on "
          f"every app of all {len(cases)} traces)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
