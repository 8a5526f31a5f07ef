"""The port's engines against the golden fixtures and the live reference.

Engines (all on the CPU here): ``scalar`` (float64 oracle), ``fused``
(float64 plain step), ``fused`` with ``app_chunk=7`` (ragged chunks), and
``kernel`` with ``app_chunk=16`` (the kernel engine; on the CPU its step
is the kernel's plain version). The golden traces are rebuilt from
``tests/golden_traces.py`` and handed over through ``repro_torch.interop``.

Cold counts, invocations and final windows must be exact everywhere. Every
engine of the port keeps float64 time, so waste is exact between them;
against the reference's ``"pallas"`` engine (float32 time, which
accumulates waste in float32) it is within rtol 1e-5, atol 1e-3 — the
tolerances of ``tests/test_engine_conformance.py``.
"""
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core import experiment as E
from repro_torch.core.metrics import evaluate, pareto_frontier
from repro_torch.core.policy import HybridConfig, HybridHistogramPolicy
from repro_torch.interop import trace_from_numpy

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "golden")
CPU = dict(device="cpu")
ENGINES = {
    "scalar": ("scalar", dict(CPU), True),
    "fused": ("fused", dict(CPU), True),
    "fused_chunked": ("fused", dict(CPU, app_chunk=7), True),
    "kernel": ("kernel", dict(CPU, app_chunk=16), True),
}
GOLDENS = ("bursty_subms_multiweek", "coarse_twoweek", "synthesized_small")


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.experimental
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                       raising=False)
        import golden_traces
        from repro.core import experiment, metrics
        yield SimpleNamespace(gt=golden_traces, E=experiment, metrics=metrics)


def _port_trace(t):
    """A reference Trace rebuilt in the port through interop."""
    if t.times is not None:
        return trace_from_numpy(t.times, duration_minutes=t.duration_minutes)
    times, counts = t.to_padded()
    return trace_from_numpy(times, counts,
                            duration_minutes=t.duration_minutes)


def _spec(cfg, label=None):
    """The port's HybridSpec of a reference HybridConfig."""
    h = cfg.histogram
    return E.HybridSpec(bin_minutes=h.bin_minutes,
                        range_minutes=h.range_minutes,
                        head_percentile=h.head_percentile,
                        tail_percentile=h.tail_percentile, margin=h.margin,
                        cv_threshold=cfg.cv_threshold,
                        min_samples=cfg.min_samples,
                        oob_fraction_threshold=cfg.oob_fraction_threshold,
                        use_arima=cfg.use_arima, label=label)


def _assert_rows(got, want, waste_exact, err=""):
    for f in ("invocations", "cold", "final_prewarm", "final_keep_alive"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f"{err}: {f}")
    if waste_exact:
        np.testing.assert_array_equal(got.wasted_minutes, want.wasted_minutes,
                                      err_msg=f"{err}: waste")
    else:
        np.testing.assert_allclose(got.wasted_minutes, want.wasted_minutes,
                                   rtol=1e-5, atol=1e-3,
                                   err_msg=f"{err}: waste")


@pytest.fixture(scope="module", params=GOLDENS)
def golden(request, ref):
    name = request.param
    make, cfg = ref.gt.GOLDEN_TRACES[name]
    with open(os.path.join(GOLDEN_DIR, f"{name}.json")) as f:
        want = SimpleNamespace(**{k: np.asarray(v) if isinstance(v, list)
                                  else v for k, v in json.load(f).items()})
    trace = make()
    return name, trace, _port_trace(trace), cfg, want


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_golden(golden, engine):
    name, _, trace, cfg, want = golden
    eng, opts, waste_exact = ENGINES[engine]
    assert trace.n_apps == want.n_apps
    got = E.run(trace, _spec(cfg), engine=eng,
                options=E.EngineOptions(**opts))
    _assert_rows(got, want, waste_exact, f"{engine} vs golden {name}")


def test_engines_match_reference_engines(golden, ref):
    """Port "fused" == reference "fused" bit for bit (waste included); port
    "kernel" == reference "pallas" on everything the float32 engine pins
    (waste within its tolerance)."""
    name, rtrace, trace, cfg, _ = golden
    rspec = ref.E.HybridSpec.from_config(cfg)
    _assert_rows(E.run(trace, _spec(cfg), engine="fused",
                       options=E.EngineOptions(**CPU)),
                 ref.E.run(rtrace, rspec, engine="fused"), True,
                 f"fused on {name}")
    _assert_rows(E.run(trace, _spec(cfg), engine="kernel",
                       options=E.EngineOptions(app_chunk=16, **CPU)),
                 ref.E.run(rtrace, rspec, engine="pallas",
                           options=ref.E.EngineOptions(app_chunk=16)),
                 False, f"kernel vs pallas on {name}")


def _coarse_twoweek(ref):
    return _port_trace(ref.gt.coarse_twoweek()), _spec(ref.gt.CFG48)


def _three_minute_bins(ref):
    return (_port_trace(ref.gt.coarse_twoweek()),
            E.HybridSpec(bin_minutes=3.0, range_minutes=48.0,
                         use_arima=False))


def _uniform_two_weeks(ref):
    # float32 minute stamps over two weeks: a float32 time layer, even
    # rebased per app, rounds some idle times across a bin edge here
    from repro_torch.core.workload_spec import WorkloadSpec
    return (WorkloadSpec.uniform(48, days=14.0, seed=1, max_events=64,
                                 min_events=1).materialize(),
            E.HybridSpec(use_arima=False))


@pytest.mark.parametrize("case", [_coarse_twoweek, _three_minute_bins,
                                  _uniform_two_weeks],
                         ids=lambda f: f.__name__.lstrip("_"))
def test_kernel_engine_equals_fused(ref, case):
    """The kernel engine keeps float64 time like "fused" — no per-chunk
    float32 form — so the two agree bit for bit, waste included, whatever
    the bin width and however long the clock."""
    trace, spec = case(ref)
    _assert_rows(E.run(trace, spec, engine="kernel",
                       options=E.EngineOptions(app_chunk=16, **CPU)),
                 E.run(trace, spec, engine="fused",
                       options=E.EngineOptions(**CPU)),
                 True, "kernel vs fused")


def _mixed_specs(cfg):
    return [E.FixedSpec(10.0), E.NoUnloadSpec(),
            _spec(cfg, "base"),
            _spec(HybridConfig(histogram=cfg.histogram, cv_threshold=0.5,
                               use_arima=False), "cv0.5"),
            E.HybridSpec(range_minutes=48.0, head_percentile=10.0,
                         tail_percentile=95.0, margin=0.2, use_arima=False),
            E.HybridSpec(range_minutes=24.0, min_samples=2,
                         use_arima=False)]


@pytest.mark.parametrize("engine", ["fused", "kernel"])
def test_mixed_sweep_rows(ref, engine):
    """A mixed sweep: every row equals its single-config run() bit for bit,
    and the reference's sweep (fused; pallas for the kernel engine)."""
    rtrace = ref.gt.coarse_twoweek()
    trace = _port_trace(rtrace)
    specs = _mixed_specs(ref.gt.CFG48)
    opts = E.EngineOptions(app_chunk=16, **CPU)
    res = E.sweep(trace, specs, engine=engine, options=opts)
    assert res.engine == engine and len(res) == len(specs)
    for s, spec in enumerate(specs):
        _assert_rows(res.row(s), E.run(trace, spec, engine=engine,
                                       options=opts), True, f"row {s}")
    rspecs = [ref.E.FixedSpec(10.0), ref.E.NoUnloadSpec()] + [
        ref.E.HybridSpec(**{k: v for k, v in vars(sp).items()
                            if k != "label"}) for sp in specs[2:]]
    want = ref.E.sweep(rtrace, rspecs,
                       engine="pallas" if engine == "kernel" else "fused",
                       options=ref.E.EngineOptions(app_chunk=16))
    for s in range(len(specs)):
        _assert_rows(res.row(s), want.row(s), engine == "fused",
                     f"row {s} vs reference")
    got_pts, want_pts = res.points(), want.points()
    for g, w in zip(got_pts, want_pts):
        assert (g.cold_pct_p75, g.cold_pct_p50, g.cold_pct_p90,
                g.always_cold_pct) == (w.cold_pct_p75, w.cold_pct_p50,
                                       w.cold_pct_p90, w.always_cold_pct)
    if engine == "fused":
        key = lambda pts: [(p.cold_pct_p75, p.wasted_memory) for p in pts]
        assert key(pareto_frontier(got_pts)) == \
            key(ref.metrics.pareto_frontier(want_pts))
        assert vars(evaluate("x", res.row(2))) == \
            vars(ref.metrics.evaluate("x", want.row(2)))


def test_trace_axis_grid(ref):
    traces = [_port_trace(ref.gt.coarse_twoweek()),
              _port_trace(ref.gt.synthesized_small())]
    specs = [E.FixedSpec(20.0), E.HybridSpec(range_minutes=48.0,
                                             use_arima=False)]
    grid = E.sweep(traces=traces, specs=specs, engine="fused",
                   options=E.EngineOptions(**CPU))
    assert grid.shape == (2, 2)
    for t, trace in enumerate(traces):
        for s, spec in enumerate(specs):
            _assert_rows(grid.row(t, s), E.run(trace, spec, engine="fused",
                                               options=E.EngineOptions(**CPU)),
                         True, f"cell {t},{s}")


def test_arima_is_not_ported():
    trace = trace_from_numpy([np.asarray([0.0, 5.0])], duration_minutes=10.0)
    with pytest.raises(NotImplementedError, match="Queue A item 7"):
        E.run(trace, E.HybridSpec(), engine="fused",
              options=E.EngineOptions(**CPU))
    with pytest.raises(NotImplementedError, match="Queue A item 7"):
        HybridHistogramPolicy(HybridConfig())


def test_cuda_without_a_card_raises(monkeypatch):
    trace = trace_from_numpy([np.asarray([0.0, 5.0])], duration_minutes=10.0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        E.run(trace, E.HybridSpec(use_arima=False))
    with pytest.raises(RuntimeError, match="cuda"):
        E.run(trace, E.FixedSpec(10.0), engine="kernel",
              options=E.EngineOptions(device="cuda"))


def test_bad_arguments():
    trace = trace_from_numpy([np.asarray([0.0, 5.0])], duration_minutes=10.0)
    with pytest.raises(ValueError, match="unknown engine"):
        E.run(trace, E.FixedSpec(), engine="pallas",
              options=E.EngineOptions(**CPU))
    with pytest.raises(ValueError, match="app_chunk"):
        E.run(trace, E.HybridSpec(use_arima=False), engine="fused",
              options=E.EngineOptions(app_chunk=0, **CPU))
    with pytest.raises(TypeError):
        E.sweep(trace, [object()], options=E.EngineOptions(**CPU))


def test_time_translation_invariance(ref):
    """Shifting every timestamp by a constant (on the trace grid) changes
    no verdict, window or waste — the property the TPU kernel's per-chunk
    rebasing relies on — in both vectorized engines."""
    base = ref.gt.coarse_twoweek(n_apps=16, seed=3)
    shift = 4096.0 + 1.0 / 64.0
    a = _port_trace(base)
    b = trace_from_numpy([t + shift for t in base.times],
                         duration_minutes=base.duration_minutes + shift)
    spec = _spec(ref.gt.CFG48)
    for eng in ("fused", "kernel"):
        opts = E.EngineOptions(include_trailing=False, **CPU)
        _assert_rows(E.run(b, spec, engine=eng, options=opts),
                     E.run(a, spec, engine=eng, options=opts), True, eng)
