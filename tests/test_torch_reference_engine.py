"""The port's ``engine="reference"`` (the reference's pre-sweep float32
engine) against the reference's ``engine="reference"``, on the CPU.

With ``use_arima=False`` the engine is held bit for bit to the reference's
on the golden traces (their own configs) and on every scenario of
``SCENARIOS`` under five configs (the default; a 60-minute range; bins of
2, 1.5 and 0.7 minutes with other ranges, margins and percentiles): cold
counts, invocations and the
final windows exactly, waste within rtol 1e-9. The reference's compiled
float32 program divides by its constant bin count and width through their
float32 reciprocals, reassociates the window factors and contracts the
CV's multiply-subtract into a fused multiply-add; the port spells those
out (``policy_math.folded_*``), and without them the gate flips where a
CV computes to exactly its threshold (``test_gate_boundary_needs_the_
folded_cv``).

It is float32 on purpose: on a 16-app slice of the 20,000-app two-week
trace of ROADMAP Queue C ("PR 12, designed around") float32 rebased time
moves app 3997's waste to 9413.7915 against the float64 engines'
9408.2901, and the port reproduces the reference's float32 value.

With ARIMA on, the engine takes the post-pass apps from the scan's
"consulted" flag (the reference's final-state selection is its fault,
ROADMAP Queue C) and equals the port's scalar oracle on
``synthesized_small``.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core import experiment as E
from repro_torch.core import policy_math as PM
from repro_torch.core.policy import HybridHistogramPolicy
from repro_torch.core.simulator import simulate_scalar
from repro_torch.core.workload_spec import SCENARIOS, WorkloadSpec
from repro_torch.interop import trace_from_numpy

CPU = dict(device="cpu")
GOLDENS = ("bursty_subms_multiweek", "coarse_twoweek", "synthesized_small")
CONFIGS = (
    dict(use_arima=False),
    dict(range_minutes=60.0, use_arima=False),
    dict(bin_minutes=2.0, use_arima=False),
    dict(bin_minutes=1.5, range_minutes=120.0, margin=0.37,
         cv_threshold=1.0, use_arima=False),
    dict(bin_minutes=0.7, range_minutes=100.0, head_percentile=3.0,
         tail_percentile=97.0, use_arima=False),
)
# ROADMAP Queue C (PR 12): the trace and the app where float32 rebased
# time differs from float64
F32_TRACE = dict(n_apps=20_000, days=14.0, seed=1, max_events=64,
                 min_events=1)
F32_ROWS = slice(3990, 4006)
F32_APP = 7                         # app 3997 of the full trace
F32_WASTE, F64_WASTE = 9413.7915, 9408.2901


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The scans' small elementwise operations gain nothing from intra-op
    threads and lose when test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.experimental
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                       raising=False)
        import golden_traces
        from repro.core import experiment, workload, workload_spec
        yield SimpleNamespace(gt=golden_traces, E=experiment, W=workload,
                              WS=workload_spec)


def _port_trace(t):
    """A reference Trace rebuilt in the port through interop."""
    if t.times is not None:
        return trace_from_numpy(t.times, duration_minutes=t.duration_minutes)
    times, counts = t.to_padded()
    return trace_from_numpy(times, counts,
                            duration_minutes=t.duration_minutes)


def _port_spec(cfg):
    h = cfg.histogram
    return E.HybridSpec(bin_minutes=h.bin_minutes,
                        range_minutes=h.range_minutes,
                        head_percentile=h.head_percentile,
                        tail_percentile=h.tail_percentile, margin=h.margin,
                        cv_threshold=cfg.cv_threshold,
                        min_samples=cfg.min_samples,
                        oob_fraction_threshold=cfg.oob_fraction_threshold,
                        use_arima=cfg.use_arima)


def _run(trace, spec, engine="reference"):
    return E.run(trace, spec, engine=engine, options=E.EngineOptions(**CPU))


def _assert_equal(got, want, err):
    for f in ("invocations", "cold", "final_prewarm", "final_keep_alive"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f"{err}: {f}")
    np.testing.assert_allclose(got.wasted_minutes, want.wasted_minutes,
                               rtol=1e-9, err_msg=f"{err}: waste")


@pytest.mark.parametrize("name", GOLDENS)
def test_equals_the_reference_on_goldens(ref, name):
    rtrace = getattr(ref.gt, name)()
    cfg = dataclasses.replace(ref.gt.GOLDEN_TRACES[name][1], use_arima=False)
    want = ref.E.run(rtrace, ref.E.HybridSpec.from_config(cfg),
                     engine="reference")
    got = _run(_port_trace(rtrace), _port_spec(cfg))
    _assert_equal(got, want, name)


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_equals_the_reference_on_scenarios(ref, scenario):
    kw = dict(days=3.0, seed=3, max_events=48)
    ptrace = SCENARIOS[scenario](150, **kw).materialize()
    rtrace = ref.WS.SCENARIOS[scenario](150, **kw).materialize()
    for cfg in CONFIGS:
        want = ref.E.run(rtrace, ref.E.HybridSpec(**cfg), engine="reference")
        got = _run(ptrace, E.HybridSpec(**cfg))
        _assert_equal(got, want, f"{scenario} {cfg}")


def _f32_slice(ref):
    full = WorkloadSpec.uniform(**F32_TRACE).materialize()
    times, counts = full.to_padded()
    sub = (np.ascontiguousarray(times[F32_ROWS]), counts[F32_ROWS].copy())
    dur = full.duration_minutes
    return (trace_from_numpy(*sub, duration_minutes=dur),
            ref.W.Trace(specs=None, times=None, duration_minutes=dur,
                        _padded=sub))


def test_reproduces_the_reference_float32_value(ref):
    """Where float32 rebased time moves a waste off float64, the port gives
    the reference's float32 value, not the float64 one."""
    ptrace, rtrace = _f32_slice(ref)
    spec = E.HybridSpec(use_arima=False)
    got = _run(ptrace, spec)
    want = ref.E.run(rtrace, ref.E.HybridSpec(use_arima=False),
                     engine="reference")
    _assert_equal(got, want, "float32 slice")
    np.testing.assert_array_equal(got.wasted_minutes, want.wasted_minutes)
    f64 = _run(ptrace, spec, engine="fused")
    assert round(float(got.wasted_minutes[F32_APP]), 4) == F32_WASTE
    assert round(float(f64.wasted_minutes[F32_APP]), 4) == F64_WASTE
    np.testing.assert_array_equal(got.cold, f64.cold)


def test_gate_boundary_needs_the_folded_cv(ref):
    """The state of a real app (``azure_like(101, days=2, seed=3)``, app
    42, event 18, 60 bins): CV is exactly 2.0 in true float32 division
    and 1.9999999 as the reference's program computes it, against a
    threshold of 2.0. The folded CV takes the reference's side."""
    s, ss = torch.tensor([12.0]), torch.tensor([12.0])
    assert float(PM.bin_count_cv(s, ss, 60)) == 2.0
    assert float(PM.folded_bin_count_cv(s, ss, 60)) < 2.0
    import jax
    import jax.numpy as jnp
    from repro.core import policy_math as RPM
    want = jax.jit(lambda a, b: RPM.bin_count_cv(a, b, 60))(
        jnp.float32(12.0), jnp.float32(12.0))
    assert float(PM.folded_bin_count_cv(s, ss, 60)) == float(want)


def test_folded_helpers_equal_the_reference_compiled(ref):
    """The folded helpers against the reference's helpers compiled with
    their knobs as constants, on seeded states."""
    import jax
    import jax.numpy as jnp
    from repro.core import policy_math as RPM
    rng = np.random.default_rng(11)
    n = 4096
    for n_bins, bin_minutes, margin in ((60, 1.0, 0.1), (240, 1.5, 0.37),
                                        (143, 0.7, 0.2)):
        cvs = rng.integers(0, 300, n).astype(np.float32)
        cvss = (cvs * rng.integers(1, 40, n)).astype(np.float32)
        want = jax.jit(lambda a, b: RPM.bin_count_cv(a, b, n_bins))(cvs, cvss)
        np.testing.assert_array_equal(
            PM.folded_bin_count_cv(torch.from_numpy(cvs),
                                   torch.from_numpy(cvss), n_bins).numpy(),
            np.asarray(want))
        head = rng.integers(0, n_bins + 1, n).astype(np.int32)
        tail = rng.integers(1, n_bins + 2, n).astype(np.int32)
        want = jax.jit(lambda h, t: RPM.window_values(
            h, t, bin_minutes, n_bins * bin_minutes, margin))(head, tail)
        got = PM.folded_window_values(torch.from_numpy(head),
                                      torch.from_numpy(tail), bin_minutes,
                                      n_bins * bin_minutes, margin)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        it = rng.uniform(-1.0, 1.2 * n_bins * bin_minutes, n) \
            .astype(np.float32)
        it[:64] = (np.arange(64) * np.float32(bin_minutes)).astype(np.float32)
        active = rng.random(n) < 0.9
        want = jax.jit(lambda x, a: RPM.classify_idle_time(
            x, a, bin_minutes, n_bins))(it, active)
        got = PM.folded_idle_bins(torch.from_numpy(it),
                                  torch.from_numpy(active), bin_minutes,
                                  n_bins)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_fixed_and_spes_alias_the_float64_sweep():
    trace = SCENARIOS["bursty"](60, days=2.0, seed=4,
                                max_events=32).materialize()
    specs = [E.FixedSpec(10.0), E.NoUnloadSpec(), E.SpesSpec(),
             E.HybridSpec(use_arima=False), E.HybridSpec(range_minutes=60.0,
                                                         use_arima=False)]
    got = E.sweep(trace, specs, engine="reference",
                  options=E.EngineOptions(**CPU))
    f64 = E.sweep(trace, specs, engine="fused",
                  options=E.EngineOptions(**CPU))
    assert got.engine == "reference"
    for s in (0, 1, 2):
        for f in ("cold", "wasted_minutes", "final_prewarm",
                  "final_keep_alive"):
            np.testing.assert_array_equal(getattr(got, f)[s],
                                          getattr(f64, f)[s])
    for s in (3, 4):     # one config at a time: the single run's rows
        one = _run(trace, specs[s])
        np.testing.assert_array_equal(got.cold[s], one.cold)
        np.testing.assert_array_equal(got.wasted_minutes[s],
                                      one.wasted_minutes)


def test_arima_on_equals_the_scalar_oracle(ref):
    """HybridSpec with use_arima=True on synthesized_small: the forecast
    post-pass over the apps the scan flags (the port's repair of the
    reference's final-state selection) gives the port's scalar oracle."""
    rtrace = ref.gt.synthesized_small()
    rcfg = dataclasses.replace(ref.gt.GOLDEN_TRACES["synthesized_small"][1],
                               use_arima=True)
    spec = _port_spec(rcfg)
    trace = _port_trace(rtrace)
    got = _run(trace, spec)
    oracle = simulate_scalar(trace, HybridHistogramPolicy(spec.to_config(),
                                                          device="cpu"))
    for f in ("invocations", "cold", "final_prewarm", "final_keep_alive"):
        np.testing.assert_array_equal(getattr(got, f), getattr(oracle, f),
                                      err_msg=f)
    # the apps outside the post-pass accumulate their waste in float32:
    # the float32 engines' tolerance of tests/test_engine_conformance.py
    np.testing.assert_allclose(got.wasted_minutes, oracle.wasted_minutes,
                               rtol=1e-5, atol=1e-3)
    no_arima = _run(trace, dataclasses.replace(spec, use_arima=False))
    moved = got.cold != no_arima.cold
    assert moved.any()      # the post-pass ran, and its apps are float64
    np.testing.assert_array_equal(got.wasted_minutes[moved],
                                  oracle.wasted_minutes[moved])


def test_reference_engine_defaults_to_the_card(monkeypatch):
    trace = SCENARIOS["azure_like"](8, days=1.0, seed=1,
                                    max_events=8).materialize()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        E.run(trace, E.HybridSpec(use_arima=False), engine="reference")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_card_equals_the_cpu(cuda):
    """The float32 engine on the card equals itself on the CPU bit for bit
    (every float32 operation its own rounded op; the folded CV's fused
    multiply-add computed in float64)."""
    trace = WorkloadSpec.uniform(2_000, days=14.0, seed=1, max_events=64,
                                 min_events=1).materialize()
    for cfg in CONFIGS:
        spec = E.HybridSpec(**cfg)
        card = E.run(trace, spec, engine="reference",
                     options=E.EngineOptions(device=cuda))
        cpu = _run(trace, spec)
        for f in ("cold", "final_prewarm", "final_keep_alive",
                  "wasted_minutes"):
            np.testing.assert_array_equal(getattr(card, f), getattr(cpu, f),
                                          err_msg=f"{cfg} {f}")
