"""The port's policy math (``repro_torch.core.policy_math``) against the JAX
reference (``repro.core.policy_math``), helper by helper.

Inputs are made with numpy from fixed seeds and handed to both packages;
every result must be exactly equal (``np.array_equal``, same dtype): the
decision layer is integer/float32 by contract, so there is no tolerance.
The reference is imported inside a module fixture (not at collection) under
the ``jax.experimental.enable_x64`` alias that jax 0.9 needs.
"""
import math
from fractions import Fraction
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core import policy_math as pm

N_BINS = 48


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.experimental
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                       raising=False)
        from repro.core import policy_math as rpm
        yield SimpleNamespace(pm=rpm, jnp=jax.numpy,
                              x64=jax.experimental.enable_x64)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _same(got, want):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _random_cum(rng, shape, n_bins=N_BINS, hi=4):
    counts = rng.integers(0, hi, shape + (n_bins,))
    counts[rng.uniform(size=shape) < 0.2] = 0
    return np.cumsum(counts, axis=-1).astype(np.int32)


def _idle_times(rng, n, n_bins=N_BINS, bin_minutes=1.0):
    """In-bounds, out-of-bounds, exact bin edges, +inf and huge values."""
    it = rng.uniform(0.0, 1.5 * n_bins * bin_minutes, n)
    edges = rng.random(n) < 0.25
    it[edges] = rng.integers(0, n_bins + 2, edges.sum()) * bin_minutes
    it[rng.random(n) < 0.1] = np.inf
    it[rng.random(n) < 0.05] = 3e12
    return it


# --------------------------------------------------------------------------
# constants and host knobs
# --------------------------------------------------------------------------


def test_constants(ref):
    assert pm.PCT_SCALE == ref.pm.PCT_SCALE
    assert pm.MAX_SCALED_COUNT == ref.pm.MAX_SCALED_COUNT


@pytest.mark.parametrize("pct", [0.0, 1.0, 5.0, 10.0, 33.33, 95.0, 99.0,
                                 99.9, 100.0])
def test_pct_numer(ref, pct):
    assert pm.pct_numer(pct) == ref.pm.pct_numer(pct)


@pytest.mark.parametrize("margin", [0.0, 0.1, 0.15, 0.2, 0.3, 1.0 / 3.0])
def test_margin_factors(ref, margin):
    got, want = pm.margin_factors(margin), ref.pm.margin_factors(margin)
    for g, w in zip(got, want):
        assert type(g) is type(w) and g == w


def test_hybrid_step_config_from_host(ref):
    kw = dict(n_bins=48, head_pct=5.0, tail_pct=99.0, margin=0.1,
              bin_minutes=1.0, range_minutes=48.0, cv_threshold=2.0,
              min_samples=5, oob_threshold=0.5, standard_keep=48.0)
    got = pm.HybridStepConfig.from_host(**kw)
    want = ref.pm.HybridStepConfig.from_host(**kw)
    assert got._fields == want._fields
    for g, w in zip(got, want):
        assert type(g) is type(w) and g == w


# --------------------------------------------------------------------------
# verdicts
# --------------------------------------------------------------------------


def test_window_bounds(ref):
    rng = np.random.default_rng(1)
    pre = np.where(rng.random(64) < 0.5, 0.0, rng.uniform(0, 50, 64))
    keep = rng.uniform(0, 300, 64)
    for p, k in zip(pre[:8], keep[:8]):          # scalar fast path
        assert pm.window_bounds(float(p), float(k)) == \
            ref.pm.window_bounds(float(p), float(k))
    for g, w in zip(pm.window_bounds(pre, keep),
                    ref.pm.window_bounds(pre, keep)):
        _same(g, w)
    got = pm.window_bounds(torch.tensor(pre, dtype=torch.float32),
                           torch.tensor(keep, dtype=torch.float32))
    want = ref.pm.window_bounds(ref.jnp.asarray(pre, np.float32),
                                ref.jnp.asarray(keep, np.float32))
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_warm_and_idle_from_bounds(ref, dtype):
    rng = np.random.default_rng(2)
    it = rng.uniform(0, 300, 256).astype(dtype)
    it[::7] = np.inf
    load = np.where(rng.random(256) < 0.4, 0.0,
                    rng.uniform(0, 60, 256)).astype(dtype)
    unload = (load + rng.uniform(0, 200, 256)).astype(dtype)
    it[::5] = load[::5]                            # boundary riders
    it[::11] = unload[::11]
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    t = lambda a: torch.tensor(a, dtype=tdt)
    with ref.x64():
        j = lambda a: ref.jnp.asarray(a, dtype)
        _same(pm.warm_from_bounds(t(it), t(load), t(unload)),
              ref.pm.warm_from_bounds(j(it), j(load), j(unload)))
        _same(pm.idle_from_bounds(t(it), t(load), t(unload)),
              ref.pm.idle_from_bounds(j(it), j(load), j(unload)))
    _same(pm.idle_from_bounds(it, load, unload),
          ref.pm.idle_from_bounds(it, load, unload))
    for a, b, c in zip(it[:16], load[:16], unload[:16]):
        assert pm.idle_from_bounds(float(a), float(b), float(c)) == \
            ref.pm.idle_from_bounds(float(a), float(b), float(c))


# --------------------------------------------------------------------------
# histogram update
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,bin_minutes", [(np.float32, 1.0),
                                               (np.float32, 0.5),
                                               (np.float64, 1.0),
                                               (np.float64, 2.0)])
def test_classify_idle_time(ref, dtype, bin_minutes):
    rng = np.random.default_rng(3)
    it = _idle_times(rng, 512, bin_minutes=bin_minutes).astype(dtype)
    active = rng.random(512) < 0.8
    active[~np.isfinite(it)] = False          # engines never record +inf
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    got = pm.classify_idle_time(torch.tensor(it, dtype=tdt),
                                torch.tensor(active), bin_minutes, N_BINS)
    with ref.x64():
        want = ref.pm.classify_idle_time(ref.jnp.asarray(it, dtype),
                                         ref.jnp.asarray(active),
                                         bin_minutes, N_BINS)
    for g, w in zip(got, want):
        _same(g, w)
    for x in it[np.isfinite(it)][:32]:        # scalar fast path
        assert pm.classify_idle_time(float(x), True, bin_minutes, N_BINS) \
            == ref.pm.classify_idle_time(float(x), True, bin_minutes, N_BINS)


def test_classify_idle_time_per_config_knobs(ref):
    """[S, 1] per-config bin widths and bin counts (the sweep's layout)."""
    rng = np.random.default_rng(4)
    it = _idle_times(rng, 40).astype(np.float32)
    active = np.isfinite(it)
    bm = np.asarray([[1.0], [0.5], [2.0]], np.float32)
    nb = np.asarray([[48], [30], [48]], np.int32)
    got = pm.classify_idle_time(torch.tensor(it), torch.tensor(active),
                                torch.tensor(bm), torch.tensor(nb))
    want = ref.pm.classify_idle_time(ref.jnp.asarray(it),
                                     ref.jnp.asarray(active),
                                     ref.jnp.asarray(bm), ref.jnp.asarray(nb))
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.parametrize("gather", [True, False])
def test_suffix_add_and_raw_count(ref, gather):
    rng = np.random.default_rng(5)
    cum = _random_cum(rng, (3, 37))
    safe = rng.integers(0, N_BINS, (3, 37)).astype(np.int32)
    inb = rng.random((3, 37)) < 0.7
    tc = torch.tensor(cum)
    _same(pm.raw_count_at(tc, torch.tensor(safe), gather=gather),
          ref.pm.raw_count_at(ref.jnp.asarray(cum), ref.jnp.asarray(safe),
                              gather=gather))
    want = ref.pm.suffix_add(ref.jnp.asarray(cum), ref.jnp.asarray(safe),
                             ref.jnp.asarray(inb))
    _same(pm.suffix_add(tc, torch.tensor(safe), torch.tensor(inb)), want)
    np.testing.assert_array_equal(tc.numpy(), cum)   # functional form
    pm.suffix_add_(tc, torch.tensor(safe), torch.tensor(inb))
    _same(tc, want)                                   # in-place form


def test_welford_update(ref):
    rng = np.random.default_rng(6)
    cvs = rng.integers(0, 500, 64).astype(np.float32)
    cvss = rng.integers(0, 5000, 64).astype(np.float32)
    inb = rng.random(64) < 0.6
    old = rng.integers(0, 40, 64).astype(np.int32)
    got = pm.welford_update(torch.tensor(cvs), torch.tensor(cvss),
                            torch.tensor(inb), torch.tensor(old))
    want = ref.pm.welford_update(ref.jnp.asarray(cvs), ref.jnp.asarray(cvss),
                                 ref.jnp.asarray(inb), ref.jnp.asarray(old))
    for g, w in zip(got, want):
        _same(g, w)
    for g, w in zip(pm.welford_update(cvs, cvss, inb, old),
                    ref.pm.welford_update(cvs, cvss, inb, old)):
        _same(g, w)
    assert pm.welford_update(3.0, 7.0, True, 2) == \
        ref.pm.welford_update(3.0, 7.0, True, 2)


def test_bin_count_cv(ref):
    rng = np.random.default_rng(7)
    counts = rng.integers(0, 6, (128, N_BINS))
    counts[::9] = 0
    counts[::13] = 2                             # uniform histograms: CV 0
    cvs = counts.sum(-1).astype(np.float32)
    cvss = (counts ** 2).sum(-1).astype(np.float32)
    _same(pm.bin_count_cv(torch.tensor(cvs), torch.tensor(cvss), N_BINS),
          ref.pm.bin_count_cv(ref.jnp.asarray(cvs), ref.jnp.asarray(cvss),
                              N_BINS))
    _same(pm.bin_count_cv(cvs, cvss, N_BINS),
          ref.pm.bin_count_cv(cvs, cvss, N_BINS))
    for a, b in zip(cvs[:24], cvss[:24]):
        for dt in (np.float32, np.float64):
            g = pm.bin_count_cv(float(a), float(b), N_BINS, dt)
            w = ref.pm.bin_count_cv(float(a), float(b), N_BINS, dt)
            assert type(g) is type(w) and g == w


# --------------------------------------------------------------------------
# percentile windows
# --------------------------------------------------------------------------


def test_percentile_thresholds(ref):
    rng = np.random.default_rng(8)
    total = rng.integers(0, 3000, (3, 37)).astype(np.int32)
    numer = np.asarray([[500], [9900], [0]], np.int32)
    _same(pm.percentile_threshold_scaled_numer(torch.tensor(total),
                                               torch.tensor(numer)),
          ref.pm.percentile_threshold_scaled_numer(ref.jnp.asarray(total),
                                                   ref.jnp.asarray(numer)))
    _same(pm.percentile_threshold_scaled_numer(torch.tensor(total), 500),
          ref.pm.percentile_threshold_scaled_numer(ref.jnp.asarray(total),
                                                   500))
    _same(pm.percentile_threshold_scaled(total, 99.0),
          ref.pm.percentile_threshold_scaled(total, 99.0))
    for t in (0, 1, 17, 2999):
        assert pm.percentile_threshold_scaled(t, 5.0) == \
            ref.pm.percentile_threshold_scaled(t, 5.0)


@pytest.mark.parametrize("total", [0, 1, 7, 100, 12345, 200_000])
@pytest.mark.parametrize("pct", [0.0, 1.0, 5.0, 50.0, 99.0, 99.5, 100.0])
def test_scaled_threshold_is_exact_ceil(total, pct):
    thr = pm.percentile_threshold_scaled(total, pct)
    exact = max(math.ceil(Fraction(total) * Fraction(pm.pct_numer(pct),
                                                     pm.PCT_SCALE)), 1)
    for cum in (exact - 1, exact, exact + 1):
        assert (cum * pm.PCT_SCALE >= int(thr)) == (cum >= exact)


@pytest.mark.parametrize("gather", [True, False])
def test_first_bin_ge_scaled(ref, gather):
    rng = np.random.default_rng(9)
    cum = _random_cum(rng, (3, 37))
    thr = (rng.integers(0, 150, (3, 37)) * pm.PCT_SCALE
           + rng.integers(0, pm.PCT_SCALE, (3, 37))).astype(np.int32)
    got = pm.first_bin_ge_scaled(torch.tensor(cum), torch.tensor(thr),
                                 gather=gather)
    want = ref.pm.first_bin_ge_scaled(ref.jnp.asarray(cum),
                                      ref.jnp.asarray(thr), gather=gather)
    _same(got, want)
    # both torch forms, the host form and a naive scan agree
    other = pm.first_bin_ge_scaled(torch.tensor(cum), torch.tensor(thr),
                                   gather=not gather)
    host = pm.first_bin_ge_scaled(cum, thr, gather=False)
    need = -(-thr.astype(np.int64) // pm.PCT_SCALE)
    naive = np.where((cum >= need[..., None]).any(-1),
                     (cum >= need[..., None]).argmax(-1), N_BINS)
    np.testing.assert_array_equal(got.numpy(), other.numpy())
    np.testing.assert_array_equal(got.numpy(), host)
    np.testing.assert_array_equal(got.numpy(), naive)
    for row, t in zip(cum[0], thr[0]):         # host 1-D fast path
        assert pm.first_bin_ge_scaled(row, int(t), gather=False) == \
            ref.pm.first_bin_ge_scaled(row, int(t), gather=False)


def test_window_values(ref):
    rng = np.random.default_rng(10)
    head = rng.integers(0, N_BINS + 1, 64).astype(np.int32)
    tail = rng.integers(0, N_BINS + 2, 64).astype(np.int32)
    for margin in (0.0, 0.1, 0.2):
        for g, w in zip(pm.window_values(head, tail, 1.0, 48.0, margin),
                        ref.pm.window_values(head, tail, 1.0, 48.0, margin)):
            _same(g, w)
        for g, w in zip(pm.window_values(torch.tensor(head),
                                         torch.tensor(tail), 0.5, 24.0,
                                         margin),
                        ref.pm.window_values(ref.jnp.asarray(head),
                                             ref.jnp.asarray(tail), 0.5,
                                             24.0, margin)):
            _same(g, w)
    knobs = [np.asarray(v, np.float32)[:, None] for v in
             ([1.0, 0.5, 2.0], [48.0, 24.0, 96.0], [0.9, 0.8, 1.0],
              [1.1, 1.2, 1.0])]
    got = pm.window_values_from_factors(
        torch.tensor(head)[None], torch.tensor(tail)[None],
        *(torch.tensor(k) for k in knobs))
    want = ref.pm.window_values_from_factors(
        ref.jnp.asarray(head)[None], ref.jnp.asarray(tail)[None],
        *(ref.jnp.asarray(k) for k in knobs))
    for g, w in zip(got, want):
        _same(g, w)
    g0, g1 = pm.standard_window_bounds(torch.tensor(knobs[1]))
    w0, w1 = ref.pm.standard_window_bounds(ref.jnp.asarray(knobs[1]))
    assert g0 == w0
    _same(g1, w1)


def test_window_monotonicity():
    """A higher percentile never lands on an earlier bin; the derived
    windows are ordered and stay inside the inflated range."""
    rng = np.random.default_rng(11)
    cum = torch.tensor(_random_cum(rng, (256,)))
    total = cum[:, -1]
    prev = None
    for pct in (0.0, 5.0, 50.0, 95.0, 99.0, 100.0):
        b = pm.first_bin_ge_scaled(
            cum, pm.percentile_threshold_scaled(total, pct), gather=True)
        if prev is not None:
            assert bool((b >= prev).all())
        prev = b
    head = pm.first_bin_ge_scaled(
        cum, pm.percentile_threshold_scaled(total, 5.0), gather=True)
    load, unload = pm.window_values(head, prev + 1, 1.0, 48.0, 0.1)
    assert bool((load >= 0).all()) and bool((load <= unload).all())
    assert bool((unload <= np.float32(48.0 * 1.1) + 1e-4).all())


# --------------------------------------------------------------------------
# gates
# --------------------------------------------------------------------------


def test_gates(ref):
    rng = np.random.default_rng(12)
    counts = rng.integers(0, 5, (3, 40, N_BINS))
    counts[:, ::6] = 0
    total = counts.sum(-1).astype(np.int32)
    oob = rng.integers(0, 60, (3, 40)).astype(np.int32)
    cvs = total.astype(np.float32)
    cvss = (counts ** 2).sum(-1).astype(np.float32)
    ms = np.asarray([[1], [5], [30]], np.int32)
    cvt = np.asarray([[0.5], [1.0], [2.0]], np.float32)
    oobt = np.asarray([[0.25], [0.5], [0.75]], np.float32)
    T, J = torch.tensor, ref.jnp.asarray
    _same(pm.oob_heavy(T(total), T(oob), T(oobt)),
          ref.pm.oob_heavy(J(total), J(oob), J(oobt)))
    _same(pm.use_histogram_gate(T(total), T(oob), T(cvs), T(cvss), N_BINS,
                                T(ms), T(cvt), T(oobt)),
          ref.pm.use_histogram_gate(J(total), J(oob), J(cvs), J(cvss),
                                    N_BINS, J(ms), J(cvt), J(oobt)))
    cv = pm.bin_count_cv(T(cvs), T(cvss), N_BINS)
    _same(pm.use_histogram_gate_from_cv(T(total), T(oob), cv, 5, 1.0, 0.5),
          ref.pm.use_histogram_gate_from_cv(J(total), J(oob), J(cv.numpy()),
                                            5, 1.0, 0.5))
    for t, o, a, b in zip(total[1, :12], oob[1, :12], cvs[1, :12],
                          cvss[1, :12]):
        t, o = int(t), int(o)
        assert pm.oob_heavy(t, o, 0.5) == ref.pm.oob_heavy(t, o, 0.5)
        assert pm.use_histogram_gate(t, o, float(a), float(b), N_BINS, 5,
                                     1.0, 0.5) == \
            ref.pm.use_histogram_gate(t, o, float(a), float(b), N_BINS, 5,
                                      1.0, 0.5)


# --------------------------------------------------------------------------
# the fused step
# --------------------------------------------------------------------------


def _step_inputs(rng, S, n, dtype):
    cum = _random_cum(rng, (S, n))
    counts = np.diff(np.concatenate([np.zeros((S, n, 1), np.int32), cum],
                                    -1), axis=-1)
    prev = rng.uniform(0, 500, n)
    prev[rng.random(n) < 0.15] = -np.inf
    t_now = prev + np.where(rng.random(n) < 0.3,
                            rng.integers(0, 60, n).astype(float),
                            rng.uniform(0, 70, n))
    t_now[~np.isfinite(prev)] = 3.0
    t_now[rng.random(n) < 0.2] = np.inf
    pre = np.where(rng.random((S, n)) < 0.5, 0.0, rng.uniform(0, 20, (S, n)))
    return dict(
        t_now=t_now.astype(dtype),
        prev_t=np.broadcast_to(prev, (S, n)).astype(dtype),
        cum=cum, oob=rng.integers(0, 20, (S, n)).astype(np.int32),
        cv_sum=counts.sum(-1).astype(dtype),
        cv_sum_sq=(counts ** 2).sum(-1).astype(dtype),
        prewarm=pre.astype(dtype),
        unload_at=(pre + rng.uniform(0, 60, (S, n))).astype(dtype),
        cold=rng.integers(0, 9, (S, n)).astype(np.int32),
        waste=rng.uniform(0, 1e3, (S, n)).astype(dtype))


_KNOBS = dict(n_bins=[48, 48, 40], head_numer=[500, 0, 1000],
              tail_numer=[9900, 10000, 9500], margin_lo=[0.9, 0.8, 1.0],
              margin_hi=[1.1, 1.2, 1.0], bin_minutes=[1.0, 0.5, 1.0],
              bin_f32=[1.0, 0.5, 1.0], range_f32=[48.0, 24.0, 40.0],
              cv_threshold=[2.0, 0.5, 1.0], min_samples=[5, 1, 10],
              oob_threshold=[0.5, 0.25, 0.75],
              standard_keep=[48.0, 24.0, 40.0])


def _knobs(make, dtype):
    ints = ("n_bins", "head_numer", "tail_numer", "min_samples")
    out = {}
    for k, v in _KNOBS.items():
        dt = np.int32 if k in ints else (dtype if k == "bin_minutes"
                                         else np.float32)
        if k in ("margin_lo", "margin_hi"):
            v = [np.float32(x) for x in v]
        out[k] = make(np.asarray(v, dt)[:, None])
    return out


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("gather", [True, False])
def test_fused_hybrid_step_math(ref, dtype, gather):
    inp = _step_inputs(np.random.default_rng(13), 3, 37, dtype)
    cfg = pm.HybridStepConfig(**_knobs(torch.tensor, dtype))
    targs = {k: torch.tensor(v) for k, v in inp.items()}
    cum_in = targs["cum"]
    got = pm.fused_hybrid_step_math(**targs, cfg=cfg, gather=gather)
    assert got[1] is cum_in                      # cum is updated in place
    with ref.x64():
        rcfg = ref.pm.HybridStepConfig(**_knobs(ref.jnp.asarray, dtype))
        want = ref.pm.fused_hybrid_step_math(
            **{k: ref.jnp.asarray(v) for k, v in inp.items()}, cfg=rcfg,
            gather=gather)
        want = [np.asarray(w) for w in want]
    for g, w in zip(got, want):
        _same(g, w)


def test_time_translation_invariance():
    """Shifting every timestamp by a constant changes no decision: the
    property per-chunk rebasing relies on (through the scalar oracle)."""
    from repro_torch.core.histogram import HistogramConfig
    from repro_torch.core.policy import HybridConfig, HybridHistogramPolicy
    from repro_torch.core.simulator import simulate_scalar
    from repro_torch.core.workload import Trace

    rng = np.random.default_rng(14)
    cfg = HybridConfig(histogram=HistogramConfig(range_minutes=48.0),
                       use_arima=False)
    for _ in range(5):
        t = np.concatenate([[0.0], np.cumsum(rng.integers(1, 64 * 64, 30)
                                             / 64.0)])
        shift = rng.integers(0, 10_000 * 64) / 64.0
        dur = float(t[-1] + 10.0)
        a = simulate_scalar(Trace(None, [t], dur), HybridHistogramPolicy(cfg))
        b = simulate_scalar(Trace(None, [t + shift], dur + shift),
                            HybridHistogramPolicy(cfg))
        for f in ("cold", "wasted_minutes", "final_prewarm",
                  "final_keep_alive"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
