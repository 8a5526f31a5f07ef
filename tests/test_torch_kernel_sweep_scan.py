"""The port's sweep scan (``repro_torch.kernels.histogram.
fused_hybrid_sweep_scan``): the step over every event column of a chunk in
one call.

  * on the CPU the wrapper runs the plain scan, which must equal the plain
    step iterated over the columns on all nine outputs (``torch.equal``):
    S in {1, 3}, n_bins in {1, 60, 240, 257}, with +inf padding, first
    events, out-of-bounds idle times and a row that ends at the
    ``MAX_SCALED_COUNT`` edge of the int32 percentile compare;
  * the plain scan must equal the reference's
    ``fused_hybrid_sweep_step_pallas`` (interpret mode) iterated over a
    small float32 stream, exactly;
  * the form chooser at its edges, and the argument checks, which refuse a
    ``cols`` of the wrong shape or dtype before any launch;
  * on a CUDA card (tests marked ``gpu``, skipped elsewhere) the scan kernel
    must equal the step kernel iterated and the plain scan, in each form,
    and its ``consulted`` flag (the forecaster guard held after some event
    column) must equal the plain scan's.
"""
from functools import partial
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core.policy_math import MAX_SCALED_COUNT, HybridStepConfig
from repro_torch.kernels import histogram as H

WIDTH = 12
NAMES = ("prev_t", "cum", "oob", "cv_sum", "cv_sum_sq", "prewarm",
         "unload_at", "cold", "waste")


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.experimental
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                       raising=False)
        from repro.kernels.histogram import fused_hybrid_sweep_step_pallas
        step = jax.jit(partial(fused_hybrid_sweep_step_pallas, tile_apps=16,
                               interpret=True))
        yield SimpleNamespace(step=step, jnp=jax.numpy)


def _cfg_blocks(S, n_bins, rng):
    """S configs over ``n_bins`` allocated bins: bin widths, percentiles,
    margins and gates drawn from the paper's sweep grid."""
    rows_i, rows_f = [], []
    for _ in range(S):
        bm = float(rng.choice([0.5, 1.0, 2.0]))
        head, tail = [(0.0, 100.0), (5.0, 99.0), (10.0, 95.0)][
            rng.integers(3)]
        c = HybridStepConfig.from_host(
            n_bins=n_bins, head_pct=head, tail_pct=tail,
            margin=float(rng.choice([0.0, 0.1, 0.2])), bin_minutes=bm,
            range_minutes=bm * n_bins,
            cv_threshold=float(rng.choice([0.5, 1.0, 2.0])),
            min_samples=int(rng.choice([1, 5])),
            oob_threshold=float(rng.choice([0.25, 0.5])),
            standard_keep=bm * n_bins)
        rows_i.append([c.n_bins, c.head_numer, c.tail_numer, c.min_samples])
        rows_f.append([c.margin_lo, c.margin_hi, c.bin_f32, c.range_f32,
                       c.cv_threshold, c.oob_threshold, c.standard_keep])
    return (torch.tensor(np.asarray(rows_i, np.int32)),
            torch.tensor(np.asarray(rows_f, np.float32)))


def _columns(n, n_bins, rng, width=WIDTH, dtype=np.float64):
    """[width, n] event columns on a 1/64-minute grid: in-bounds,
    out-of-bounds and bin-edge gaps, apps that start late and stop early
    (+inf = no event)."""
    gaps = np.where(rng.random((width, n)) < 0.6,
                    rng.integers(0, 2 * n_bins * 64, (width, n)) / 64.0,
                    rng.integers(0, 4 * n_bins, (width, n)).astype(float))
    t = np.cumsum(gaps, axis=0)
    step = np.arange(width)[:, None]
    start = rng.integers(0, 4, n)
    stop = rng.integers(width // 2, width + 1, n)
    t[(step < start) | (step >= stop)] = np.inf
    return torch.tensor(t.astype(dtype))


def _state(S, n, n_bins, cfg_f32, rng, *, mid_trace, tdt=torch.float64):
    """The simulator's initial carry, or (``mid_trace``) a valid random
    state with nondecreasing cum rows and Welford sums that match them;
    app 0 of config 0 ends the stream exactly at MAX_SCALED_COUNT."""
    if not mid_trace:
        z = lambda dt: torch.zeros((S, n), dtype=dt)
        return [torch.full((S, n), -np.inf, dtype=tdt),
                torch.zeros((S, n, n_bins), dtype=torch.int32),
                z(torch.int32), z(tdt), z(tdt), z(tdt),
                cfg_f32[:, 6:7].to(tdt).repeat(1, n), z(torch.int32),
                z(tdt)]
    counts = rng.integers(0, 3, (S, n, n_bins)).astype(np.int64)
    counts[0, 0] = 0
    counts[0, 0, 0] = MAX_SCALED_COUNT - (WIDTH - 1)
    prev = rng.uniform(0.0, 500.0, n)
    prev[::5] = -np.inf
    pre = np.where(rng.random((S, n)) < 0.5, 0.0,
                   rng.uniform(0.0, 20.0, (S, n)))
    as_t = lambda a, dt: torch.tensor(a, dtype=dt)
    return [as_t(np.tile(prev, (S, 1)), tdt),
            as_t(np.cumsum(counts, -1), torch.int32),
            as_t(rng.integers(0, 9, (S, n)), torch.int32),
            as_t(counts.sum(-1).astype(float), tdt),
            as_t((counts ** 2).sum(-1).astype(float), tdt),
            as_t(pre, tdt), as_t(pre + rng.uniform(0, 80, (S, n)), tdt),
            as_t(rng.integers(0, 9, (S, n)), torch.int32),
            as_t(rng.uniform(0, 1e3, (S, n)), tdt)]


def _edge_columns(cols, n_bins, cfg_f32):
    """App 0 (a first event in column 0: its prev_t is -inf) gets an
    in-bounds event of config 0 in every later column, so that its config-0
    total ends at MAX_SCALED_COUNT exactly."""
    cols = cols.clone()
    bm = float(cfg_f32[0, 2])
    cols[:, 0] = 1000.0 + torch.arange(cols.shape[0], dtype=cols.dtype) * \
        min(bm * (n_bins - 0.5), bm * n_bins / 2 + 0.25)
    return cols


def _iterate(step, cols, state, ci, cf):
    for t_now in cols:
        state = step(t_now, *state, ci, cf)
    return state


@pytest.mark.parametrize("mid_trace", [False, True], ids=["start", "mid"])
@pytest.mark.parametrize("n_bins", [1, 60, 240, 257])
@pytest.mark.parametrize("S", [1, 3])
def test_plain_scan_equals_plain_step_iterated(S, n_bins, mid_trace):
    rng = np.random.default_rng(S * 1000 + n_bins + mid_trace)
    n = 37
    ci, cf = _cfg_blocks(S, n_bins, rng)
    cols = _columns(n, n_bins, rng)
    if mid_trace:
        cols = _edge_columns(cols, n_bins, cf)
    state = _state(S, n, n_bins, cf, rng, mid_trace=mid_trace)
    want = _iterate(H.fused_hybrid_sweep_step_plain, cols,
                    [x.clone() for x in state], ci, cf)
    before = (H.SCAN_LAUNCHES, H.LAUNCHES)
    got = H.fused_hybrid_sweep_scan(cols, *state, ci, cf)
    assert (H.SCAN_LAUNCHES, H.LAUNCHES) == before   # the CPU launches nothing
    assert got[1] is state[1]                        # cum updated in place
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype, name
        assert torch.equal(g, w), name
    assert int(got[7].sum()) > 0
    if mid_trace:
        assert int(got[1][0, 0, -1]) == MAX_SCALED_COUNT


def test_plain_scan_matches_pallas_stream(ref):
    """The plain scan in float32 time against the TPU kernel iterated in
    interpret mode over 16 columns: every output equal at the end."""
    S, n, n_bins = 3, 37, 48
    rng = np.random.default_rng(7)
    ci, cf = _cfg_blocks(S, n_bins, rng)
    cols = _columns(n, n_bins, rng, width=16, dtype=np.float32)
    state = _state(S, n, n_bins, cf, rng, mid_trace=False,
                   tdt=torch.float32)
    want = tuple(ref.jnp.asarray(x.numpy()) for x in state)
    jci, jcf = ref.jnp.asarray(ci.numpy()), ref.jnp.asarray(cf.numpy())
    for col in cols:
        want = ref.step(ref.jnp.asarray(col.numpy()), *want, jci, jcf)
    got = H.fused_hybrid_sweep_scan(cols, *state, ci, cf)
    for name, g, w in zip(NAMES, got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert int(got[7].sum()) > 0 and bool((got[5] > 0).any())


def test_scan_form_edges():
    assert H.scan_form(1) == ("registers", 2)
    assert H.scan_form(60) == ("registers", 2)
    assert H.scan_form(64) == ("registers", 2)
    assert H.scan_form(65) == ("registers", 8)
    assert H.scan_form(240) == ("registers", 8)
    assert H.scan_form(256) == ("registers", 8)
    assert H.scan_form(257) == ("columns", 0)
    assert H.scan_form(2400) == ("columns", 0)
    # bins a lane are powers of two (the kernel picks a register by the
    # bits of the bin index), in increasing order (the first that covers
    # the row is the narrowest)
    assert all(b & (b - 1) == 0 for b in H.SCAN_BINS_PER_LANE)
    assert list(H.SCAN_BINS_PER_LANE) == sorted(H.SCAN_BINS_PER_LANE)
    for bad in (0, -3):
        with pytest.raises(ValueError, match="n_bins"):
            H.scan_form(bad)


def test_scan_refuses_bad_cols_before_any_launch():
    S, n, n_bins = 2, 11, 60
    rng = np.random.default_rng(1)
    ci, cf = _cfg_blocks(S, n_bins, rng)
    state = _state(S, n, n_bins, cf, rng, mid_trace=False)
    cols = _columns(n, n_bins, rng)
    before = H.SCAN_LAUNCHES
    for bad in (cols[:, :n - 1], cols[0], cols[None]):
        with pytest.raises(ValueError, match="cols"):
            H.fused_hybrid_sweep_scan(bad, *state, ci, cf)
    bm = cf[:, 2].double()
    args = (*state, ci, cf)
    H._check_scan_args(cols, args, bm)                   # well-formed
    H._check_scan_args(cols[:0].contiguous(), args, bm)  # no columns
    for bad in (cols.float(), cols.t().contiguous()[:, :n],
                cols.t().contiguous().t()):
        with pytest.raises(ValueError, match="cols"):
            H._check_scan_args(bad, args, bm)
    bad_state = list(args)
    bad_state[1] = bad_state[1].to(torch.int64)          # cum must be int32
    with pytest.raises(ValueError, match="argument 2"):
        H._check_scan_args(cols, tuple(bad_state), bm)
    assert H.SCAN_LAUNCHES == before


def test_wrapper_rejects_devices_without_a_kernel():
    S, n, n_bins = 1, 5, 8
    rng = np.random.default_rng(2)
    ci, cf = _cfg_blocks(S, n_bins, rng)
    state = [x.to("meta") for x in _state(S, n, n_bins, cf, rng,
                                           mid_trace=False)]
    with pytest.raises(ValueError, match="no kernel"):
        H.fused_hybrid_sweep_scan(torch.zeros((3, n), device="meta"),
                                  *state, ci.to("meta"), cf.to("meta"))


# (S, n, n_bins, form): registers with 2 bins a lane (up to 64 bins) and
# with 8 (up to 256), columns past that
CUDA_CASES = [(3, 1000, 240, "registers"), (2, 333, 60, "registers"),
              (1, 77, 1, "registers"), (3, 50, 9, "registers"),
              (1, 101, 128, "registers"), (2, 90, 64, "registers"),
              (2, 90, 65, "registers"), (3, 129, 257, "columns"),
              (2, 200, 2400, "columns")]


@pytest.mark.gpu
def test_cuda_scan_equals_step_iterated_in_each_form():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    for S, n, n_bins, form in CUDA_CASES:
        assert H.scan_form(n_bins)[0] == form
        for mid_trace in (False, True):
            rng = np.random.default_rng(n + n_bins + mid_trace)
            ci, cf = _cfg_blocks(S, n_bins, rng)
            cols = _columns(n, n_bins, rng)
            if mid_trace:
                cols = _edge_columns(cols, n_bins, cf)
            state = _state(S, n, n_bins, cf, rng, mid_trace=mid_trace)
            plain = H.fused_hybrid_sweep_scan(
                cols, *[x.clone() for x in state], ci, cf)
            gci, gcf, gcols = ci.to(dev), cf.to(dev), cols.to(dev)
            step = _iterate(H.fused_hybrid_sweep_step, gcols,
                            [x.to(dev) for x in state], gci, gcf)
            before = dict(H.SCAN_LAUNCHES_BY_FORM)
            scan = H.fused_hybrid_sweep_scan(
                gcols, *[x.to(dev) for x in state], gci, gcf)
            torch.cuda.synchronize()
            assert H.SCAN_LAUNCHES_BY_FORM[form] == before[form] + 1
            for name, g, s, w in zip(NAMES, scan, step, plain):
                assert torch.equal(g, s), (form, n_bins, name)
                assert torch.equal(g.cpu(), w), (form, n_bins, name)
    with pytest.raises(ValueError, match="cols"):
        H.fused_hybrid_sweep_scan(gcols.float(), *[x.to(dev) for x in state],
                                  gci, gcf)


@pytest.mark.gpu
def test_cuda_scan_consulted_flag_equals_plain_in_each_form():
    """The tenth output, bit for bit, in every form and from both the
    simulator's initial carry and a mid-trace state; both flag values
    occur in every form."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    seen = {"registers": set(), "columns": set()}
    for S, n, n_bins, form in CUDA_CASES:
        for mid_trace in (False, True):
            rng = np.random.default_rng(3 * n + n_bins + mid_trace)
            ci, cf = _cfg_blocks(S, n_bins, rng)
            cols = _columns(n, n_bins, rng)
            state = _state(S, n, n_bins, cf, rng, mid_trace=mid_trace)
            plain = H.fused_hybrid_sweep_scan(
                cols, *[x.clone() for x in state], ci, cf)[9]
            got = H.fused_hybrid_sweep_scan(
                cols.to(dev), *[x.to(dev) for x in state], ci.to(dev),
                cf.to(dev))[9]
            torch.cuda.synchronize()
            assert got.dtype == torch.bool and got.shape == (S, n)
            assert torch.equal(got.cpu(), plain), (form, n_bins, mid_trace)
            seen[form].update(plain.unique().tolist())
    assert seen == {"registers": {False, True}, "columns": {False, True}}
