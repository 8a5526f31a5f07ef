"""The port's sweep step (``repro_torch.kernels.histogram``) against the TPU
kernel it replaces and against the scalar control-plane path.

  * on the CPU the wrapper runs the plain PyTorch version: over a 20-step
    event stream (S=3 configs, 37 apps — ragged against a 16-app tile — and
    48 bins) every one of the nine outputs must equal
    ``repro.kernels.histogram.fused_hybrid_sweep_step_pallas(...,
    interpret=True)`` exactly;
  * the S=1 front, driven event by event, must equal the port's scalar
    ``AppHistogram`` / ``HybridHistogramPolicy`` path after every event;
  * on a CUDA card (test marked ``gpu``, skipped elsewhere) the CUDA kernel
    (float64 time) must be ``torch.equal`` to the plain version on every
    output.
"""
from functools import partial
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core.histogram import AppHistogram, HistogramConfig
from repro_torch.core.policy import HybridConfig, HybridHistogramPolicy
from repro_torch.core.policy_math import HybridStepConfig
from repro_torch.interop import cfg_blocks_from_numpy, step_state_from_numpy
from repro_torch.kernels import histogram as H
from repro_torch.kernels import ops

S, N, N_BINS, STEPS = 3, 37, 48, 20


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


def _cfg_blocks():
    """Three configs sharing 48 allocated bins: different bin widths,
    percentiles, margins and gates."""
    knobs = [dict(bin_minutes=1.0, range_minutes=48.0, head_pct=5.0,
                  tail_pct=99.0, margin=0.1, cv_threshold=2.0,
                  min_samples=5, oob_threshold=0.5),
             dict(bin_minutes=0.5, range_minutes=24.0, head_pct=0.0,
                  tail_pct=100.0, margin=0.2, cv_threshold=0.5,
                  min_samples=1, oob_threshold=0.25),
             dict(bin_minutes=2.0, range_minutes=96.0, head_pct=10.0,
                  tail_pct=95.0, margin=0.0, cv_threshold=1.0,
                  min_samples=10, oob_threshold=0.75)]
    rows_i, rows_f = [], []
    for k in knobs:
        c = HybridStepConfig.from_host(n_bins=N_BINS,
                                       standard_keep=k["range_minutes"], **k)
        rows_i.append([c.n_bins, c.head_numer, c.tail_numer, c.min_samples])
        rows_f.append([c.margin_lo, c.margin_hi, c.bin_f32, c.range_f32,
                       c.cv_threshold, c.oob_threshold, c.standard_keep])
    return np.asarray(rows_i, np.int32), np.asarray(rows_f, np.float32)


def _event_columns(seed):
    """[STEPS, N] float32 event columns on a 1/64-minute grid: in-bounds,
    out-of-bounds and bin-edge gaps, apps that start late and stop early
    (+inf = no event)."""
    rng = np.random.default_rng(seed)
    gaps = np.where(rng.random((STEPS, N)) < 0.6,
                    rng.integers(0, 48 * 64, (STEPS, N)) / 64.0,
                    rng.integers(0, 200, (STEPS, N)).astype(np.float64))
    t = np.cumsum(gaps, axis=0)
    start = rng.integers(0, 5, N)
    stop = rng.integers(8, STEPS + 1, N)
    step = np.arange(STEPS)[:, None]
    t[(step < start) | (step >= stop)] = np.inf
    return t.astype(np.float32)


def _init_state(cfg_f32):
    return dict(prev_t=np.full((S, N), -np.inf, np.float32),
                cum=np.zeros((S, N, N_BINS), np.int32),
                oob=np.zeros((S, N), np.int32),
                cv_sum=np.zeros((S, N), np.float32),
                cv_sum_sq=np.zeros((S, N), np.float32),
                prewarm=np.zeros((S, N), np.float32),
                unload_at=np.repeat(cfg_f32[:, 6:7], N, axis=1),
                cold=np.zeros((S, N), np.int32),
                waste=np.zeros((S, N), np.float32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_step_matches_pallas_stream(ref, seed):
    ci, cf = _cfg_blocks()
    cols = _event_columns(seed)
    state = _init_state(cf)
    got = step_state_from_numpy(**state, device="cpu")
    gci, gcf = cfg_blocks_from_numpy(ci, cf, device="cpu")
    want = tuple(ref.jnp.asarray(v) for v in state.values())
    launches = H.LAUNCHES
    for k, col in enumerate(cols):
        got = H.fused_hybrid_sweep_step(torch.from_numpy(col), *got, gci, gcf)
        want = ref.step(ref.jnp.asarray(col), *want, ref.jnp.asarray(ci),
                        ref.jnp.asarray(cf))
        for name, g, w in zip(state, got, want):
            w = np.asarray(w)
            assert g.numpy().dtype == w.dtype, name
            np.testing.assert_array_equal(g.numpy(), w,
                                          err_msg=f"step {k}: {name}")
    assert H.LAUNCHES == launches         # the CPU path launches nothing
    assert int(got[7].sum()) > 0 and bool((got[5] > 0).any())


def test_plain_step_matches_pallas_random_state(ref):
    """One step from a random (valid) mid-trace state."""
    rng = np.random.default_rng(3)
    ci, cf = _cfg_blocks()
    counts = rng.integers(0, 3, (S, N, N_BINS))
    counts[:, ::5] = 0
    prev = rng.uniform(0, 500, N)
    prev[::7] = -np.inf
    t_now = prev + np.where(rng.random(N) < 0.5, rng.uniform(0, 120, N),
                            rng.integers(0, 48, N).astype(float))
    t_now[::7] = 2.0
    t_now[::6] = np.inf
    pre = np.where(rng.random((S, N)) < 0.5, 0, rng.uniform(0, 20, (S, N)))
    state = dict(prev_t=np.tile(prev, (S, 1)).astype(np.float32),
                 cum=np.cumsum(counts, -1).astype(np.int32),
                 oob=rng.integers(0, 30, (S, N)).astype(np.int32),
                 cv_sum=counts.sum(-1).astype(np.float32),
                 cv_sum_sq=(counts ** 2).sum(-1).astype(np.float32),
                 prewarm=pre.astype(np.float32),
                 unload_at=(pre + rng.uniform(0, 80, (S, N))).astype(
                     np.float32),
                 cold=rng.integers(0, 9, (S, N)).astype(np.int32),
                 waste=rng.uniform(0, 1e3, (S, N)).astype(np.float32))
    t32 = t_now.astype(np.float32)
    got = H.fused_hybrid_sweep_step(
        torch.from_numpy(t32), *step_state_from_numpy(**state, device="cpu"),
        *cfg_blocks_from_numpy(ci, cf, device="cpu"))
    want = ref.step(ref.jnp.asarray(t32),
                    *(ref.jnp.asarray(v) for v in state.values()),
                    ref.jnp.asarray(ci), ref.jnp.asarray(cf))
    for name, g, w in zip(state, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


# --------------------------------------------------------------------------
# S=1 front vs the scalar control-plane path
# --------------------------------------------------------------------------

CFG = HistogramConfig(range_minutes=48.0)
HYB = HybridConfig(histogram=CFG, use_arima=False)
LANES = 5


def _kernel_stream(its, device="cpu", tdt=torch.float32):
    """Drive the S=1 step one event at a time (LANES identical apps) with
    the time layer in ``tdt``; yields (prewarm, keep, total, oob, counts)
    after every event."""
    z = lambda dt: torch.zeros(LANES, dtype=dt, device=device)
    state = (torch.full((LANES,), -np.inf, dtype=tdt, device=device),
             torch.zeros((LANES, CFG.n_bins), dtype=torch.int32,
                         device=device),
             z(torch.int32), z(tdt), z(tdt), z(tdt),
             torch.full((LANES,), HYB.standard_keep_alive, dtype=tdt,
                        device=device),
             z(torch.int32), z(tdt))
    t, out = 0.0, []
    for it in its:
        t += it
        state = ops.fused_hybrid_step(
            torch.full((LANES,), t, dtype=tdt, device=device), *state,
            head_pct=CFG.head_percentile, tail_pct=CFG.tail_percentile,
            margin=CFG.margin, bin_minutes=CFG.bin_minutes,
            range_minutes=CFG.range_minutes, cv_threshold=HYB.cv_threshold,
            min_samples=HYB.min_samples,
            oob_threshold=HYB.oob_fraction_threshold,
            standard_keep=HYB.standard_keep_alive)
        cum = state[1].cpu().numpy()
        pre, ub = state[5].cpu().numpy(), state[6].cpu().numpy()
        assert (cum == cum[:1]).all() and (pre == pre[0]).all()
        out.append((float(pre[0]), float(ub[0]) - float(pre[0]),
                    int(cum[0, -1]), int(state[2][0]),
                    np.diff(np.concatenate([[0], cum[0].astype(np.int64)]))))
    return out


def _scalar_stream(its):
    policy, hist, out = HybridHistogramPolicy(HYB), AppHistogram(CFG), []
    for k, it in enumerate(its):
        w = policy.on_invocation("a", None if k == 0 else float(it))
        if k > 0:
            hist.record(float(it))
        out.append((w.prewarm, w.keep_alive, hist.total, hist.oob,
                    hist.counts.copy()))
    return out


def _quantize(vals):
    # 1/64-minute grid: exact float32 arithmetic for cumulative times < 2^17
    return [max(round(v * 64.0) / 64.0, 0.0) for v in vals]


STREAMS = {
    "in_bounds": lambda rng: _quantize(rng.uniform(0.5, 40.0, 60)),
    "oob_heavy": lambda rng: _quantize(
        np.r_[3.0, 7.0, rng.uniform(49.0, 144.0, 38)]),
    "sub_min_samples": lambda rng: _quantize([4.0, 4.0, 4.0]),
    "bimodal": lambda rng: _quantize([10.0 if i % 2 else 30.0
                                      for i in range(50)]),
    "mixed": lambda rng: _quantize(np.abs(rng.normal(0.0, 48.0, 30))),
}


@pytest.mark.parametrize("tdt", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_s1_front_matches_scalar_path(name, tdt):
    its = STREAMS[name](np.random.default_rng(len(name)))
    got, want = _kernel_stream(its, tdt=tdt), _scalar_stream(its)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g[:4] == w[:4], f"event {k}: {g[:4]} != {w[:4]}"
        np.testing.assert_array_equal(g[4], w[4], err_msg=f"event {k}")
    if name == "bimodal":
        assert got[-1][0] > 0.0            # pre-warming active
    if name == "sub_min_samples":
        assert got[-1][:2] == (0.0, HYB.standard_keep_alive)


# --------------------------------------------------------------------------
# the wrapper
# --------------------------------------------------------------------------


def test_wrapper_rejects_devices_without_a_kernel():
    ci, cf = _cfg_blocks()
    state = step_state_from_numpy(**_init_state(cf), device="cpu")
    meta = [x.to("meta") for x in state]
    with pytest.raises(ValueError, match="no kernel"):
        H.fused_hybrid_sweep_step(torch.zeros(N, device="meta"), *meta,
                                  *(torch.from_numpy(x).to("meta")
                                    for x in (ci, cf)))


def test_launch_arguments_are_checked():
    ci, cf = _cfg_blocks()
    f64 = torch.float64
    args = [x.to(f64) if x.is_floating_point() else x
            for x in step_state_from_numpy(**_init_state(cf), device="cpu")]
    args = [torch.zeros(N, dtype=f64)] + args + [torch.from_numpy(ci),
                                                 torch.from_numpy(cf)]
    bm = torch.from_numpy(cf[:, 2].copy()).to(f64)
    H._check_cuda_args(tuple(args), bm)           # well-formed: no error
    bad = list(args)
    bad[0] = bad[0].float()                       # the kernel's time is f64
    with pytest.raises(ValueError, match="argument 0"):
        H._check_cuda_args(tuple(bad), bm)
    bad = list(args)
    bad[2] = bad[2][:, :, :10].contiguous().to(torch.int64)
    with pytest.raises(ValueError, match="argument 2"):
        H._check_cuda_args(tuple(bad), bm)
    bad = list(args)
    bad[11] = bad[11][:, :5].contiguous()
    with pytest.raises(ValueError, match="argument 11"):
        H._check_cuda_args(tuple(bad), bm)


@pytest.mark.gpu
def test_cuda_kernel_equals_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    ci, cf = _cfg_blocks()
    dev, f64 = torch.device("cuda"), torch.float64
    gci, gcf = cfg_blocks_from_numpy(ci, cf, device=dev)
    state = _init_state(cf)
    kern = [x.to(f64) if x.is_floating_point() else x
            for x in step_state_from_numpy(**state, device=dev)]
    plain = [x.clone() for x in kern]
    before = H.LAUNCHES
    for col in _event_columns(4):
        t = torch.from_numpy(col).to(dev, f64)
        kern = H.fused_hybrid_sweep_step(t, *kern, gci, gcf)
        plain = H.fused_hybrid_sweep_step_plain(t, *plain, gci, gcf)
        for g, w in zip(kern, plain):
            assert torch.equal(g, w)
    assert H.LAUNCHES == before + STEPS
    with pytest.raises(ValueError, match="argument 0"):
        H.fused_hybrid_sweep_step(t.float(), *kern, gci, gcf)
    got = _kernel_stream(STREAMS["bimodal"](None), device=dev, tdt=f64)
    want = _scalar_stream(STREAMS["bimodal"](None))
    for g, w in zip(got, want):
        assert g[:4] == w[:4]
        np.testing.assert_array_equal(g[4], w[4])
