"""The port's fleet policy-update tick (``repro_torch.kernels.histogram.
policy_update``) against the TPU kernel it replaces and the reference's
oracle.

The contract is bit-identity, not a tolerance: all eight outputs (counts,
oob, total, cv_sum, cv_sum_sq, prewarm, keep_alive, use_hist) must be
exactly equal.

  * on the CPU ``ops.policy_update`` runs the plain version; at
    ``tests/test_kernels.py``'s shapes ((napps, nbins) in (64, 48),
    (128, 240), (32, 16)), with negative and out-of-bounds bins and
    inactive rows, and at two CV thresholds (the reference's 2.0, where
    almost no row passes the gate on these random counts, and 0.5, where
    many do), it must equal ``repro.kernels.ops.policy_update`` (the Pallas
    kernel in interpret mode) and ``repro.kernels.ref.policy_update_ref``;
  * a 40-event stream through the tick equals the port's scalar
    ``AppHistogram`` after every event: the port of
    ``tests/test_kernels.py::test_policy_kernel_matches_core_scalar``, held
    exactly (the scalar path's keep-alive is the float64 difference of the
    float32 bounds; the tick's is their float32 difference, the same value
    rounded once);
  * the counts are updated in place;
  * on a CUDA card (test marked ``gpu``, skipped elsewhere) the CUDA kernel
    against the plain version, every output ``torch.equal``.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core import policy_math
from repro_torch.core.histogram import AppHistogram, HistogramConfig
from repro_torch.kernels import histogram as H
from repro_torch.kernels import ops

NAMES = ("counts", "oob", "total", "cv_sum", "cv_sum_sq", "prewarm",
         "keep_alive", "use_hist")


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.experimental
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                       raising=False)
        from repro.kernels import ops as jops
        from repro.kernels import ref as jref
        yield SimpleNamespace(ops=jops, ref=jref, jnp=jax.numpy)


def _state(seed, napps, nbins):
    """Random counts with consistent totals and Welford sums; this tick's
    bins in [-3, nbins + 8) (negative: neither bin nor OOB) and about half
    the rows active."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 5, (napps, nbins)).astype(np.int32)
    counts[rng.uniform(size=napps) < 0.2] = 0              # empty rows
    return (counts, rng.integers(0, 3, napps).astype(np.int32),
            counts.sum(1).astype(np.int32),
            counts.sum(1).astype(np.float32),
            (counts.astype(np.int64) ** 2).sum(1).astype(np.float32),
            rng.integers(-3, nbins + 8, napps).astype(np.int32),
            rng.integers(0, 2, napps).astype(np.int32))


def _port(arrays, **kw):
    return [o.numpy() for o in ops.policy_update(
        *(torch.from_numpy(a.copy()) for a in arrays), **kw)]


@pytest.mark.parametrize("napps,nbins,tile", [(64, 48, 32), (128, 240, 64),
                                              (32, 16, 32)])
@pytest.mark.parametrize("cv_threshold", [2.0, 0.5])
def test_plain_tick_equals_reference(ref, napps, nbins, tile, cv_threshold):
    arrays = _state(napps + nbins, napps, nbins)
    kw = dict(range_minutes=float(nbins), cv_threshold=cv_threshold)
    got = _port(arrays, **kw)
    j = [ref.jnp.asarray(a) for a in arrays]
    pallas = ref.ops.policy_update(*j, tile_apps=tile, **kw)
    oracle = ref.ref.policy_update_ref(*j, **kw)
    for name, g, p, o in zip(NAMES, got, pallas, oracle):
        p, o = np.asarray(p), np.asarray(o)
        assert g.dtype == p.dtype == o.dtype, name
        np.testing.assert_array_equal(g, p, err_msg=f"{name} vs Pallas")
        np.testing.assert_array_equal(g, o, err_msg=f"{name} vs ref")
    assert got[7].any() == (cv_threshold == 0.5)   # both gate branches seen


def test_tick_updates_counts_in_place():
    arrays = [torch.from_numpy(a) for a in _state(7, 16, 24)]
    before = arrays[0].clone()
    out = ops.policy_update(*arrays)
    assert out[0] is arrays[0]
    bins, active = arrays[5], arrays[6] != 0
    hit = active & (bins >= 0) & (bins < 24)
    want = before.clone()
    want[hit, bins[hit].long()] += 1
    assert torch.equal(out[0], want)


def test_tick_stream_equals_scalar_histogram():
    """Eight identical lanes fed 40 idle times (some out of bounds), one
    tick each, against the scalar AppHistogram after every event: counts,
    OOB, total, the gate and both windows exactly equal."""
    cfg = HistogramConfig(range_minutes=48.0)
    nbins, lanes = cfg.n_bins, 8
    its = np.random.default_rng(0).integers(0, 60, 40)
    h = AppHistogram(cfg)
    i32 = torch.int32
    state = (torch.zeros((lanes, nbins), dtype=i32),
             torch.zeros(lanes, dtype=i32), torch.zeros(lanes, dtype=i32),
             torch.zeros(lanes), torch.zeros(lanes))
    for it in its:
        h.record(float(it))
        out = ops.policy_update(*state, torch.full((lanes,), int(it), dtype=i32),
                                torch.ones(lanes, dtype=i32),
                                range_minutes=cfg.range_minutes)
        state = out[:5]
        gate = policy_math.use_histogram_gate(
            h.total, h.oob, h._cv_sum, h._cv_sum_sq, nbins, 5, 2.0, 0.5)
        pw, ka = h.windows() if gate else (0.0, cfg.range_minutes)
        assert np.array_equal(out[0][0].numpy(), h.counts)
        assert int(out[1][0]) == h.oob and int(out[2][0]) == h.total
        assert int(out[7][0]) == int(gate)
        assert out[5][0].item() == np.float32(pw)
        assert out[6][0].item() == np.float32(ka)
        assert all(torch.equal(o, o[:1].expand_as(o)) for o in out)


def test_check_args_rejects_what_the_kernel_does_not_take():
    good = [torch.from_numpy(a) for a in _state(8, 8, 16)]
    H._check_policy_args(good)
    for k, bad in ((0, good[0].T), (0, good[0].long()), (3, good[3].double()),
                   (5, good[5][:4]), (6, good[6].bool()),
                   (0, torch.zeros((8, 0), dtype=torch.int32))):
        args = list(good)
        args[k] = bad
        with pytest.raises(ValueError):
            H._check_policy_args(args)


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda")
    for seed, (napps, nbins) in enumerate(((64, 48), (1000, 240), (37, 16),
                                           (5000, 33))):
        for cv in (2.0, 0.5):
            arrays = _state(seed, napps, nbins)
            kw = dict(range_minutes=float(nbins), cv_threshold=cv)
            mk = lambda: [torch.from_numpy(a.copy()).to(dev) for a in arrays]
            before = H.POLICY_UPDATE_LAUNCHES
            got = H.policy_update(*mk(), **kw)
            want = H.policy_update_plain(*mk(), **kw)
            torch.cuda.synchronize()
            assert H.POLICY_UPDATE_LAUNCHES == before + 1
            for name, g, w in zip(NAMES, got, want):
                assert torch.equal(g, w), (name, napps, nbins, cv)
