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
  * past one 256-bin tile of the kernel (257 and 1,000 bins) and on rows
    whose counts pass ``policy_math.MAX_SCALED_COUNT``, where ``cum *
    PCT_SCALE`` wraps around and is no longer monotone, the plain version
    still equals the Pallas kernel and ``policy_update_ref``;
  * the kernel's form (``_policy_form``: ``vec4`` where every row starts
    16-byte aligned) at its edges;
  * on a CUDA card (tests marked ``gpu``, skipped elsewhere) the CUDA kernel
    against the plain version, every output ``torch.equal``: at 16 to 1,000
    bins, with ``n`` not a multiple of the 32 rows a warp owns, on random
    states whose totals and sums disagree with the counts, and on rows past
    ``MAX_SCALED_COUNT``.
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


def _inconsistent(arrays, seed):
    """The state with totals, OOB counts and Welford sums drawn apart from
    the counts (the kernel must not assume they agree)."""
    rng = np.random.default_rng(seed)
    counts, oob, total, cvs, cvss, bins, active = arrays
    n = counts.shape[0]
    return (counts, rng.integers(0, 50, n).astype(np.int32),
            rng.integers(0, 3 * int(counts.sum(1).max()) + 2, n)
            .astype(np.int32),
            rng.uniform(0, 100, n).astype(np.float32),
            rng.uniform(0, 1e4, n).astype(np.float32), bins, active)


def _past_max_scaled_count(arrays):
    """The state with its first three rows past the int32 edge of the
    scaled compares, totals and sums consistent, each row active on a bin
    in range: row 0 holds 300,000 samples in its last bin (``cum *
    PCT_SCALE`` wraps to a negative value there, so neither percentile is
    found); row 1 holds MAX_SCALED_COUNT samples and gets one more this
    tick; row 2 holds 2 x MAX_SCALED_COUNT spread over every bin, so the
    scaled cumulative counts wrap part way along the row."""
    counts, oob, total, cvs, cvss, bins, active = (a.copy() for a in arrays)
    nbins = counts.shape[1]
    edge = policy_math.MAX_SCALED_COUNT
    counts[:3] = 0
    counts[0, -1] = 300_000
    counts[1, 0], counts[1, -1] = edge // 2, edge - edge // 2
    counts[2] = 2 * edge // nbins
    counts[2, -1] += 2 * edge - int(counts[2].sum())
    total[:3] = counts[:3].sum(1)
    cvs[:3] = total[:3]
    cvss[:3] = (counts[:3].astype(np.int64) ** 2).sum(1)
    bins[:3], active[:3] = (nbins - 1, 0, nbins // 2), 1
    return counts, oob, total, cvs, cvss, bins, active


def _port(arrays, **kw):
    return [o.numpy() for o in ops.policy_update(
        *(torch.from_numpy(a.copy()) for a in arrays), **kw)]


def _assert_equals_reference(ref, arrays, tile, **kw):
    """The port's tick (the plain version on the CPU) against the Pallas
    kernel in interpret mode and ``policy_update_ref``: every output
    exactly equal. Returns the port's outputs."""
    got = _port(arrays, **kw)
    j = [ref.jnp.asarray(a) for a in arrays]
    pallas = ref.ops.policy_update(*j, tile_apps=tile, **kw)
    oracle = ref.ref.policy_update_ref(*j, **kw)
    for name, g, p, o in zip(NAMES, got, pallas, oracle):
        p, o = np.asarray(p), np.asarray(o)
        assert g.dtype == p.dtype == o.dtype, name
        np.testing.assert_array_equal(g, p, err_msg=f"{name} vs Pallas")
        np.testing.assert_array_equal(g, o, err_msg=f"{name} vs ref")
    return got


@pytest.mark.parametrize("napps,nbins,tile", [(64, 48, 32), (128, 240, 64),
                                              (32, 16, 32), (40, 257, 16),
                                              (24, 1000, 8)])
@pytest.mark.parametrize("cv_threshold", [2.0, 0.5])
def test_plain_tick_equals_reference(ref, napps, nbins, tile, cv_threshold):
    arrays = _state(napps + nbins, napps, nbins)
    kw = dict(range_minutes=float(nbins), cv_threshold=cv_threshold)
    got = _assert_equals_reference(ref, arrays, tile, **kw)
    assert got[7].any() == (cv_threshold == 0.5)   # both gate branches seen


@pytest.mark.parametrize("nbins", [16, 240, 257])
def test_plain_tick_equals_reference_past_max_scaled_count(ref, nbins):
    arrays = _past_max_scaled_count(_state(nbins, 24, nbins))
    got = _assert_equals_reference(ref, arrays, 8,
                                   range_minutes=float(nbins))
    assert got[2][1] == policy_math.MAX_SCALED_COUNT + 1
    # row 0's one bin wraps negative: the head percentile is not found
    # (bin n_bins, prewarm n_bins x 0.9), where the unwrapped compare would
    # find it at the last bin (prewarm (n_bins - 1) x 0.9)
    assert got[7][0] == 1 and got[5][0] > 0.89 * nbins
    cum = np.cumsum(got[0][:3].astype(np.int64), axis=1)
    wrapped = (cum * 10000 + 2 ** 31) % 2 ** 32 - 2 ** 31
    assert (np.diff(wrapped, axis=1) < 0).any(axis=1).all()  # not monotone


def test_policy_form_at_its_edges():
    assert H._policy_form(240, 0) == "vec4"
    assert H._policy_form(4, 256) == "vec4"
    assert H._policy_form(1000, 16) == "vec4"
    for n_bins, ptr in ((241, 0), (242, 0), (1, 0), (240, 4), (240, 8),
                        (257, 16)):
        assert H._policy_form(n_bins, ptr) == "scalar", (n_bins, ptr)


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


def _cuda_matches_plain(arrays, **kw):
    dev = torch.device("cuda")
    mk = lambda: [torch.from_numpy(a.copy()).to(dev) for a in arrays]
    before = H.POLICY_UPDATE_LAUNCHES
    got = H.policy_update(*mk(), **kw)
    want = H.policy_update_plain(*mk(), **kw)
    torch.cuda.synchronize()
    assert H.POLICY_UPDATE_LAUNCHES == before + 1
    for name, g, w in zip(NAMES, got, want):
        assert torch.equal(g, w), (name, arrays[0].shape, kw)


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    seed = 0
    for nbins in (16, 33, 48, 240, 257, 1000):
        for napps in (37, 64, 1000, 5000):
            for consistent in (True, False):
                seed += 1
                arrays = _state(seed, napps, nbins)
                if not consistent:
                    arrays = _inconsistent(arrays, seed)
                for cv in (2.0, 0.5):
                    _cuda_matches_plain(arrays, range_minutes=float(nbins),
                                        cv_threshold=cv)


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_past_max_scaled_count():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    for nbins in (16, 240, 257, 1000):
        arrays = _past_max_scaled_count(_state(nbins, 45, nbins))
        _cuda_matches_plain(arrays, range_minutes=float(nbins))
