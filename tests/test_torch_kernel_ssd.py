"""The port's SSD chunked scan (``repro_torch.kernels.ssd_scan``) against the
TPU kernel it replaces and the reference's plain scan.

  * on the CPU the wrapper runs the plain version (the reference's chunked
    algebra in f32); at ``tests/test_kernels.py``'s cases it must agree
    with ``repro.kernels.ref.ssd_ref`` and with ``repro.kernels.ops.
    ssd_scan`` (the Pallas kernel in interpret mode) within atol 5e-5,
    rtol 5e-4 — that file's tolerances: the three sum in other orders;
  * l = 384 and 640 at chunk 256, and l = 1, against ``ssd_ref`` only: the
    Pallas kernel sets ``Q = min(chunk, l)`` and ``nc = l // Q``, so it
    never visits the tail and leaves NaN in ``y`` (a fault of the reference
    recorded in ROADMAP);
  * the plain version against the per-token recurrence in float64 numpy
    (an oracle that shares no code with either), with and without an
    initial state, within atol 1e-4, rtol 1e-3 (``tests/test_kernels.py``'s
    tolerance for the same check);
  * the wrapper's argument checks raise before any launch;
  * on a CUDA card (test marked ``gpu``, skipped elsewhere) the CUDA kernel
    against the plain version, in f32 (atol 5e-5, rtol 5e-4) and with bf16
    x, B and C (the kernel rounds y to bf16, at most 2^-8 of |y|: rtol
    8e-3 and atol 1e-3 of the largest |y|; the final state, which stays
    f32, within 1e-4 of its largest magnitude), at ragged lengths and with
    an initial state; where there is more than one chunk, a carry one
    chunk short (the plain version without one chunk's contribution to the
    state entering the next) must fail the same bf16 bound;
  * the bf16 form's widest state is checked before any launch.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as S

ATOL, RTOL = 5e-5, 5e-4


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


def _inputs(seed, b, l, h, p, n, dt_scale=0.1):
    """The reference tests' distributions: normal x, B, C; dt = |normal| *
    dt_scale; A = -|normal|."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, l, h, p)).astype(np.float32)
    dt = (np.abs(rng.normal(size=(b, l, h))) * dt_scale).astype(np.float32)
    A = (-np.abs(rng.normal(size=(h,)))).astype(np.float32)
    B = rng.normal(size=(b, l, n)).astype(np.float32)
    C = rng.normal(size=(b, l, n)).astype(np.float32)
    return x, dt, A, B, C


def _torch(arrays, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in arrays]


@pytest.mark.parametrize("l,chunk", [(64, 16), (128, 32), (256, 64),
                                     (128, 128)])
@pytest.mark.parametrize("n,p", [(8, 16), (16, 32)])
def test_plain_scan_matches_reference(ref, l, chunk, n, p):
    arrays = _inputs(l + chunk + n, 2, l, 3, p, n)
    y, s = ops.ssd_scan(*_torch(arrays), chunk=chunk)
    jargs = [ref.jnp.asarray(a) for a in arrays]
    for want_y, want_s in (ref.ref.ssd_ref(*jargs, chunk),
                           ref.ops.ssd_scan(*jargs, chunk=chunk)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=ATOL,
                                   rtol=RTOL)
        np.testing.assert_allclose(s.numpy(), np.asarray(want_s), atol=ATOL,
                                   rtol=RTOL)


@pytest.mark.parametrize("l", [384, 640, 1])
def test_plain_scan_at_ragged_lengths(ref, l):
    arrays = _inputs(l, 1, l, 2, 16, 8)
    y, s = ops.ssd_scan(*_torch(arrays), chunk=256)
    want_y, want_s = ref.ref.ssd_ref(*[ref.jnp.asarray(a) for a in arrays],
                                     256)
    assert np.isfinite(y.numpy()).all()
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), atol=ATOL,
                               rtol=RTOL)


def _recurrence(x, dt, A, B, C, S0):
    """y_t = C_t . S_t with S_t = exp(dt_t A) S_{t-1} + dt_t B_t x_t^T, in
    float64."""
    b, l, h, p = x.shape
    S = S0.astype(np.float64)
    y = np.zeros((b, l, h, p))
    for t in range(l):
        a = np.exp(dt[:, t].astype(np.float64) * A[None])          # [b,h]
        S = S * a[..., None, None] + np.einsum(
            "bn,bh,bhp->bhnp", B[:, t], dt[:, t], x[:, t])
        y[:, t] = np.einsum("bn,bhnp->bhp", C[:, t], S)
    return y, S


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("l,chunk", [(32, 8), (45, 16), (1, 8)])
def test_plain_scan_matches_sequential_recurrence(l, chunk, with_state):
    b, h, p, n = 2, 2, 8, 4
    x, dt, A, B, C = _inputs(l + 100 * with_state, b, l, h, p, n,
                             dt_scale=0.2)
    S0 = np.zeros((b, h, n, p), np.float32)
    if with_state:
        S0 = np.random.default_rng(l).normal(size=S0.shape).astype(
            np.float32)
    y, s = S.ssd_scan_plain(*_torch((x, dt, A, B, C)), chunk,
                            torch.from_numpy(S0) if with_state else None)
    want_y, want_s = _recurrence(x, dt, A, B, C, S0)
    np.testing.assert_allclose(y.numpy(), want_y, atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(s.numpy(), want_s, atol=1e-4, rtol=1e-3)


def test_wrapper_keeps_x_dtype_and_returns_an_f32_state():
    x, dt, A, B, C = _torch(_inputs(3, 1, 32, 2, 8, 4))
    y, s = ops.ssd_scan(x.bfloat16(), dt, A, B.bfloat16(), C.bfloat16(),
                        chunk=16)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    want, _ = S.ssd_scan_plain(x.bfloat16(), dt, A, B.bfloat16(),
                               C.bfloat16(), 16)
    assert torch.equal(y, want.bfloat16())


def test_check_cuda_args_rejects_what_the_kernel_does_not_take():
    b, l, h, p, n = 2, 16, 3, 8, 4
    x, dt, A, B, C = _torch(_inputs(0, b, l, h, p, n))
    S._check_cuda_args(x, dt, A, B, C, 16, None)                # f32
    S._check_cuda_args(x.bfloat16(), dt, A, B.bfloat16(), C.bfloat16(), 256,
                       torch.zeros(b, h, n, p))                  # bf16
    # strided views, as the model hands them over
    xbc = torch.zeros(b, l, h * p + 2 * n)
    S._check_cuda_args(xbc[..., :h * p].reshape(b, l, h, p), dt, A,
                       xbc[..., h * p:h * p + n], xbc[..., h * p + n:], 16,
                       None)
    bad = [
        (x.double(), dt, A, B, C, 16, None),                     # dtype
        (x, dt, A, B.bfloat16(), C, 16, None),                   # mixed
        (x, dt.bfloat16(), A, B, C, 16, None),                   # dt dtype
        (x, dt, A[:2], B, C, 16, None),                          # A shape
        (x, dt[:, :8], A, B, C, 16, None),                       # dt shape
        (x, dt, A, B[:, :8], C, 16, None),                       # B length
        (x, dt, A, B, C[..., :2], 16, None),                     # C width
        (x[..., ::2], dt, A, B, C, 16, None),                    # stride
        (x, dt, A, B, C, 0, None),                               # chunk
        (x, dt, A, B, C, 257, None),
        (x, dt, A, B, C, 16, torch.zeros(b, h, n, p + 1)),       # state
        (x, dt, A, B, C, 16, torch.zeros(b, h, n, p).bfloat16()),
        (x[0], dt, A, B, C, 16, None),                           # rank
        (x[:, :0], dt[:, :0], A, B[:, :0], C[:, :0], 16, None),  # empty
    ]
    for args in bad:
        with pytest.raises(ValueError):
            S._check_cuda_args(*args)


def test_timing_inputs_are_views_the_kernel_takes():
    """The inputs chip_smoke.py times and checks the kernel on are strided
    views into one conv output, as the model hands them over."""
    from repro_torch.kernels.timing import ssd_inputs
    for model_like in (True, False):
        x, dt, A, B, C = ssd_inputs(2, 16, 3, 8, 4, torch.bfloat16, "cpu",
                                    0, model_like)
        S._check_cuda_args(x, dt, A, B, C, 16, None)
        assert not x.is_contiguous() and not B.is_contiguous()
        assert x.untyped_storage().data_ptr() == \
            C.untyped_storage().data_ptr()
        assert bool((dt > 0).all()) and bool((A < 0).all())


def _y_close(got, want):
    """The bf16 gate: y rounded to bf16 (at most 2^-8 of |y|, rtol 8e-3)
    over an f32 result, atol 1e-3 of the largest |y|."""
    atol = 1e-3 * max(1.0, float(want.abs().max()))
    return bool(((got.float() - want).abs()
                 <= atol + 8e-3 * want.abs()).all())


def _carry_dropped(x, dt, A, B, C, chunk, S0, k):
    """The plain scan's y with the state entering chunk k short of chunk
    k - 1's contribution (x of chunk k - 1 zeroed for chunks >= k only)."""
    y, _ = S.ssd_scan_plain(x, dt, A, B, C, chunk, S0)
    xz = x.clone()
    xz[:, (k - 1) * chunk:k * chunk] = 0
    y_drop, _ = S.ssd_scan_plain(xz, dt, A, B, C, chunk, S0)
    y_drop[:, :k * chunk] = y[:, :k * chunk]
    return y_drop


def test_bf16_state_width_is_checked():
    b, l, h, p = 1, 8, 2, 8
    n = S.MAX_BF16_STATE
    x, dt, A, B, C = _torch(_inputs(0, b, l, h, p, n + 1))
    S._check_cuda_args(x, dt, A, B, C, 8, None)          # f32: any n
    xb, Bb, Cb = x.bfloat16(), B.bfloat16(), C.bfloat16()
    S._check_cuda_args(xb, dt, A, Bb[..., :n], Cb[..., :n], 8, None)
    with pytest.raises(ValueError, match="at most"):
        S._check_cuda_args(xb, dt, A, Bb, Cb, 8, None)


def test_release_scratch_frees_the_named_device_only():
    dev = torch.device
    saved = dict(S._SCRATCH)
    try:
        S._SCRATCH.clear()
        for d in ("cuda:0", "cuda:1", "cpu"):
            S._SCRATCH[dev(d)] = torch.empty(16, dtype=torch.uint8)
        S.release_scratch("cuda:1")
        assert set(S._SCRATCH) == {dev("cuda:0"), dev("cpu")}
        S.release_scratch("cuda")            # any index of the type
        assert set(S._SCRATCH) == {dev("cpu")}
        S.release_scratch()
        assert not S._SCRATCH
    finally:
        S._SCRATCH.clear()
        S._SCRATCH.update(saved)


def test_dropped_chunk_fails_the_bf16_gate():
    """Leaving one chunk out of the carried state moves y past the bound
    the card's bf16 check holds the kernel to."""
    x, dt, A, B, C = _torch(_inputs(5, 1, 96, 2, 8, 4))
    want, _ = S.ssd_scan_plain(x, dt, A, B, C, 32)
    assert _y_close(want.bfloat16(), want)
    assert not _y_close(_carry_dropped(x, dt, A, B, C, 32, None, 2), want)


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda")
    cases = [(2, 256, 3, 16, 8, 64, False), (1, 384, 2, 16, 8, 256, True),
             (1, 640, 2, 64, 128, 256, False), (2, 1, 4, 64, 128, 256, True),
             (2, 1000, 5, 72, 130, 128, True),
             (2, 384, 6, 64, 128, 256, True), (1, 640, 4, 64, 128, 256, True),
             (2, 1, 3, 64, 128, 256, False),
             (2, 1024, 16, 64, 128, 256, True)]
    for b, l, h, p, n, chunk, with_state in cases:
        arrays = _inputs(l + h, b, l, h, p, n)
        x, dt, A, B, C = _torch(arrays, dev)
        S0 = torch.randn(b, h, n, p, device=dev) if with_state else None
        before = S.LAUNCHES
        y, s = S.ssd_scan(x, dt, A, B, C, chunk=chunk, initial_state=S0)
        want_y, want_s = S.ssd_scan_plain(x, dt, A, B, C, chunk, S0)
        torch.cuda.synchronize()
        assert S.LAUNCHES == before + 1
        torch.testing.assert_close(y, want_y, atol=ATOL, rtol=RTOL)
        torch.testing.assert_close(s, want_s, atol=ATOL, rtol=RTOL)
        xb, Bb, Cb = x.bfloat16(), B.bfloat16(), C.bfloat16()
        y, s = S.ssd_scan(xb, dt, A, Bb, Cb, chunk=chunk, initial_state=S0)
        want_y, want_s = S.ssd_scan_plain(xb, dt, A, Bb, Cb, chunk, S0)
        torch.cuda.synchronize()
        assert y.dtype == torch.bfloat16
        # y rounded to bf16 (at most 2^-8 of |y|) over an f32 result
        torch.testing.assert_close(
            y.float(), want_y, rtol=8e-3,
            atol=1e-3 * max(1.0, float(want_y.abs().max())))
        assert float((s - want_s).abs().max()) <= \
            1e-4 * float(want_s.abs().max())
        nc = -(-l // chunk)
        if nc > 1:      # the gate catches a carry that is one chunk short
            assert not _y_close(
                _carry_dropped(xb, dt, A, Bb, Cb, chunk, S0, nc - 1), want_y)
