"""The port's RG-LRU scan (``repro_torch.kernels.rglru_scan``) against the TPU
kernel it replaces and the reference's plain scan.

  * on the CPU the wrapper runs the plain version (a log-step doubling over
    the (a, b) semigroup); at ``tests/test_kernels.py``'s shapes it must
    agree with ``repro.kernels.ref.rglru_ref`` (``jax.lax.associative_scan``)
    and with ``repro.kernels.ops.rglru_scan`` (the Pallas kernel in
    interpret mode) within atol 2e-5, rtol 2e-4 — that file's tolerances:
    the three evaluate the same recurrence in different orders;
  * L=384 against ``rglru_ref`` only: the Pallas kernel sets
    ``T = min(256, L)`` and ``nt = L // T``, so at L=384 it leaves NaN in
    ``h`` past the first block (a fault of the reference recorded in
    ROADMAP);
  * the plain version against the sequential recurrence in float64 numpy
    (an oracle that shares no code with either), with an initial state;
  * the wrapper's argument checks raise before any launch;
  * on a CUDA card (test marked ``gpu``, skipped elsewhere) the CUDA kernel
    against the plain version, at small shapes and at lengths that are not
    a multiple of its 64-step chunk.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import rglru_scan as R

ATOL, RTOL = 2e-5, 2e-4


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


def _inputs(seed, B, L, D, scale=0.98):
    """Decays in (0, scale) as the model's sigmoid gates give, and a
    standard normal gated input."""
    rng = np.random.default_rng(seed)
    a = (scale / (1.0 + np.exp(-rng.normal(size=(B, L, D))))).astype(
        np.float32)
    return rng.normal(size=(B, L, D)).astype(np.float32), a


@pytest.mark.parametrize("L,D,bt,bd", [(64, 32, 16, 16), (128, 64, 32, 32),
                                       (256, 128, 64, 128),
                                       (128, 64, 128, 64)])
def test_plain_scan_matches_reference(ref, L, D, bt, bd):
    b_in, a = _inputs(L + D, 2, L, D)
    h, h_last = ops.rglru_scan(torch.from_numpy(b_in), torch.from_numpy(a))
    jb, ja = ref.jnp.asarray(b_in), ref.jnp.asarray(a)
    for want_h, want_last in (ref.ref.rglru_ref(jb, ja),
                              ref.ops.rglru_scan(jb, ja, block_t=bt,
                                                 block_d=bd)):
        np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=ATOL,
                                   rtol=RTOL)
        np.testing.assert_allclose(h_last.numpy(), np.asarray(want_last),
                                   atol=ATOL, rtol=RTOL)


def test_plain_scan_at_384_steps(ref):
    b_in, a = _inputs(7, 2, 384, 64)
    h, h_last = ops.rglru_scan(torch.from_numpy(b_in), torch.from_numpy(a))
    want_h, want_last = ref.ref.rglru_ref(ref.jnp.asarray(b_in),
                                          ref.jnp.asarray(a))
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(h_last.numpy(), np.asarray(want_last),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("L", [1, 48, 127])
def test_plain_scan_matches_sequential_recurrence(L):
    B, D = 2, 8
    b_in, a = _inputs(L, B, L, D, scale=0.95)
    h0 = np.random.default_rng(L + 1).normal(size=(B, D)).astype(np.float32)
    h, h_last = R.rglru_scan_plain(torch.from_numpy(b_in),
                                   torch.from_numpy(a), torch.from_numpy(h0))
    hs = h0.astype(np.float64)
    want = np.zeros((B, L, D))
    for t in range(L):
        at = a[:, t].astype(np.float64)
        hs = at * hs + np.sqrt(1.0 - at * at) * b_in[:, t]
        want[:, t] = hs
    np.testing.assert_allclose(h.numpy(), want, atol=1e-5, rtol=1e-4)
    np.testing.assert_array_equal(h_last.numpy(), h[:, -1].numpy())


def test_check_cuda_args_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(2, 16, 8)
    R._check_cuda_args(x, x)                            # well-formed
    bad = [(x.double(), x), (x, x[:, :8]), (x[..., ::2], x[..., ::2]),
           (x[0], x[0]), (torch.zeros(2, 0, 8), torch.zeros(2, 0, 8))]
    for args in bad:
        with pytest.raises(ValueError):
            R._check_cuda_args(*args)


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda")
    for B, L, D in ((2, 256, 128), (2, 384, 64), (1, 1, 8), (3, 1000, 200),
                    (2, 4096, 2560)):
        b_in, a = (torch.from_numpy(x).to(dev) for x in _inputs(L, B, L, D))
        before = R.LAUNCHES
        h, h_last = R.rglru_scan(b_in, a)
        want_h, want_last = R.rglru_scan_plain(b_in, a)
        torch.cuda.synchronize()
        assert R.LAUNCHES == before + 1
        torch.testing.assert_close(h, want_h, atol=ATOL, rtol=RTOL)
        torch.testing.assert_close(h_last, want_last, atol=ATOL, rtol=RTOL)
        assert torch.equal(h_last, h[:, -1])
