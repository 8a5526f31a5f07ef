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
  * the wrapper's argument checks raise before any launch, and its form
    (``_form``: ``vec4`` where D is a multiple of 4 and every tensor
    16-byte aligned, else ``scalar``) at its edges;
  * on a CUDA card (tests marked ``gpu``, skipped elsewhere) the CUDA
    kernel against the plain version within the same tolerance, at L from
    1 to 4,096 (ragged against its 128-step chunk), D 130, 200 and 2,560
    (both forms), B 1 and 3, with the model's decays and with decays near
    1; ``h_last`` equal to ``h[:, -1]``; and the bound fails a carry one
    chunk short (on the CPU at small shapes too: the plain version
    restarted from the state two chunks back).
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


def _inputs(seed, B, L, D, scale=0.98, slow=False):
    """Decays in (0, scale) as the model's sigmoid gates give (``slow``: in
    (0.99, 0.999), a memory of hundreds of steps), and a standard normal
    gated input."""
    rng = np.random.default_rng(seed)
    if slow:
        a = rng.uniform(0.99, 0.999, (B, L, D)).astype(np.float32)
    else:
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


def test_form_at_its_edges():
    assert R._form(2560, 0, 16, 4096) == "vec4"
    assert R._form(4, 256) == "vec4"
    assert R._form(2560) == "vec4"
    for D, ptrs in ((130, (0,)), (1, (0,)), (2559, (0,)), (2560, (0, 4)),
                    (2560, (8, 0)), (200, (16, 20))):
        assert R._form(D, *ptrs) == "scalar", (D, ptrs)


def restarted(b_in, a, want_h, chunks_back):
    """The plain version restarted at the last chunk of R.CHUNK steps from
    the state ``chunks_back`` chunks before it (1: the right carry; 2: a
    carry one chunk short, what a kernel that left the chunk before out of
    its carry would give). None where L has one chunk."""
    L, Q = a.shape[1], R.CHUNK
    k = (L - 1) // Q
    if k == 0:
        return None
    at = k * Q - (chunks_back - 1) * Q - 1
    start = want_h[:, at] if at >= 0 else torch.zeros_like(want_h[:, 0])
    tail, _ = R.rglru_scan_plain(b_in[:, k * Q:], a[:, k * Q:], start)
    return torch.cat([want_h[:, :k * Q], tail], dim=1)


@pytest.mark.parametrize("B,L,D", [(1, 384, 130), (3, 1000, 200),
                                   (2, 129, 8)])
@pytest.mark.parametrize("slow", [False, True])
def test_bound_fails_a_carry_one_chunk_short(B, L, D, slow):
    b_in, a = (torch.from_numpy(x) for x in _inputs(L, B, L, D, slow=slow))
    want_h, _ = R.rglru_scan_plain(b_in, a)
    right = restarted(b_in, a, want_h, 1)
    torch.testing.assert_close(right, want_h, atol=ATOL, rtol=RTOL)
    short = restarted(b_in, a, want_h, 2)
    assert not torch.allclose(short, want_h, atol=ATOL, rtol=RTOL)


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda")
    shapes = [(2, 256, 128), (2, 384, 64), (1, 1, 8), (3, 1000, 200),
              (2, 4096, 2560)]
    shapes += [(B, L, D) for B in (1, 3)
               for L in (1, 2, 63, 64, 65, 384, 1000, 4096)
               for D in (130, 200, 2560)]
    for B, L, D in shapes:
        for slow in (False, True):
            b_in, a = (torch.from_numpy(x).to(dev) for x in
                       _inputs(L + D, B, L, D, slow=slow))
            before = R.LAUNCHES
            h, h_last = R.rglru_scan(b_in, a)
            want_h, want_last = R.rglru_scan_plain(b_in, a)
            torch.cuda.synchronize()
            assert R.LAUNCHES == before + 1
            torch.testing.assert_close(h, want_h, atol=ATOL, rtol=RTOL)
            torch.testing.assert_close(h_last, want_last, atol=ATOL,
                                       rtol=RTOL)
            assert torch.equal(h_last, h[:, -1])
            if L > R.CHUNK:                # the bound sees a carry fault
                short = restarted(b_in, a, want_h, 2)
                assert not torch.allclose(short, want_h, atol=ATOL,
                                          rtol=RTOL)
