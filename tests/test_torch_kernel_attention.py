"""The port's local-window attention (``repro_torch.kernels.flash_attention``)
against the TPU kernel it replaces and the reference's plain attention.

  * on the CPU the wrapper runs the plain version (the port of
    ``repro.models.layers._sdpa``); at ``tests/test_kernels.py``'s shapes
    (MHA, GQA, MQA; D 32-128; f32 and bf16) it must agree with
    ``repro.kernels.ref.attention_ref`` and with
    ``repro.kernels.ops.flash_attention`` (the Pallas kernel in interpret
    mode) within that file's tolerances: 2e-5 for f32 (the sums run in
    another order), 2e-2 for bf16 (the output is rounded to bf16 once, and
    a sum that lands near a rounding edge can go either way);
  * the local windows 32, 64 and 128, in f32, within 2e-5;
  * S=640 against ``attention_ref`` only: the Pallas kernel sets
    ``bk = min(512, S)`` and ``nk = S // bk`` and so never visits keys
    512-639 at S=640 (a fault of the reference recorded in ROADMAP);
  * the plain attention's ``kv_len`` mask (the dense KV-cache branch)
    against the reference's ``_sdpa``, with scalar and per-batch
    ``q_offset`` and ``kv_len``;
  * the wrapper's argument checks raise before any launch;
  * the form a CUDA launch takes (Hopper, mma.sync or f32), chosen in
    Python from dtype, head dim and strides;
  * on a CUDA card (test marked ``gpu``, skipped elsewhere) each form of
    the CUDA kernel against the plain version, at small shapes and at both
    serving paths' head dims (256 and 128), ragged S, windows and k and v
    as views of a longer cache.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# The CUDA kernel against the plain version in bf16, (atol as a share of the
# largest |want|, rtol): one bf16 rounding step of the output (rtol), and
# the rounding of P to bf16 before P v, up to 2^-9 of the largest |v| in a
# row with few keys (atol); the bound chip_smoke.py holds the kernel to
# (the reference's 2e-2 is more than a typical output at the serving
# shapes).
CUDA_BF16_TOL = (3e-3, 8e-3)
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
        from repro.models import layers as jlayers
        yield SimpleNamespace(ops=jops, ref=jref, jnp=jax.numpy,
                              layers=jlayers)


def _inputs(seed, B, S, Hq, Hkv, D):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, Hq, D)).astype(np.float32),
            rng.normal(size=(B, S, Hkv, D)).astype(np.float32),
            rng.normal(size=(B, S, Hkv, D)).astype(np.float32))


def _reference(ref, arrays, dtype, window, pallas=True):
    """(attention_ref, Pallas kernel in interpret mode) in [B,S,H,D]."""
    jnp = ref.jnp
    q, k, v = (jnp.asarray(a, getattr(jnp, dtype)) for a in arrays)
    bhsd = lambda x: jnp.moveaxis(x, 1, 2)
    want = bhsd(ref.ref.attention_ref(bhsd(q), bhsd(k), bhsd(v), causal=True,
                                      window=window))
    outs = [np.asarray(want, np.float32)]
    if pallas:
        got = ref.ops.flash_attention(q, k, v, causal=True, window=window,
                                      bq=64, bk=64)
        outs.append(np.asarray(got, np.float32))
    return outs


def _port(arrays, dtype, window):
    q, k, v = (torch.from_numpy(a).to(TORCH_DTYPE[dtype]) for a in arrays)
    out = ops.flash_attention(q, k, v, window=window)
    assert out.dtype == q.dtype and out.shape == q.shape
    return out.float().numpy()


@pytest.mark.parametrize("B,S,Hq,Hkv,D", [
    (1, 128, 2, 2, 32),      # MHA
    (2, 256, 4, 2, 64),      # GQA
    (1, 512, 8, 1, 64),      # MQA
    (2, 128, 4, 4, 128),     # wide head
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_attention_matches_reference(ref, B, S, Hq, Hkv, D, dtype):
    arrays = _inputs(1, B, S, Hq, Hkv, D)
    got = _port(arrays, dtype, 0)
    for want in _reference(ref, arrays, dtype, 0):
        np.testing.assert_allclose(got, want, atol=TOL[dtype],
                                   rtol=TOL[dtype])


@pytest.mark.parametrize("window", [32, 64, 128])
def test_plain_attention_window(ref, window):
    arrays = _inputs(2, 2, 256, 4, 2, 64)
    got = _port(arrays, "float32", window)
    for want in _reference(ref, arrays, "float32", window):
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def test_plain_attention_at_640_rows(ref):
    """S=640 is a multiple of 128 (the model takes the kernel branch) but
    not of the Pallas kernel's 512-key block: only ``attention_ref`` is the
    target here."""
    arrays = _inputs(3, 1, 640, 4, 1, 32)
    got = _port(arrays, "float32", 128)
    (want,) = _reference(ref, arrays, "float32", 128, pallas=False)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("q_offset,kv_len", [
    (0, 24), (16, 20), ([3, 9], 16), ([0, 10], [6, 14]), (8, [9, 13])])
@pytest.mark.parametrize("causal", [True, False])
def test_sdpa_kv_len_matches_reference(ref, q_offset, kv_len, causal):
    """The plain attention over a KV cache (the dense family's cache
    branch): queries at ``q_offset`` (scalar or per batch row) against a
    24-row cache whose keys at or past ``kv_len`` (scalar or per batch row)
    are masked, against the reference's ``_sdpa(..., kv_len=...)``; f32
    within 2e-5."""
    rng = np.random.default_rng(5)
    q = rng.normal(size=(2, 4, 4, 32)).astype(np.float32)
    k = rng.normal(size=(2, 24, 2, 32)).astype(np.float32)
    v = rng.normal(size=(2, 24, 2, 32)).astype(np.float32)
    jnp = ref.jnp
    want = ref.layers._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=causal, window=0,
                            q_offset=jnp.asarray(q_offset),
                            kv_len=jnp.asarray(kv_len))
    got = FA.sdpa(torch.from_numpy(q), torch.from_numpy(k),
                  torch.from_numpy(v), causal=causal, window=0,
                  q_offset=torch.tensor(q_offset),
                  kv_len=torch.tensor(kv_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def _strided(shape, dtype, *, pad_last=0, offset=0, rows=0):
    """A [B, S, H, D] view: rows of a longer cache (``rows`` extra), a head
    stride of D + ``pad_last`` elements, a base ``offset`` elements in."""
    B, S, H, D = shape
    flat = torch.zeros(B * (S + rows) * H * (D + pad_last) + offset,
                       dtype=dtype)
    full = flat[offset:].view(B, S + rows, H, D + pad_last)
    return full[:, :S, :, :D]


@pytest.mark.parametrize("name,q,kv,form", [
    # Qwen2-7B's prefill: q contiguous, k/v the first S rows of the cache
    ("qwen2_cache_view", _strided((2, 256, 28, 128), torch.bfloat16),
     _strided((2, 256, 4, 128), torch.bfloat16, rows=16), "hopper"),
    # RecurrentGemma-2B: D 256, one KV head
    ("recurrentgemma", _strided((2, 256, 10, 256), torch.bfloat16),
     _strided((2, 256, 1, 256), torch.bfloat16), "hopper"),
    ("d64", _strided((1, 128, 4, 64), torch.bfloat16),
     _strided((1, 128, 2, 64), torch.bfloat16), "hopper"),
    ("d36", _strided((1, 200, 2, 36), torch.bfloat16),
     _strided((1, 200, 2, 36), torch.bfloat16), "mma_sync"),
    ("d40", _strided((1, 200, 2, 40), torch.bfloat16),
     _strided((1, 200, 2, 40), torch.bfloat16), "mma_sync"),
    ("d32", _strided((1, 128, 2, 32), torch.bfloat16),
     _strided((1, 128, 2, 32), torch.bfloat16), "mma_sync"),
    ("head_stride_not_16_bytes", _strided((1, 128, 4, 128), torch.bfloat16,
                                          pad_last=4),
     _strided((1, 128, 2, 128), torch.bfloat16), "mma_sync"),
    ("base_not_16_bytes", _strided((1, 128, 4, 128), torch.bfloat16,
                                   offset=4),
     _strided((1, 128, 2, 128), torch.bfloat16), "mma_sync"),
    ("f32", _strided((2, 256, 28, 128), torch.float32),
     _strided((2, 256, 4, 128), torch.float32, rows=16), "f32"),
])
def test_form_is_chosen_from_dtype_head_dim_and_strides(name, q, kv, form):
    """The form a CUDA launch takes, decided in Python before the launch;
    both serving paths' attention takes the Hopper form."""
    assert FA._form(q, kv, kv) == form


def test_check_cuda_args_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(1, 128, 4, 32)
    kv = torch.zeros(1, 128, 2, 32)
    FA._check_cuda_args(q, kv, kv, 16)                  # well-formed
    bad = [
        (q, torch.zeros(1, 128, 3, 32), torch.zeros(1, 128, 3, 32), 0),
        (q, kv, torch.zeros(1, 64, 2, 32), 0),
        (torch.zeros(1, 128, 4, 512), torch.zeros(1, 128, 2, 512),
         torch.zeros(1, 128, 2, 512), 0),
        (q.double(), kv.double(), kv.double(), 0),
        (q, kv.to(torch.bfloat16), kv, 0),
        (q.transpose(2, 3).contiguous().transpose(2, 3), kv, kv, 0),
        (q, kv, kv, -1),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            FA._check_cuda_args(*args)


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version():
    """Every form against the plain version: f32 within 2e-5; bf16 within
    CUDA_BF16_TOL (one bf16 rounding step of the output, atol a share of
    the largest |want|, as chip_smoke.py holds the kernel); the Hopper form
    at both serving paths' head dims, ragged S, a window, and k and v as
    the first S rows of a longer cache (Qwen2-7B's prefill)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    # (shape, dtype, window, extra cache rows of k and v, form)
    cases = [((2, 256, 4, 2, 64), "float32", 0, 0, "f32"),
             ((2, 256, 4, 2, 64), "float32", 32, 0, "f32"),
             ((1, 640, 4, 1, 32), "float32", 128, 0, "f32"),
             ((1, 200, 2, 2, 40), "float32", 0, 0, "f32"),
             ((2, 256, 4, 2, 64), "bfloat16", 32, 0, "hopper"),
             ((1, 200, 2, 2, 36), "bfloat16", 0, 0, "mma_sync"),
             ((1, 200, 2, 2, 40), "bfloat16", 0, 0, "mma_sync"),
             ((1, 512, 8, 1, 256), "bfloat16", 128, 0, "hopper"),
             ((2, 384, 10, 1, 256), "bfloat16", 0, 0, "hopper"),
             ((2, 640, 10, 1, 256), "bfloat16", 2048, 0, "hopper"),
             ((2, 384, 14, 2, 128), "bfloat16", 0, 16, "hopper"),
             ((2, 200, 14, 2, 128), "bfloat16", 0, 16, "hopper"),
             ((1, 130, 7, 1, 128), "bfloat16", 64, 0, "hopper")]
    for shape, dtype, window, extra, form in cases:
        B, S, Hq, Hkv, D = shape
        q, k, v = (torch.from_numpy(a).to(dev, TORCH_DTYPE[dtype])
                   for a in _inputs(4, B, S + extra, Hq, Hkv, D))
        q, k, v = q[:, :S].contiguous(), k[:, :S], v[:, :S]
        assert FA._form(q, k, v) == form
        before = FA.LAUNCHES
        before_form = FA.LAUNCHES_BY_FORM[form]
        got = FA.flash_attention(q, k, v, window=window)
        want = FA.flash_attention_plain(q, k, v, window=window)
        torch.cuda.synchronize()
        assert FA.LAUNCHES == before + 1
        assert FA.LAUNCHES_BY_FORM[form] == before_form + 1
        got, want = got.float(), want.float()
        if dtype == "float32":
            atol = rtol = TOL[dtype]
        else:
            atol = CUDA_BF16_TOL[0] * float(want.abs().max())
            rtol = CUDA_BF16_TOL[1]
        torch.testing.assert_close(got, want, atol=atol, rtol=rtol)
