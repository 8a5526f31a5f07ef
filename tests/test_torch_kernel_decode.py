"""The port's flash-decode (``repro_torch.kernels.decode_attention``)
against the TPU kernel it replaces and the reference's oracle.

  * on the CPU ``ops.decode_attention`` runs the plain version; at
    ``tests/test_kernels.py``'s cases (B 2, Hq 4, Hkv 2, D 64; (Skv,
    kv_len) in (256, 256), (512, 300), (512, 1), (1024, 777)) and at
    Qwen2-7B's group of 7 with D 128, it must agree with
    ``repro.kernels.ref.decode_attention_ref`` and with
    ``repro.kernels.ops.decode_attention`` (the Pallas kernel in interpret
    mode, bk 128) within that file's tolerances: 2e-5 for f32 (the sums run
    in another order), 2e-2 for bf16 (the output is rounded to bf16 once);
  * Skv 640 with kv_len 600 and Skv 4,112 (the serving path's cache) with
    kv_len 4,100 against ``decode_attention_ref`` only: the Pallas kernel
    sets ``bk = min(bk, Skv)`` and ``nk = Skv // bk`` and never visits the
    keys past the last whole block (a fault of the reference recorded in
    ROADMAP Queue C);
  * kv_len 0 and kv_len > Skv raise, and the wrapper's argument checks
    raise before any launch;
  * the form a CUDA launch takes (tensor cores or CUDA cores), chosen in
    Python from dtype, head dim and strides, and the kernel's scratch, kept
    once a shape;
  * on a CUDA card (tests marked ``gpu``, skipped elsewhere) both forms of
    the CUDA kernel against the plain version, at small shapes, ragged
    lengths, split edges, groups of 7 and 18 and the serving path's shape:
    f32 at 2e-5, bf16 within one bf16 rounding step (``CUDA_TOL``); two
    calls in a row and a CUDA graph replayed twice give the same output.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import ops

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# The CUDA kernel against the plain version, (atol, rtol): both compute in
# f32 and round the output once, so a bf16 output may differ by one bf16
# rounding step (at most 2^-7 of its magnitude): rtol 8e-3, atol 1e-3 of the
# largest |want|, the bound chip_smoke.py holds the kernel to. f32: 2e-5.
CUDA_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (1e-3, 8e-3)}
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
        yield SimpleNamespace(ops=jops, ref=jref, jnp=jax.numpy)


def _inputs(seed, B, Skv, Hq, Hkv, D):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, 1, Hq, D)).astype(np.float32),
            rng.normal(size=(B, Skv, Hkv, D)).astype(np.float32),
            rng.normal(size=(B, Skv, Hkv, D)).astype(np.float32))


def _reference(ref, arrays, dtype, kv_len, pallas=True):
    """(decode_attention_ref, Pallas kernel in interpret mode), [B,1,Hq,D]."""
    jnp = ref.jnp
    q, k, v = (jnp.asarray(a, getattr(jnp, dtype)) for a in arrays)
    B, _, Hq, D = q.shape
    Hkv = k.shape[2]
    want = ref.ref.decode_attention_ref(
        q[:, 0].reshape(B, Hkv, Hq // Hkv, D), jnp.moveaxis(k, 1, 2),
        jnp.moveaxis(v, 1, 2), jnp.int32(kv_len)).reshape(B, 1, Hq, D)
    outs = [np.asarray(want, np.float32)]
    if pallas:
        got = ref.ops.decode_attention(q, k, v, jnp.int32(kv_len), bk=128)
        outs.append(np.asarray(got, np.float32))
    return outs


def _port(arrays, dtype, kv_len):
    q, k, v = (torch.from_numpy(a).to(TORCH_DTYPE[dtype]) for a in arrays)
    out = ops.decode_attention(q, k, v, kv_len)
    assert out.dtype == q.dtype and out.shape == q.shape
    return out.float().numpy()


@pytest.mark.parametrize("Skv,kv_len", [(256, 256), (512, 300), (512, 1),
                                        (1024, 777)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_decode_matches_reference(ref, Skv, kv_len, dtype):
    arrays = _inputs(1, 2, Skv, 4, 2, 64)
    got = _port(arrays, dtype, kv_len)
    for want in _reference(ref, arrays, dtype, kv_len):
        np.testing.assert_allclose(got, want, atol=TOL[dtype],
                                   rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_decode_group_of_seven(ref, dtype):
    """Qwen2-7B's grouping: 7 q heads a KV head, head dim 128."""
    arrays = _inputs(2, 1, 512, 14, 2, 128)
    got = _port(arrays, dtype, 333)
    for want in _reference(ref, arrays, dtype, 333):
        np.testing.assert_allclose(got, want, atol=TOL[dtype],
                                   rtol=TOL[dtype])


@pytest.mark.parametrize("B,Skv,kv_len", [(1, 640, 600), (2, 4112, 4100)])
def test_plain_decode_at_ragged_cache_lengths(ref, B, Skv, kv_len):
    """Cache lengths that are not a multiple of the Pallas kernel's block:
    only ``decode_attention_ref`` is the target here."""
    arrays = _inputs(3, B, Skv, 8, 2, 64)
    got = _port(arrays, "float32", kv_len)
    (want,) = _reference(ref, arrays, "float32", kv_len, pallas=False)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def test_kv_len_out_of_range_raises():
    q, k, v = (torch.from_numpy(a) for a in _inputs(4, 1, 64, 4, 2, 32))
    for bad in (0, -1, 65):
        with pytest.raises(ValueError, match="kv_len"):
            ops.decode_attention(q, k, v, bad)
        with pytest.raises(ValueError, match="kv_len"):
            DA.decode_attention_plain(q, k, v, bad)
    assert ops.decode_attention(q, k, v, 64).shape == q.shape


@pytest.mark.parametrize("dtype,D,Skv,pad,form", [
    ("bfloat16", 128, 4112, 0, "tensor_cores"),     # Qwen2-7B's cache
    ("bfloat16", 64, 256, 0, "tensor_cores"),
    ("bfloat16", 256, 96, 0, "tensor_cores"),
    ("bfloat16", 36, 100, 0, "cuda_cores"),
    ("bfloat16", 128, 300, 4, "cuda_cores"),        # row stride of 132
    ("float32", 128, 4112, 0, "cuda_cores"),
])
def test_form_is_chosen_from_dtype_head_dim_and_strides(dtype, D, Skv, pad,
                                                        form):
    q = torch.zeros(2, 1, 28, D, dtype=TORCH_DTYPE[dtype])
    kv = torch.zeros(2, Skv, 4, D + pad, dtype=TORCH_DTYPE[dtype])[..., :D]
    assert DA._form(q, kv, kv) == form
    assert DA._form(q, kv[:, :Skv // 2], kv[:, :Skv // 2]) == form


def test_scratch_is_kept_per_shape():
    """The kernel's f32 partials and its counters are made once a shape:
    the same shape reuses them, another gets its own; counters start 0."""
    cpu = torch.device("cpu")
    first = DA._scratch(cpu, 2, 28, 33, 128)
    again = DA._scratch(cpu, 2, 28, 33, 128)
    assert all(a is b for a, b in zip(first, again))
    m_part, l_part, acc_part, counters = first
    assert m_part.numel() == l_part.numel() == 2 * 28 * 33
    assert acc_part.numel() == 2 * 28 * 33 * 128
    assert counters.dtype == torch.int32 and counters.numel() == 2 * 28
    assert not counters.any()
    for other in ((1, 28, 33, 128), (2, 28, 34, 128), (2, 14, 33, 128),
                  (2, 28, 33, 64)):
        bufs = DA._scratch(cpu, *other)
        assert not any(a is b for a, b in zip(first, bufs))


def test_check_cuda_args_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(2, 1, 4, 32)
    kv = torch.zeros(2, 64, 2, 32)
    DA._check_cuda_args(q, kv, kv)                       # well-formed
    DA._check_cuda_args(q, kv[:, :40], kv[:, :40])       # a strided view
    bad = [
        (torch.zeros(2, 2, 4, 32), kv, kv),
        (q, torch.zeros(2, 64, 3, 32), torch.zeros(2, 64, 3, 32)),
        (q, kv, torch.zeros(2, 32, 2, 32)),
        (q, torch.zeros(1, 64, 2, 32), torch.zeros(1, 64, 2, 32)),
        (torch.zeros(2, 1, 4, 512), torch.zeros(2, 64, 2, 512),
         torch.zeros(2, 64, 2, 512)),
        (q.double(), kv.double(), kv.double()),
        (q, kv.to(torch.bfloat16), kv),
        (q, kv.transpose(1, 3).contiguous().transpose(1, 3), kv),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            DA._check_cuda_args(*args)


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version():
    """Both forms against the plain version, at small shapes, ragged
    lengths, kv_len at a split edge (``SPLIT_KEYS``) and one key past it,
    groups of 7 and 18 and the serving path's shape; each call is one
    launch; a second call on the same inputs gives the same output (the
    split counters were left at 0)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    edge = DA.SPLIT_KEYS
    cases = [((2, 256, 4, 2, 64), 256, "float32"),
             ((2, 512, 4, 2, 64), 300, "float32"),
             ((2, 512, 4, 2, 64), 1, "bfloat16"),
             ((2, 1024, 4, 2, 64), 777, "bfloat16"),
             ((1, 640, 8, 2, 64), 600, "float32"),
             ((1, 640, 8, 2, 64), 600, "bfloat16"),
             ((2, 4112, 28, 4, 128), 4097, "bfloat16"),
             ((2, 4112, 28, 4, 128), 4112, "bfloat16"),
             ((2, 4112, 28, 4, 128), 4112, "float32"),
             ((2, 4112, 28, 4, 128), edge, "bfloat16"),
             ((2, 4112, 28, 4, 128), edge + 1, "bfloat16"),
             ((2, 4112, 28, 4, 128), 4112 // edge * edge, "bfloat16"),
             ((2, 4112, 28, 4, 128), 4112 // edge * edge + 1, "bfloat16"),
             ((1, 300, 18, 1, 128), 299, "bfloat16"),    # group 18
             ((1, 300, 18, 1, 64), 257, "bfloat16"),
             ((1, 300, 18, 1, 40), 299, "float32"),      # group 18, D 40
             ((1, 96, 2, 2, 256), 96, "bfloat16"),
             ((1, 100, 4, 2, 36), 77, "bfloat16"),       # CUDA-core bf16
             ((2, 70, 3, 3, 18), 70, "float32")]
    for shape, kv_len, dtype in cases:
        q, k, v = (torch.from_numpy(a).to(dev, TORCH_DTYPE[dtype])
                   for a in _inputs(5, *shape[:2], *shape[2:]))
        form = DA._form(q, k, v)
        assert form == ("tensor_cores" if dtype == "bfloat16"
                        and shape[-1] in (64, 128, 256) else "cuda_cores")
        before = DA.LAUNCHES
        before_form = DA.LAUNCHES_BY_FORM[form]
        got = DA.decode_attention(q, k, v, kv_len)
        again = DA.decode_attention(q, k, v, kv_len)
        want = DA.decode_attention_plain(q, k, v, kv_len)
        torch.cuda.synchronize()
        assert DA.LAUNCHES == before + 2
        assert DA.LAUNCHES_BY_FORM[form] == before_form + 2
        assert torch.equal(got, again)
        got, want = got.float(), want.float()
        atol, rtol = CUDA_TOL[dtype]
        if dtype == "bfloat16":
            atol *= float(want.abs().max())
        torch.testing.assert_close(got, want, atol=atol, rtol=rtol)


@pytest.mark.gpu
def test_cuda_kernel_in_a_cuda_graph():
    """A CUDA graph of decode calls (the serving shape, two fill levels)
    replayed twice gives the eager outputs both times: the last block of
    each split group resets its counter, so a replay finds them at 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda")
    q, k, v = (torch.from_numpy(a).to(dev, torch.bfloat16)
               for a in _inputs(6, 2, 4112, 28, 4, 128))
    eager = [DA.decode_attention(q, k, v, n) for n in (4097, 4112)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for n in (4097, 4112):
            DA.decode_attention(q, k, v, n)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [DA.decode_attention(q, k, v, n) for n in (4097, 4112)]
    for _ in range(2):
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for o, e in zip(outs, eager):
            assert torch.equal(o, e)
