"""GQA flash-decode against a KV cache: a CUDA kernel for Hopper and its
plain PyTorch version.

:func:`decode_attention` is the port of the TPU kernel
``repro/kernels/decode_attention.py::flash_decode`` (body
``_decode_kernel``) behind ``repro/kernels/ops.py::decode_attention``: one
query token per sequence against a cache, keys at or past ``kv_len``
masked. On CUDA tensors it launches ``csrc/decode_attention.cu`` (see the
note at the top of that file for its design and its bound on the card); on
CPU tensors it runs :func:`decode_attention_plain`. There is no fallback: a
CUDA tensor either reaches the kernel or the call raises.

Both take the model's layout, q ``[B,1,Hq,D]`` and the caches ``[B,Skv,
Hkv,D]``, where the reference's kernel and oracle take ``[B,Hkv,group,D]``
and ``[B,Hkv,Skv,D]``. ``kv_len`` is a host int in ``[1, Skv]``: the two
reference forms disagree below 1 (the kernel gives 0, the oracle the mean
of v), so both versions here reject it.
"""
from __future__ import annotations

import ctypes
import math
import operator

import numpy as np
import torch

__all__ = ["LAUNCHES", "SPLIT_KEYS", "decode_attention",
           "decode_attention_plain"]

#: Kernel launches made by this process (plain-version calls do not count).
LAUNCHES = 0

#: Keys per split of the CUDA kernel (a multiple of its 32-key tile): at
#: the serving shape, kv_len 4,097-4,112 gives 33 splits x 8 (batch row,
#: KV head) = 264 blocks, two for each of the 132 SMs.
SPLIT_KEYS = 128

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _kv_len(kv_len, Skv: int) -> int:
    n = operator.index(kv_len)
    if not 1 <= n <= Skv:
        raise ValueError(f"decode_attention: kv_len {n} is not in [1, "
                         f"{Skv}]")
    return n


def decode_attention_plain(q, k, v, kv_len):
    """The kernel's function in plain PyTorch ops, on any device (the port
    of ``repro/kernels/ref.py::decode_attention_ref``): q ``[B,1,Hq,D]``,
    k/v ``[B,Skv,Hkv,D]`` -> ``[B,1,Hq,D]`` in q's dtype; softmax in f32
    over the keys ``j < kv_len``, masked logits -1e30."""
    B, _, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    n = _kv_len(kv_len, Skv)
    qf = q[:, 0].float().reshape(B, Hkv, Hq // Hkv, D) / math.sqrt(D)
    s = torch.einsum("bhgd,bkhd->bhgk", qf, k.float())
    live = torch.arange(Skv, device=q.device) < n
    p = torch.softmax(torch.where(live, s, -1e30), dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v.float())
    return out.reshape(B, 1, Hq, D).to(q.dtype)


def _check_cuda_args(q, k, v) -> None:
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"decode_attention: q must be [B,1,Hq,D], got "
                         f"{tuple(q.shape)}")
    B, _, Hq, D = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B \
            or k.shape[3] != D:
        raise ValueError(f"decode_attention: k and v must be [B,Skv,Hkv,D] "
                         f"= [{B},Skv,Hkv,{D}], got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    Hkv = k.shape[2]
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"decode_attention: Hq={Hq} is not a multiple of "
                         f"Hkv={Hkv}")
    if not 1 <= D <= 256:
        raise ValueError(f"decode_attention: head dim {D} is not in "
                         f"[1, 256]")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device or x.dtype != q.dtype:
            raise ValueError(f"decode_attention: {name} is {x.dtype} on "
                             f"{x.device}, q is {q.dtype} on {q.device}")
        if x.stride(-1) != 1:
            raise ValueError(f"decode_attention: {name}'s last dimension "
                             f"must be contiguous, strides {x.stride()}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"decode_attention: dtype {q.dtype} is not float32 "
                         f"or bfloat16")


def _lib() -> ctypes.CDLL:
    from . import build
    lib = build.load("decode_attention")
    if not getattr(lib, "_typed", False):
        fn = lib.decode_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + \
            [ctypes.c_int64] * 8 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.decode_attention_error_string.argtypes = [ctypes.c_int]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _launch(q, k, v, n: int):
    global LAUNCHES
    _check_cuda_args(q, k, v)
    lib = _lib()
    B, _, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    n_splits = -(-n // SPLIT_KEYS)
    out = torch.empty((B, 1, Hq, D), dtype=q.dtype, device=q.device)
    f32 = dict(dtype=torch.float32, device=q.device)
    m_part = torch.empty((B, Hq, n_splits), **f32)
    l_part = torch.empty((B, Hq, n_splits), **f32)
    acc_part = torch.empty((B, Hq, n_splits, D), **f32)
    strides = (q.stride(0), q.stride(2), *k.stride()[:3], *v.stride()[:3])
    # the reference divides by sqrt(D) as a float32 scalar
    q_div = float(np.float32(math.sqrt(D)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.decode_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            m_part.data_ptr(), l_part.data_ptr(), acc_part.data_ptr(),
            _DTYPE_CODE[q.dtype], B, Hq, Hkv, D, Skv, n, SPLIT_KEYS,
            n_splits, *strides, q_div, stream)
    if rc != 0:
        raise RuntimeError("decode_attention launch failed: "
                           + lib.decode_attention_error_string(rc).decode())
    LAUNCHES += 1
    return out


def decode_attention(q, k, v, kv_len):
    """One query token per sequence against a KV cache in the model's
    layout: q ``[B,1,Hq,D]``, k/v ``[B,Skv,Hkv,D]`` (f32 or bf16, last
    dimension contiguous, any other strides), ``kv_len`` a host int in
    ``[1, Skv]`` -> ``[B,1,Hq,D]`` in q's dtype; q head h reads KV head
    h // (Hq / Hkv) over the keys ``j < kv_len``.

    CPU tensors run the plain version; CUDA tensors launch the kernel (and
    count one launch in ``LAUNCHES``) or raise."""
    n = _kv_len(kv_len, k.shape[1])
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, n)
    if q.device.type == "cuda":
        return _launch(q, k, v, n)
    raise ValueError(f"decode_attention: no kernel for device {q.device}")
