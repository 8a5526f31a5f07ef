"""GQA flash-decode against a KV cache: a CUDA kernel for Hopper and its
plain PyTorch version.

:func:`decode_attention` is the port of the TPU kernel
``repro/kernels/decode_attention.py::flash_decode`` (body
``_decode_kernel``) behind ``repro/kernels/ops.py::decode_attention``: one
query token per sequence against a cache, keys at or past ``kv_len``
masked. On CUDA tensors it launches ``csrc/decode_attention.cu`` (see the
note at the top of that file for its design and its bound on the card),
once a call, in one of two forms that :func:`_form` picks from dtype, head
dim and strides before the launch: ``"tensor_cores"`` (bf16 with D 64, 128
or 256 and 16-byte strides and pointers: the serving path) or
``"cuda_cores"``. On CPU tensors it runs :func:`decode_attention_plain`.
There is no fallback: a CUDA tensor either reaches the kernel of its form
or the call raises.

Both take the model's layout, q ``[B,1,Hq,D]`` and the caches ``[B,Skv,
Hkv,D]``, where the reference's kernel and oracle take ``[B,Hkv,group,D]``
and ``[B,Hkv,Skv,D]``. ``kv_len`` is a host int in ``[1, Skv]``: the two
reference forms disagree below 1 (the kernel gives 0, the oracle the mean
of v), so both versions here reject it. Or it is a one-element int64
tensor on q's device (the decode step's position plus one, as the serve
engine's captured CUDA graph carries it): never read on the host, so not
checked there; it must hold a value in ``[1, Skv]`` (the kernel clamps it to
``[0, Skv]``). The kernel then launches a block per split of the whole
cache and each block reads the length, so that one launch, captured once,
serves every fill level.
"""
from __future__ import annotations

import math
import operator

import numpy as np
import torch

from . import build, refuse_grad

__all__ = ["LAUNCHES", "LAUNCHES_BY_FORM", "SPLIT_KEYS", "decode_attention",
           "decode_attention_plain", "scratch_tensors"]

#: Kernel launches made by this process (plain-version calls do not count).
LAUNCHES = 0
#: The same launches by form (see :func:`_form`).
LAUNCHES_BY_FORM = {"tensor_cores": 0, "cuda_cores": 0}

#: Keys per split of the CUDA kernel (a multiple of its 128-key step). At
#: the serving shape, kv_len 4,097-4,112 gives 11 splits x 8 (batch row, KV
#: head) = 88 blocks; each block's 8 warps hold all 384 of its keys in
#: flight at once (three 16-key slots a warp), 192 KB a block, the whole
#: 16.8 MB on the card. Fewer splits leave less for the in-launch merge;
#: chip_smoke.py times 128, 256, 384 and 512 (``times_decode``).
SPLIT_KEYS = 384

_FORM_CODE = {"cuda_cores": 0, "tensor_cores": 1}
_TENSOR_CORE_HEAD_DIMS = (64, 128, 256)

# (device, B, Hq, max splits, D) -> (m_part, l_part, acc_part, counters):
# the kernel's f32 scratch and its per-(batch row, KV head, group chunk)
# int32 counters, allocated once (counters zeroed; the kernel leaves them
# zeroed). One stream at a time may use a set.
_SCRATCH = {}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _kv_len(kv_len, Skv: int, device):
    """``kv_len`` as the two versions take it: a host int checked against
    ``[1, Skv]``, or a one-element int64 tensor on ``device`` as it is."""
    if isinstance(kv_len, torch.Tensor):
        if kv_len.numel() != 1 or kv_len.dtype != torch.int64 \
                or kv_len.device != torch.device(device):
            raise ValueError(f"decode_attention: a kv_len tensor must be one "
                             f"int64 on {device}, got {kv_len.dtype} "
                             f"{tuple(kv_len.shape)} on {kv_len.device}")
        return kv_len
    n = operator.index(kv_len)
    if not 1 <= n <= Skv:
        raise ValueError(f"decode_attention: kv_len {n} is not in [1, "
                         f"{Skv}]")
    return n


def decode_attention_plain(q, k, v, kv_len):
    """The kernel's function in plain PyTorch ops, on any device (the port
    of ``repro/kernels/ref.py::decode_attention_ref``): q ``[B,1,Hq,D]``,
    k/v ``[B,Skv,Hkv,D]`` -> ``[B,1,Hq,D]`` in q's dtype; softmax in f32
    over the keys ``j < kv_len`` (a host int, or a one-element int64
    tensor on q's device, compared on the device), masked logits -1e30."""
    B, _, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    n = _kv_len(kv_len, Skv, q.device)
    if isinstance(n, torch.Tensor):
        n = n.reshape(())
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


def _form(q, k, v) -> str:
    """The kernel form a CUDA launch takes, from dtype, head dim and
    strides alone: ``"tensor_cores"`` for bf16 with D in (64, 128, 256),
    the batch and head strides of q and the batch, row and head strides of
    k and v multiples of 8 elements and every base 16-byte aligned; else
    ``"cuda_cores"``."""
    if q.dtype != torch.bfloat16 or q.shape[-1] not in _TENSOR_CORE_HEAD_DIMS:
        return "cuda_cores"
    strides = (q.stride(0), q.stride(2), *k.stride()[:3], *v.stride()[:3])
    aligned = all(s % 8 == 0 for s in strides) and all(
        x.data_ptr() % 16 == 0 for x in (q, k, v))
    return "tensor_cores" if aligned else "cuda_cores"


def scratch_tensors(device) -> list:
    """Every scratch tensor kept for ``device``: what a CUDA graph of this
    kernel's launches there reads and writes besides its arguments (the
    serve engine's cache entries hold them)."""
    dev = torch.device(device)
    return [t for key, bufs in _SCRATCH.items() if key[0] == dev
            for t in bufs]


def _scratch(device, B: int, Hq: int, max_splits: int, D: int):
    """The scratch of calls of this shape: made at the first and reused by
    every later one (a new shape gets its own)."""
    key = (torch.device(device), B, Hq, max_splits, D)
    bufs = _SCRATCH.get(key)
    if bufs is None:
        f32 = dict(dtype=torch.float32, device=device)
        bufs = _SCRATCH[key] = (
            torch.empty(B * Hq * max_splits, **f32),
            torch.empty(B * Hq * max_splits, **f32),
            torch.empty(B * Hq * max_splits * D, **f32),
            torch.zeros(B * Hq, dtype=torch.int32, device=device))
    return bufs


def _launch(q, k, v, n):
    global LAUNCHES
    _check_cuda_args(q, k, v)
    B, _, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    form = _form(q, k, v)
    # a device kv_len: the grid covers the whole cache, the kernel reads it
    n, n_ptr = (Skv, n.data_ptr()) if isinstance(n, torch.Tensor) \
        else (n, None)
    n_splits = -(-n // SPLIT_KEYS)
    out = torch.empty((B, 1, Hq, D), dtype=q.dtype, device=q.device)
    scratch = _scratch(q.device, B, Hq, -(-Skv // SPLIT_KEYS), D)
    strides = (q.stride(0), q.stride(2), *k.stride()[:3], *v.stride()[:3])
    # the reference divides by sqrt(D) as a float32 scalar (CUDA cores);
    # the tensor cores scale the f32 scores by log2(e) / sqrt(D) for exp2
    q_div = float(np.float32(math.sqrt(D)))
    build.launch(
        "decode_attention", "decode_attention_fwd", q.device, q.data_ptr(),
        k.data_ptr(), v.data_ptr(), out.data_ptr(),
        *(x.data_ptr() for x in scratch), _FORM_CODE[form],
        _DTYPE_CODE[q.dtype], B, Hq, Hkv, D, Skv, n, n_ptr, SPLIT_KEYS,
        n_splits, *strides, q_div, math.log2(math.e) / math.sqrt(D),
        form=form)
    LAUNCHES += 1
    LAUNCHES_BY_FORM[form] += 1
    return out


def decode_attention(q, k, v, kv_len):
    """One query token per sequence against a KV cache in the model's
    layout: q ``[B,1,Hq,D]``, k/v ``[B,Skv,Hkv,D]`` (f32 or bf16, last
    dimension contiguous, any other strides), ``kv_len`` a host int in
    ``[1, Skv]`` or a one-element int64 tensor on q's device holding one
    (read on the device only) -> ``[B,1,Hq,D]`` in q's dtype; q head h
    reads KV head h // (Hq / Hkv) over the keys ``j < kv_len``.

    CPU tensors run the plain version; CUDA tensors launch the kernel in
    the form :func:`_form` picks (and count one launch in ``LAUNCHES`` and
    in ``LAUNCHES_BY_FORM``) or raise.
    An input that requires grad, in grad mode, raises on either device
    (:func:`refuse_grad`)."""
    refuse_grad("decode_attention", q, k, v)
    n = _kv_len(kv_len, k.shape[1], q.device)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, n)
    if q.device.type == "cuda":
        return _launch(q, k, v, n)
    raise ValueError(f"decode_attention: no kernel for device {q.device}")
