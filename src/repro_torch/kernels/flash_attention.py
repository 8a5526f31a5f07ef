"""Causal local-window attention with GQA: a CUDA kernel for Hopper and its
plain PyTorch version.

:func:`flash_attention` is the port of the TPU kernel
``repro/kernels/flash_attention.py::flash_attention_bhsd`` (body
``_attn_kernel``) behind ``repro/kernels/ops.py::flash_attention``. On CUDA
tensors it launches ``csrc/flash_attention.cu`` (see the note at the top of
that file for its design and its bound on the card) in one of three
forms, which :func:`_form` picks from dtype, head dim and strides before
the launch: ``"hopper"`` (wgmma and TMA; bf16 with D 64, 128 or 256 and
16-byte strides and pointers, both serving paths), ``"mma_sync"`` (other
bf16) and ``"f32"``. On CPU tensors it runs :func:`flash_attention_plain`.
There is no fallback: a CUDA tensor either reaches the kernel of its form
or the call raises.

:func:`sdpa` is the port of the reference's plain attention
``repro/models/layers.py::_sdpa`` (and ``_sdpa_chunked`` at 8,192 query
rows and up): the function the kernel computes, and the model's branch
when the kernels are off.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import refuse_grad

__all__ = ["LAUNCHES", "LAUNCHES_BY_FORM", "CHUNKED_Q_THRESHOLD", "sdpa",
           "flash_attention", "flash_attention_plain"]

#: Kernel launches made by this process (plain-version calls do not count).
LAUNCHES = 0
#: The same launches by form (see :func:`_form`).
LAUNCHES_BY_FORM = {"hopper": 0, "mma_sync": 0, "f32": 0}

# head dims of the Hopper form (whole 128-byte boxes of bf16 columns)
_HOPPER_HEAD_DIMS = (64, 128, 256)

# Above this many query rows the plain attention goes through query blocks
# of 1,024 rows, so the Sq x Skv score matrix never materializes.
CHUNKED_Q_THRESHOLD = 8192

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _per_batch(x):
    """An int, or a tensor (0-d or per batch row) as [1 or B, 1, 1]: no
    host-to-device copy, so the decode step stays capturable in a CUDA
    graph."""
    return x.reshape(-1, 1, 1) if isinstance(x, torch.Tensor) else x


def _band(q_pos, k_pos, causal: bool, window: int, kv_len=None):
    mask = torch.ones(torch.broadcast_shapes(q_pos.shape, k_pos.shape),
                      dtype=torch.bool, device=q_pos.device)
    if causal:
        mask &= k_pos <= q_pos
    if window and window > 0:
        mask &= k_pos > q_pos - window
    if kv_len is not None:
        mask = mask & (k_pos < _per_batch(kv_len))
    return mask


def _softmax_attend(qf, kf, vf, mask):
    """softmax(qf kf^T masked at -1e30) vf; qf [B,q,H,d] already scaled,
    mask [1 or B, q, k]."""
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    logits = torch.where(mask[:, None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vf)


def _sdpa_chunked(q, k, v, *, causal: bool, window: int, q_offset,
                  kv_len=None, q_block: int = 1024):
    """Query-blocked attention: each block computes complete softmax rows
    against the full K/V (no online rescaling); the transient is
    O(q_block * Skv) instead of O(Sq * Skv)."""
    B, Sq, Hq, hd = q.shape
    Skv = k.shape[1]
    k_pos = torch.arange(Skv, device=q.device)[None, None, :]
    kf, vf = k.float(), v.float()
    offset = _per_batch(q_offset)
    outs = []
    for i in range(Sq // q_block):
        qf = q[:, i * q_block:(i + 1) * q_block].float() / math.sqrt(hd)
        q_pos = (i * q_block + torch.arange(q_block, device=q.device)[:, None]
                 + offset)
        out = _softmax_attend(qf, kf, vf,
                              _band(q_pos, k_pos, causal, window, kv_len))
        outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=1)


def sdpa(q, k, v, *, causal: bool, window: int, q_offset=0, kv_len=None):
    """Scaled-dot-product attention with GQA, in f32, output in q's dtype.

    q [B,Sq,Hq,hd], k/v [B,Skv,Hkv,hd]; ``q_offset`` is the absolute
    position of q[0] (int or per-batch [B]); query i sees keys j <= i when
    ``causal`` and j > i - window when ``window > 0``, and, when ``kv_len``
    (int or per-batch [B]) is given, only keys j < kv_len (the filled part
    of a KV cache); masked logits are -1e30. KV heads are repeated up to
    the q heads (head h reads h // (Hq/Hkv))."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    if group > 1:
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
    if Sq >= CHUNKED_Q_THRESHOLD and Sq % 1024 == 0:
        return _sdpa_chunked(q, k, v, causal=causal, window=window,
                             q_offset=q_offset, kv_len=kv_len)
    qf = q.float() / math.sqrt(hd)
    q_pos = torch.arange(Sq, device=q.device)[:, None] + _per_batch(q_offset)
    k_pos = torch.arange(Skv, device=q.device)[None, None, :]
    out = _softmax_attend(qf, k.float(), v.float(),
                          _band(q_pos, k_pos, causal, window, kv_len))
    return out.to(q.dtype)


def flash_attention_plain(q, k, v, *, window: int = 0):
    """The kernel's function in plain PyTorch ops, on any device: causal
    self-attention with no cache, positions from 0."""
    return sdpa(q, k, v, causal=True, window=window, q_offset=0)


def _check_cuda_args(q, k, v, window: int) -> None:
    if q.dim() != 4:
        raise ValueError(f"flash_attention: q must be [B,S,Hq,D], got "
                         f"{tuple(q.shape)}")
    B, S, Hq, D = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[:2] != (B, S) \
            or k.shape[3] != D:
        raise ValueError(f"flash_attention: k and v must be [B,S,Hkv,D] = "
                         f"[{B},{S},Hkv,{D}], got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    Hkv = k.shape[2]
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"flash_attention: Hq={Hq} is not a multiple of "
                         f"Hkv={Hkv}")
    if not 1 <= D <= 256:
        raise ValueError(f"flash_attention: head dim {D} is not in [1, 256]")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device or x.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {x.dtype} on "
                             f"{x.device}, q is {q.dtype} on {q.device}")
        if x.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name}'s last dimension "
                             f"must be contiguous, strides {x.stride()}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash_attention: dtype {q.dtype} is not float32 "
                         f"or bfloat16")
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")


def _form(q, k, v) -> str:
    """The kernel form a CUDA launch takes, from dtype, head dim and
    strides alone: ``"f32"`` for float32; ``"hopper"`` for bf16 with D in
    (64, 128, 256) and every batch, row and head stride of q, k and v a
    positive multiple of 8 elements and every base 16-byte aligned (what
    TMA needs); else ``"mma_sync"``."""
    if q.dtype == torch.float32:
        return "f32"
    legal = q.shape[-1] in _HOPPER_HEAD_DIMS and all(
        x.data_ptr() % 16 == 0 and all(s > 0 and s % 8 == 0
                                       for s in x.stride()[:3])
        for x in (q, k, v))
    return "hopper" if legal else "mma_sync"


def _lib() -> ctypes.CDLL:
    from . import build
    lib = build.load("flash_attention")
    if not getattr(lib, "_typed", False):
        fn = lib.flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + \
            [ctypes.c_int64] * 9 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = lib.flash_attention_hopper_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + \
            [ctypes.c_int64] * 9 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _launch(q, k, v, window: int):
    global LAUNCHES
    _check_cuda_args(q, k, v, window)
    lib = _lib()
    B, S, Hq, D = q.shape
    form = _form(q, k, v)
    out = torch.empty((B, S, Hq, D), dtype=q.dtype, device=q.device)
    strides = [s for x in (q, k, v) for s in x.stride()[:3]]
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if form == "hopper":
            # 1/sqrt(D) and log2(e) in one scale for exp2
            rc = lib.flash_attention_hopper_fwd(
                *ptrs, B, S, Hq, k.shape[2], D, int(window), *strides,
                math.log2(math.e) / math.sqrt(D), stream)
        else:
            # the reference divides by sqrt(hd) as a float32 scalar
            q_div = float(torch.tensor(math.sqrt(D), dtype=torch.float32))
            rc = lib.flash_attention_fwd(
                *ptrs, _DTYPE_CODE[q.dtype], B, S, Hq, k.shape[2], D,
                int(window), *strides, q_div, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed ({form} form): "
                           + lib.flash_attention_error_string(rc).decode())
    LAUNCHES += 1
    LAUNCHES_BY_FORM[form] += 1
    return out


def flash_attention(q, k, v, *, window: int = 0):
    """Causal self-attention in the model's layout: q [B,S,Hq,D], k/v
    [B,S,Hkv,D] (f32 or bf16, last dimension contiguous) -> [B,S,Hq,D] in
    q's dtype; ``window > 0`` keeps the keys j > i - window.

    CPU tensors run the plain version; CUDA tensors launch the kernel in
    the form :func:`_form` picks (and count one launch in ``LAUNCHES`` and
    in ``LAUNCHES_BY_FORM``) or raise.
    An input that requires grad, in grad mode, raises on either device
    (:func:`refuse_grad`)."""
    refuse_grad("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, window=window)
    if q.device.type == "cuda":
        return _launch(q, k, v, window)
    raise ValueError(f"flash_attention: no kernel for device {q.device}")
