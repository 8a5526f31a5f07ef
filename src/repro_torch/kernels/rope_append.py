"""Rotary embedding of a step's queries and keys and the append of its keys
and values to a layer's KV cache, in one launch: a CUDA kernel for Hopper
and its plain PyTorch version.

:func:`rope_append` replaces no TPU kernel: the JAX package leaves RoPE and
the cache write to XLA (``repro/models/layers.py``), which fuses them into
the step's program. The port's plain chain is ``models.layers.rope`` on q
and on k, then ``models.layers.write_rows`` of k and v: 40 launches an
attention layer a decode step, one here. Every cached self-attention layer
of the port takes it under ``use_kernels`` (``layers.attention_apply``),
rotating or, where the layer has no RoPE (Nemotron-H's attention), only
appending. On CUDA tensors it launches ``csrc/rope_append.cu`` (see the
note at the top of that file for its design, its bound on the card and
why its outputs equal the plain chain's there bit for bit); on CPU tensors
it runs :func:`rope_append_plain`. There is no fallback: a CUDA tensor
either reaches the kernel or the call raises.
"""
from __future__ import annotations

import torch

from . import build, refuse_grad

__all__ = ["LAUNCHES", "MAX_HEAD_DIM", "groups", "rope_append",
           "rope_append_plain"]

#: Kernel launches made by this process (plain-version calls do not count).
LAUNCHES = 0

#: Largest head dim the kernel takes (its angles are kept in shared memory,
#: a float each of cos and sin a pair index).
MAX_HEAD_DIM = 256

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def rope_append_plain(q, k, v, ck, cv, positions, pos, theta: float,
                      rotate: bool = True):
    """The kernel's function as the model's plain chain, on any device:
    ``q`` and ``k`` rotated by ``layers.rope`` at ``positions`` (q in place)
    where ``rotate``, then ``layers.write_rows`` of k and v into ``ck`` and
    ``cv`` at ``pos`` (a host int or a 0-d int64 tensor on the caches'
    device). Returns q."""
    # the model's own functions: models.layers imports this package
    from ..models.layers import rope, write_rows
    if rotate:
        q.copy_(rope(q, positions, theta))
        k = rope(k, positions, theta)
    write_rows(ck, pos, k)
    write_rows(cv, pos, v)
    return q


def _vec(hd: int, tensors) -> int:
    """Elements a load: the most of 16 bytes that divides hd / 2 and every
    tensor's address."""
    size = tensors[0].element_size()
    n = 16 // size
    while n > 1 and ((hd // 2) % n or any(
            t.data_ptr() % (n * size) for t in tensors)):
        n //= 2
    return n


def groups(n_heads: int, tokens: int, sms: int) -> int:
    """Blocks a token's ``n_heads`` heads are split over: enough that the
    ``tokens`` tokens' blocks reach ``sms`` (a head a block at batch-1
    decode), one where the tokens alone do (a prefill)."""
    return max(1, min(n_heads, -(-sms // tokens)))


def _check_cuda_args(q, k, v, ck, cv, positions, pos) -> None:
    if q.dim() != 4 or q.dtype not in _DTYPE_CODE:
        raise ValueError(f"rope_append: q must be a float32 or bfloat16 [B, "
                         f"S, Hq, hd] tensor, got {q.dtype} "
                         f"{tuple(q.shape)}")
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2] if k.dim() == 4 else 0
    L = ck.shape[1] if ck.dim() == 4 else 0
    want = {"k": (B, S, Hkv, hd), "v": (B, S, Hkv, hd),
            "ck": (B, L, Hkv, hd), "cv": (B, L, Hkv, hd)}
    for name, t in (("q", q), ("k", k), ("v", v), ("ck", ck), ("cv", cv)):
        if name != "q" and tuple(t.shape) != want[name] or \
                t.dtype != q.dtype or t.device != q.device or \
                not t.is_contiguous():
            raise ValueError(
                f"rope_append: {name} must be a contiguous {q.dtype} "
                f"{want.get(name, '[B, S, Hq, hd]')} tensor on {q.device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if Hkv < 1 or L < 1 or hd % 2 or hd > MAX_HEAD_DIM:
        raise ValueError(f"rope_append: Hkv {Hkv} and the cache's rows {L} "
                         f"must be at least 1 and hd {hd} even, at most "
                         f"{MAX_HEAD_DIM}")
    if tuple(positions.shape) != (B, S) or positions.dtype != torch.int64 \
            or positions.device != q.device:
        raise ValueError(f"rope_append: positions must be [{B}, {S}] int64 "
                         f"on {q.device}, got {positions.dtype} "
                         f"{tuple(positions.shape)} on {positions.device}")
    if isinstance(pos, torch.Tensor):
        if pos.shape != () or pos.dtype != torch.int64 or \
                pos.device != q.device:
            raise ValueError(f"rope_append: a tensor pos must be 0-d int64 "
                             f"on {q.device}, got {pos.dtype} "
                             f"{tuple(pos.shape)} on {pos.device}")
    elif not 0 <= pos <= L - S:
        raise ValueError(f"rope_append: rows {pos} to {pos + S - 1} lie "
                         f"outside the cache's {L}")


def _launch(q, k, v, ck, cv, positions, pos, theta, rotate):
    global LAUNCHES
    _check_cuda_args(q, k, v, ck, cv, positions, pos)
    B, S, Hq, hd = q.shape
    Hkv, L = k.shape[2], ck.shape[1]
    n_heads = Hkv * 2 + (Hq if rotate else 0)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    on_device = isinstance(pos, torch.Tensor)
    build.launch(
        "rope_append", "rope_append_fwd", q.device, q.data_ptr(),
        k.data_ptr(), v.data_ptr(), ck.data_ptr(), cv.data_ptr(),
        positions.data_ptr(), pos.data_ptr() if on_device else None,
        0 if on_device else int(pos), B, S, Hq, Hkv, hd, L,
        positions.stride(0), positions.stride(1), float(theta), int(rotate),
        groups(n_heads, B * S, sms), _vec(hd, (q, k, v, ck, cv)),
        _DTYPE_CODE[q.dtype])
    LAUNCHES += 1
    return q


def rope_append(q, k, v, ck, cv, positions, pos, theta: float,
                rotate: bool = True):
    """Rotate q ``[B, S, Hq, hd]`` in place and write the rotated k and v
    ``[B, S, Hkv, hd]`` into the layer's caches ``ck``, ``cv`` ``[B, L,
    Hkv, hd]`` at rows ``pos`` to ``pos + S - 1``; the angles at
    ``positions [B, S]`` (int64) with base ``theta``. ``rotate=False``
    leaves q as it is and appends k and v unrotated. ``pos`` is a host int
    or a 0-d int64 tensor on the device, read there only. Returns q. All
    five tensors contiguous, of one dtype (float32 or bfloat16); hd even,
    at most 256 (see :func:`rope_append_plain` for the function).

    CPU tensors run the plain version; CUDA tensors launch the kernel (and
    count one launch in ``LAUNCHES``) or raise. Nothing is read back to
    the host, so a CUDA graph may capture the call and replay it at every
    position. An input that requires grad, in grad mode, raises on either
    device (:func:`refuse_grad`)."""
    refuse_grad("rope_append", q, k, v)
    if q.device.type == "cpu":
        return rope_append_plain(q, k, v, ck, cv, positions, pos, theta,
                                 rotate)
    if q.device.type == "cuda":
        return _launch(q, k, v, ck, cv, positions, pos, theta, rotate)
    raise ValueError(f"rope_append: no kernel for device {q.device}")
