"""The Mamba-2 SSD chunked scan: a CUDA kernel for Hopper and its plain
PyTorch version.

:func:`ssd_scan` is the port of the TPU kernel
``repro/kernels/ssd_scan.py::ssd_scan_pallas`` (body ``_ssd_kernel``)
behind ``repro/kernels/ops.py::ssd_scan``. On CUDA tensors it launches
``csrc/ssd_scan.cu`` (bf16, the serving path: two kernels, the chunk
states walked in order with the state on chip, then the outputs with
``C B^T`` shared by a group of heads; f32: four passes; see the note at
the top of that file for the design and its bound on the card); on CPU
tensors it runs
:func:`ssd_scan_plain`, which is also the model's branch when the kernels
are off (the port of ``repro/models/mamba2.py::ssd_reference``). There is
no fallback: a CUDA tensor either reaches the kernel or the call raises.

Unlike the TPU kernel, which visits only ``l // min(chunk, l)`` whole
chunks, both versions take any length: the plain version shrinks the chunk
to a divisor of ``l`` as the reference does, the kernel keeps ``chunk`` and
runs a short last chunk. The result is the same up to rounding.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import refuse_grad

__all__ = ["LAUNCHES", "MAX_BF16_STATE", "MAX_CHUNK", "release_scratch",
           "ssd_scan", "ssd_scan_plain"]

#: Kernel launches made by this process (plain-version calls do not count).
LAUNCHES = 0

#: The largest chunk the kernel takes (its shared-memory tiles hold one
#: chunk's log-decays).
MAX_CHUNK = 256

#: The widest state (n) of a bf16 call: the output kernel holds 64 rows of
#: C and of B, n wide, in shared memory (``ssd_scan_bf16_max_state()`` in
#: the source says the same).
MAX_BF16_STATE = 256

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# One scratch buffer per device, kept from call to call and grown when a
# call needs more (the chunk states, 86 MB at Mamba-2's serving shape), until
# release_scratch() frees it (the serve engine calls it when its last
# Mamba-2 endpoint unloads). Calls on one device share it, so they must run
# on one stream. Growing it frees the old buffer: a CUDA graph captured
# before a call that grew it points at freed memory and must be captured
# again.
_SCRATCH: dict = {}


def _effective_chunk(l: int, chunk: int) -> int:
    c = min(chunk, l)
    while l % c:
        c -= 1
    return max(c, 1)


def ssd_scan_plain(x, dt, A, B, C, chunk: int, initial_state=None):
    """The chunked SSD scan in f32.

    x [b, l, h, p], dt [b, l, h] (positive steps), A [h] (negative rates),
    B and C [b, l, n] (shared by the heads); ``initial_state`` [b, h, n, p]
    is the state before step 0 (zero if None). Returns (y [b, l, h, p],
    final state [b, h, n, p]), both f32. Within a chunk of Q tokens
    ``y_i = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j`` with
    ``cum`` the running sum of ``dt A``; across chunks a ``[h, n, p]``
    state is carried."""
    x, dt, A, B, C = (v.float() for v in (x, dt, A, B, C))
    b, l, h, p = x.shape
    n = B.shape[-1]
    q = _effective_chunk(l, chunk)
    nc = l // q
    xb = x.reshape(b, nc, q, h, p)
    dtb = dt.reshape(b, nc, q, h)
    Bb = B.reshape(b, nc, q, n)
    Cb = C.reshape(b, nc, q, n)

    cum = torch.cumsum(dtb * A, dim=2)                    # [b,nc,q,h]
    # intra-chunk: M[i,j] = C_i . B_j * exp(cum_i - cum_j) * dt_j (j <= i)
    CB = torch.einsum("bcin,bcjn->bcij", Cb, Bb)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # [b,nc,i,j,h]
    causal = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    # masked before the exp: exp(seg) of the upper triangle overflows to
    # inf, and masking after it leaves inf * 0 = NaN in the backward (the
    # reference's order, ROADMAP Queue C); the values are the same
    decay = torch.exp(torch.where(causal[:, :, None], seg, -math.inf))
    M = CB[..., None] * decay
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", M, xb * dtb[..., None])

    # chunk-local states: S_c = sum_j exp(cum_last - cum_j) dt_j B_j x_j
    last = cum[:, :, -1:, :]
    w = torch.exp(last - cum) * dtb                       # [b,nc,q,h]
    S_loc = torch.einsum("bcjn,bcjhp->bchnp", Bb, xb * w[..., None])

    # inter-chunk recurrence, emitting the state entering each chunk
    chunk_decay = torch.exp(last[:, :, 0, :])             # [b,nc,h]
    S = (torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.float())
    S_in = []
    for c in range(nc):
        S_in.append(S)
        S = S * chunk_decay[:, c, :, None, None] + S_loc[:, c]
    S_in = torch.stack(S_in, dim=1)                       # [b,nc,h,n,p]
    y_inter = torch.einsum("bcin,bchnp->bcihp", Cb, S_in) * \
        torch.exp(cum)[..., None]
    return (y_intra + y_inter).reshape(b, l, h, p), S


def _check_cuda_args(x, dt, A, B, C, chunk, initial_state) -> None:
    """Raise ``ValueError`` on what the kernel does not take."""
    if x.dim() != 4:
        raise ValueError(f"ssd_scan: x must be [b, l, h, p], got "
                         f"{tuple(x.shape)}")
    b, l, h, p = x.shape
    if min(b, l, h, p) < 1:
        raise ValueError(f"ssd_scan: empty shape {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"ssd_scan: x must be float32 or bfloat16, got "
                         f"{x.dtype}")
    if B.dim() != 3 or B.shape[:2] != (b, l) or B.shape != C.shape \
            or B.shape[2] < 1:
        raise ValueError(f"ssd_scan: B {tuple(B.shape)} and C "
                         f"{tuple(C.shape)} must both be [b, l, n] with "
                         f"(b, l) = {(b, l)}")
    if B.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError(f"ssd_scan: x, B and C must share a dtype, got "
                         f"{x.dtype}, {B.dtype}, {C.dtype}")
    if tuple(dt.shape) != (b, l, h) or dt.dtype != torch.float32:
        raise ValueError(f"ssd_scan: dt must be float32 {(b, l, h)}, got "
                         f"{dt.dtype} {tuple(dt.shape)}")
    if tuple(A.shape) != (h,) or A.dtype != torch.float32:
        raise ValueError(f"ssd_scan: A must be float32 {(h,)}, got "
                         f"{A.dtype} {tuple(A.shape)}")
    for name, t in (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C)):
        if t.stride(-1) != 1 and t.shape[-1] > 1:
            raise ValueError(f"ssd_scan: the last dimension of {name} must "
                             f"be contiguous, got strides {t.stride()}")
    if initial_state is not None and (
            tuple(initial_state.shape) != (b, h, B.shape[2], p)
            or initial_state.dtype != torch.float32
            or not initial_state.is_contiguous()):
        raise ValueError(f"ssd_scan: initial_state must be a contiguous "
                         f"float32 {(b, h, B.shape[2], p)}, got "
                         f"{initial_state.dtype} "
                         f"{tuple(initial_state.shape)}")
    devices = {t.device for t in (x, dt, A, B, C)}
    if initial_state is not None:
        devices.add(initial_state.device)
    if len(devices) != 1:
        raise ValueError(f"ssd_scan: inputs on several devices {devices}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"ssd_scan: chunk must be in [1, {MAX_CHUNK}], "
                         f"got {chunk}")
    if x.dtype == torch.bfloat16 and B.shape[2] > MAX_BF16_STATE:
        raise ValueError(f"ssd_scan: a bf16 state is at most "
                         f"{MAX_BF16_STATE} wide, got n = {B.shape[2]}")


def _lib() -> ctypes.CDLL:
    from . import build
    lib = build.load("ssd_scan")
    if not getattr(lib, "_typed", False):
        i32, i64, ptr = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
        lib.ssd_scan_scratch_bytes.argtypes = [i32] * 7
        lib.ssd_scan_scratch_bytes.restype = i64
        lib.ssd_scan_bf16_max_state.argtypes = []
        lib.ssd_scan_bf16_max_state.restype = i32
        lib.ssd_scan_fwd.argtypes = [ptr] * 9 + [i32] * 7 + [i64] * 9 + [ptr]
        lib.ssd_scan_fwd.restype = i32
        lib.ssd_scan_error_string.argtypes = [i32]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _scratch(dev, nbytes: int) -> torch.Tensor:
    buf = _SCRATCH.get(dev)
    if buf is None or buf.numel() < nbytes:
        _SCRATCH.pop(dev, None)
        buf = _SCRATCH[dev] = torch.empty(max(nbytes, 16), dtype=torch.uint8,
                                          device=dev)
    return buf


def release_scratch(device=None) -> None:
    """Free the scratch kept for ``device`` (every device's when None); the
    next call makes it anew."""
    dev = None if device is None else torch.device(device)
    for key in list(_SCRATCH):
        if dev is None or (key.type == dev.type
                           and dev.index in (None, key.index)):
            del _SCRATCH[key]


def _launch(x, dt, A, B, C, chunk, initial_state):
    global LAUNCHES
    _check_cuda_args(x, dt, A, B, C, chunk, initial_state)
    lib = _lib()
    b, l, h, p = x.shape
    n = B.shape[2]
    dev = x.device
    y = torch.empty((b, l, h, p), dtype=x.dtype, device=dev)
    final = torch.empty((b, h, n, p), dtype=torch.float32, device=dev)
    scratch = _scratch(dev, lib.ssd_scan_scratch_bytes(
        _DTYPES[x.dtype], b, l, h, p, n, chunk))
    init_ptr = 0 if initial_state is None else initial_state.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.ssd_scan_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), init_ptr, y.data_ptr(), final.data_ptr(),
            scratch.data_ptr(), _DTYPES[x.dtype], b, l, h, p, n, chunk,
            x.stride(0), x.stride(1), x.stride(2), dt.stride(0),
            dt.stride(1), B.stride(0), B.stride(1), C.stride(0), C.stride(1),
            stream)
    if rc != 0:
        raise RuntimeError("ssd_scan launch failed: "
                           + lib.ssd_scan_error_string(rc).decode())
    LAUNCHES += 1
    return y, final


def ssd_scan(x, dt, A, B, C, *, chunk: int = 256, initial_state=None):
    """x [b, l, h, p] (f32 or bf16), dt [b, l, h] f32, A [h] f32, B and C
    [b, l, n] in x's dtype (each read through its strides, the last
    dimension contiguous), ``initial_state`` None or [b, h, n, p] f32 ->
    (y [b, l, h, p] in x's dtype, final state [b, h, n, p] f32).

    CPU tensors run the plain version; CUDA tensors launch the kernel (and
    count one launch in ``LAUNCHES``) or raise.
    An input that requires grad, in grad mode, raises on either device
    (:func:`refuse_grad`)."""
    refuse_grad("ssd_scan", x, dt, A, B, C, initial_state)
    if x.device.type == "cpu":
        y, final = ssd_scan_plain(x, dt, A, B, C, chunk, initial_state)
        return y.to(x.dtype), final
    if x.device.type == "cuda":
        return _launch(x, dt, A, B, C, chunk, initial_state)
    raise ValueError(f"ssd_scan: no kernel for device {x.device}")
