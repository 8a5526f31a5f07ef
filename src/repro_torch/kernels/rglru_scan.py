"""The RG-LRU linear recurrence: a CUDA kernel for Hopper and its plain
PyTorch version.

:func:`rglru_scan` is the port of the TPU kernel
``repro/kernels/rglru_scan.py::rglru_scan_pallas`` (body ``_rglru_kernel``)
behind ``repro/kernels/ops.py::rglru_scan``. On CUDA tensors it launches
``csrc/rglru_scan.cu`` (one pass: a block per batch row and 32 channels
walks the whole of L, the inputs read and h written once; see the note at
the top of that file for its design and its bound on the card); on CPU
tensors it runs :func:`rglru_scan_plain`, which is also the model's branch
when the kernels are off (the port of
``repro/models/rglru.py::rglru_scan_ref``).
There is no fallback: a CUDA tensor either reaches the kernel or the call
raises.
"""
from __future__ import annotations

import torch

from . import build, refuse_grad

__all__ = ["LAUNCHES", "LAUNCHES_BY_FORM", "CHUNK", "rglru_scan",
           "rglru_scan_plain"]

#: Kernel launches made by this process (plain-version calls do not count).
LAUNCHES = 0

#: The same launches by form: ``vec4`` (16-byte loads and stores along d)
#: or ``scalar``.
LAUNCHES_BY_FORM = {"vec4": 0, "scalar": 0}

#: Time steps per tile of the kernel's scan (``kTile`` in
#: ``csrc/rglru_scan.cu``): the carry crosses from one chunk of CHUNK steps
#: to the next.
CHUNK = 128


def rglru_scan_plain(x_gated, a, h0=None):
    """h_t = a_t * h_{t-1} + b_t with b = sqrt(max(1 - a^2, 0)) * x_gated.

    x_gated, a [B, L, D]; ``h0`` [B, D] is the state before step 0 (zero if
    None). Returns (h [B, L, D], h_last [B, D]). A log-step (Hillis-Steele)
    doubling over the (a, b) semigroup along time, as
    ``jax.lax.associative_scan`` evaluates it in the reference."""
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=0.0)) * x_gated
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    acc_a, acc_b = a, b
    L, s = a.shape[1], 1
    while s < L:
        # (a_l, b_l) then (a_r, b_r) -> (a_l a_r, a_r b_l + b_r)
        acc_b = torch.cat([acc_b[:, :s],
                           acc_a[:, s:] * acc_b[:, :-s] + acc_b[:, s:]], dim=1)
        acc_a = torch.cat([acc_a[:, :s], acc_a[:, s:] * acc_a[:, :-s]], dim=1)
        s *= 2
    return acc_b, acc_b[:, -1]


def _check_cuda_args(b_in, a) -> None:
    for name, x in (("b_in", b_in), ("a", a)):
        if x.dim() != 3 or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"rglru_scan: {name} must be a contiguous "
                             f"float32 [B, L, D] tensor, got {x.dtype} "
                             f"{tuple(x.shape)}")
    if b_in.shape != a.shape or b_in.device != a.device:
        raise ValueError(f"rglru_scan: b_in {tuple(b_in.shape)} on "
                         f"{b_in.device} and a {tuple(a.shape)} on "
                         f"{a.device} differ")
    if min(a.shape) < 1:
        raise ValueError(f"rglru_scan: empty shape {tuple(a.shape)}")


def _form(D: int, *data_ptrs: int) -> str:
    """The kernel's form for width ``D`` and the tensors' addresses:
    ``vec4`` where D is a multiple of 4 and every address 16-byte aligned
    (each thread then loads and stores 4 channels at once), else
    ``scalar``. Both forms are the same kernel, chosen before the launch."""
    if D % 4 == 0 and all(p % 16 == 0 for p in data_ptrs):
        return "vec4"
    return "scalar"


def _launch(b_in, a):
    global LAUNCHES
    _check_cuda_args(b_in, a)
    B, L, D = a.shape
    h = torch.empty_like(b_in)
    h_last = torch.empty((B, D), dtype=b_in.dtype, device=b_in.device)
    form = _form(D, b_in.data_ptr(), a.data_ptr(), h.data_ptr(),
                 h_last.data_ptr())
    build.launch("rglru_scan", "rglru_scan_fwd", a.device, b_in.data_ptr(),
                 a.data_ptr(), h.data_ptr(), h_last.data_ptr(), B, L, D,
                 4 if form == "vec4" else 1)
    LAUNCHES += 1
    LAUNCHES_BY_FORM[form] += 1
    return h, h_last


def rglru_scan(b_in, a):
    """The recurrence over b_in (gated input) and a (decay), [B, L, D]
    float32 contiguous -> (h [B, L, D], h_last [B, D]).

    CPU tensors run the plain version; CUDA tensors launch the kernel (and
    count one launch in ``LAUNCHES``) or raise.
    An input that requires grad, in grad mode, raises on either device
    (:func:`refuse_grad`)."""
    refuse_grad("rglru_scan", b_in, a)
    if a.device.type == "cpu":
        return rglru_scan_plain(b_in, a)
    if a.device.type == "cuda":
        return _launch(b_in, a)
    raise ValueError(f"rglru_scan: no kernel for device {a.device}")
