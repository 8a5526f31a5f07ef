"""The MoE layer's experts on the chosen (token, expert) pairs only: a CUDA
kernel for Hopper and its plain PyTorch version.

:func:`expert_gather` replaces no TPU kernel: the JAX package leaves the MoE
layer to XLA (``repro/models/moe.py``'s dispatch and combine einsums over
every expert). It serves the one-token decode step of both MoE layers of
the port (``models/moe.py``: GShard's SwiGLU experts, ``"swiglu"``, and the
dropless layer's relu² held experts, ``"relu2"``), where the dense products
read every expert's weights for a token that chose k of them. On CUDA
tensors it launches ``csrc/expert_gather.cu`` (see the note at the top of
that file for its design and its bound on the card); on CPU tensors it
runs :func:`expert_gather_plain`. There is no fallback: a CUDA tensor
either reaches the kernel or the call raises.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import build, refuse_grad

__all__ = ["LAUNCHES", "LAUNCHES_BY_FORM", "expert_gather",
           "expert_gather_plain", "splits"]

#: Kernel calls made by this process (plain-version calls do not count);
#: a call is the kernel's three launches.
LAUNCHES = 0

#: The same calls by form: ``swiglu`` (``wg`` given) or ``relu2``.
LAUNCHES_BY_FORM = {"swiglu": 0, "relu2": 0}

#: A pass's reduction rows are split until one live pair's blocks (column
#: tiles x splits) cover the SMs, each split keeping at least
#: MIN_SPLIT_ROWS rows and at most MAX_SPLIT_ROWS (its vector is kept in
#: shared memory). Which pairs are live is known on the card only, and a
#: dead pair's blocks return at once, so the grid is sized for the fewest:
#: on an H100 a lone live pair of Nemotron-3-Nano's took 12.8 us a call so
#: sized, 21.5 sized for its 6 pairs; OLMoE's 8 live pairs 46.7 against 44.7.
MIN_SPLIT_ROWS = 256
MAX_SPLIT_ROWS = 4096

_LANES = 8                              # threads across a tile's row
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_FORM_CODE = {"swiglu": 0, "relu2": 1}


def _live(ids, w, n_experts):
    return (w != 0) & (ids >= 0) & (ids < n_experts)


def expert_gather_plain(x, ids, w, wi, wg, wo):
    """The kernel's function in plain PyTorch ops, on any device: tokens x
    ``[T, D]``, choices ``ids [T, k]`` (int64) with combine weights ``w [T,
    k]``, experts ``wi`` (and ``wg``, None for the relu² form) ``[E, D, F]``
    and ``wo [E, F, D]`` -> ``y [T, D]`` in x's dtype. Gathers each chosen
    expert's matrices and multiplies in f32; ``h = silu(x wg) * (x wi)``
    (or ``relu(x wi)^2``) is rounded to x's dtype before the down product
    and the k weighted terms are summed in f32. A pair whose weight is 0 or
    whose id lies outside ``[0, E)`` adds nothing, whatever its expert's
    weights hold."""
    live = _live(ids, w, wi.shape[0])
    e = torch.where(live, ids, torch.zeros_like(ids))
    xf = x.float()[:, None, None, :]                             # [T,1,1,D]
    u = torch.matmul(xf, wi[e].float())[..., 0, :]                # [T,k,F]
    if wg is None:
        h = torch.square(F.relu(u))
    else:
        h = F.silu(torch.matmul(xf, wg[e].float())[..., 0, :]) * u
    h = h.to(x.dtype).float()
    ye = torch.matmul(h[..., None, :], wo[e].float())[..., 0, :]  # [T,k,D]
    y = torch.where(live[..., None], w.float()[..., None] * ye, 0.0)
    return y.sum(1).to(x.dtype)


def splits(tiles: int, rows: int, sms: int) -> int:
    """How many splits of ``rows`` reduction rows a pass of ``tiles``
    column tiles takes a pair: doubled from the fewest that keep a split
    within MAX_SPLIT_ROWS until a pair's blocks reach ``sms`` or a split
    would fall under MIN_SPLIT_ROWS rows."""
    s = -(-rows // MAX_SPLIT_ROWS)
    while tiles * s < sms and -(-rows // (2 * s)) >= MIN_SPLIT_ROWS:
        s *= 2
    return s


def _check_cuda_args(x, ids, w, wi, wg, wo) -> None:
    if x.dim() != 2 or x.dtype not in _DTYPE_CODE:
        raise ValueError(f"expert_gather: x must be a float32 or bfloat16 "
                         f"[T, D] tensor, got {x.dtype} {tuple(x.shape)}")
    T, D = x.shape
    if wi.dim() != 3 or wi.shape[1] != D:
        raise ValueError(f"expert_gather: wi must be [E, {D}, F], got "
                         f"{tuple(wi.shape)}")
    E, _, Fe = wi.shape
    want = {"wi": (E, D, Fe), "wg": (E, D, Fe), "wo": (E, Fe, D)}
    for name, t in (("wi", wi), ("wg", wg), ("wo", wo)):
        if t is None:
            continue
        if tuple(t.shape) != want[name] or t.dtype != x.dtype \
                or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"expert_gather: {name} must be a contiguous "
                             f"{x.dtype} {want[name]} tensor on {x.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if ids.dim() != 2 or ids.shape[0] != T or tuple(w.shape) != tuple(
            ids.shape) or ids.device != x.device or w.device != x.device:
        raise ValueError(f"expert_gather: ids and w must be [{T}, k] on "
                         f"{x.device}, got {tuple(ids.shape)} on "
                         f"{ids.device} and {tuple(w.shape)} on {w.device}")
    vec = 16 // x.element_size()
    if D % vec or Fe % vec:
        raise ValueError(f"expert_gather: D {D} and F {Fe} must be "
                         f"multiples of {vec} ({x.dtype})")
    ptrs = [t.data_ptr() for t in (x, wi, wg, wo) if t is not None]
    if not x.is_contiguous() or any(p % 16 for p in ptrs):
        raise ValueError("expert_gather: x must be contiguous and every "
                         "tensor 16-byte aligned")


def _launch(x, ids, w, wi, wg, wo):
    global LAUNCHES
    _check_cuda_args(x, ids, w, wi, wg, wo)
    ids = ids.to(torch.int64).contiguous()
    w = w.to(torch.float32).contiguous()
    T, D = x.shape
    k = ids.shape[1]
    E, _, Fe = wi.shape
    form = "relu2" if wg is None else "swiglu"
    mats = 1 if wg is None else 2
    cols = _LANES * (16 // x.element_size())
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    up_splits = splits(-(-Fe // cols), D, sms)
    dn_splits = splits(-(-D // cols), Fe, sms)
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty((T, D), dtype=x.dtype, device=x.device)
    up = torch.empty(T * k * up_splits * mats * Fe, **f32)
    dn = torch.empty(T * k * dn_splits * D, **f32)
    build.launch(
        "expert_gather", "expert_gather_fwd", x.device, x.data_ptr(),
        ids.data_ptr(), w.data_ptr(), wi.data_ptr(),
        None if wg is None else wg.data_ptr(), wo.data_ptr(), y.data_ptr(),
        up.data_ptr(), dn.data_ptr(), T, k, E, D, Fe, up_splits, dn_splits,
        _DTYPE_CODE[x.dtype], _FORM_CODE[form], form=form)
    LAUNCHES += 1
    LAUNCHES_BY_FORM[form] += 1
    return y


def expert_gather(x, ids, w, wi, wg, wo):
    """The routed term of an MoE layer over its chosen pairs only: tokens
    x ``[T, D]`` (float32 or bfloat16), choices ``ids [T, k]`` (int64, read
    on the device) with combine weights ``w [T, k]`` (0: skip the pair),
    experts ``wi``, ``wg`` ``[E, D, F]`` (``wg`` None: the relu² form) and
    ``wo [E, F, D]`` in x's dtype -> ``y [T, D]`` in x's dtype (see
    :func:`expert_gather_plain` for the function and its roundings).

    CPU tensors run the plain version; CUDA tensors launch the kernel (and
    count one call in ``LAUNCHES`` and in ``LAUNCHES_BY_FORM``) or raise.
    Nothing is read back to the host, so a CUDA graph may capture the call.
    An input that requires grad, in grad mode, raises on either device
    (:func:`refuse_grad`)."""
    refuse_grad("expert_gather", x, w, wi, wg, wo)
    if x.device.type == "cpu":
        return expert_gather_plain(x, ids, w, wi, wg, wo)
    if x.device.type == "cuda":
        return _launch(x, ids, w, wi, wg, wo)
    raise ValueError(f"expert_gather: no kernel for device {x.device}")
