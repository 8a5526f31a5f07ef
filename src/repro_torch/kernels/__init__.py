"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (the CPU path and the card's parity target).

Each kernel's module counts the launches this process made in its
``LAUNCHES`` (and, where it keeps one, by form in ``LAUNCHES_BY_FORM``).
A CUDA graph's replay makes no Python call, so whoever replays a graph of
the model kernels (:data:`MODEL_KERNELS`) takes back what its capture
counted, since nothing ran then, and adds it once a replay
(:func:`launch_counts`, :func:`add_launches`)."""
from __future__ import annotations

import torch

__all__ = ["MODEL_KERNELS", "add_launches", "launch_counts", "refuse_grad"]


def refuse_grad(name: str, *tensors) -> None:
    """Raise ``RuntimeError`` when autograd would differentiate through the
    model kernel ``name``: grad mode is on and an input requires grad.

    The kernels are bound through ctypes and have no backward, so their
    outputs would leave the graph and every weight feeding them would get
    no gradient, with no error. The reference cannot differentiate its
    Pallas path either; it trains with ``use_kernels=False``. Checked before
    the device dispatch, so the CPU (plain version) refuses as the card
    does; ``torch.no_grad()`` and ``torch.inference_mode()`` (serving) pass.
    """
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the kernel has no backward and would cut the autograd "
            f"graph; train through the plain branches (use_kernels=False) "
            f"or call it under torch.no_grad()/torch.inference_mode()")


# after refuse_grad: each of them imports it from here
from . import (decode_attention, expert_gather,  # noqa: E402
               flash_attention, rglru_scan, rope_append, ssd_scan)

#: The modules of the kernels a model's step launches.
MODEL_KERNELS = (flash_attention, decode_attention, rglru_scan, ssd_scan,
                 expert_gather, rope_append)


def launch_counts(since=None) -> list:
    """Each of :data:`MODEL_KERNELS`' launches as ``(LAUNCHES, {form:
    launches})``, in that order; with ``since`` (an earlier result of
    this), those made after it."""
    now = [(m.LAUNCHES, dict(getattr(m, "LAUNCHES_BY_FORM", {})))
           for m in MODEL_KERNELS]
    if since is None:
        return now
    return [(n1 - n0, {f: c - f0[f] for f, c in f1.items()})
            for (n0, f0), (n1, f1) in zip(since, now)]


def add_launches(counts, sign: int = 1) -> None:
    """Add ``sign`` times ``counts`` (a :func:`launch_counts` result) to
    :data:`MODEL_KERNELS`' counters."""
    for m, (n, forms) in zip(MODEL_KERNELS, counts):
        m.LAUNCHES += sign * n
        for form, c in forms.items():
            m.LAUNCHES_BY_FORM[form] += sign * c
