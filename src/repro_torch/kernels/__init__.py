"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (the CPU path and the card's parity target)."""
from __future__ import annotations

import torch

__all__ = ["refuse_grad"]


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
