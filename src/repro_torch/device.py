"""Where the port's engines run: the card unless the caller asks otherwise."""
from __future__ import annotations

from typing import Union

import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device"]

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Union[None, str, torch.device] = None
                   ) -> torch.device:
    """``device`` as a ``torch.device`` (``None`` means ``"cuda"``).

    Asking for CUDA where there is none raises ``RuntimeError``: a run never
    falls back to the CPU without being told to."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was asked for but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run on the CPU")
    return dev
