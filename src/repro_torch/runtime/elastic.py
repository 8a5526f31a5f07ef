"""Elastic scaling: re-shard a checkpoint onto a different mesh (the port
of ``repro/runtime/elastic.py``).

When a pod is lost (or gained) the job must resume on a different device
count. Checkpoints are saved as full logical arrays (per-leaf ``.npy`` +
manifest), so restoring onto a new mesh is distributing each leaf to the
placements of freshly derived specs: :func:`resharded_restore` packages
that and :func:`verify_roundtrip` validates the round trip numerically.
"""
from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..distributed import sharding as shd
from ..training import checkpoint as ckpt
from ..training.optimizer import TrainState

__all__ = ["resharded_restore", "verify_roundtrip"]


def resharded_restore(directory: str, step: int, template: TrainState,
                      new_mesh, cfg: Optional[ModelConfig] = None
                      ) -> TrainState:
    """Restore a checkpoint onto the ``DeviceMesh`` ``new_mesh`` in the
    ZeRO layout derived for it (``sharding.opt_specs``)."""
    specs = shd.opt_specs(template.params, new_mesh, cfg)
    return ckpt.restore(directory, step, template, mesh=new_mesh,
                        specs=specs)


def _leaves(state: TrainState) -> Iterator[torch.Tensor]:
    yield torch.as_tensor(state.step)
    for _, p in state.params.named_parameters():
        yield p
    for field in (state.m, state.v):
        yield from field.values()


def verify_roundtrip(state_a: TrainState, state_b: TrainState,
                     atol: float = 0.0) -> bool:
    """Equality of two states leaf for leaf, whatever their meshes, as the
    reference checks it: ``np.allclose(a, b, atol=atol)`` on the full
    logical arrays (numpy's default rtol of 1e-5 included)."""
    leaves_a, leaves_b = list(_leaves(state_a)), list(_leaves(state_b))
    if len(leaves_a) != len(leaves_b):
        return False
    for a, b in zip(leaves_a, leaves_b):
        a, b = (shd.full(t.detach()).cpu().numpy() for t in (a, b))
        if a.shape != b.shape or not np.allclose(a, b, atol=atol):
            return False
    return True
