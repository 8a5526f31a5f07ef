"""Checkpointing with atomic commit and retention (the port of
``repro/training/checkpoint.py``).

  * every leaf of the train state (``step``, and each parameter's master,
    first and second moment) is saved as a raw ``.npy`` under a
    ``step_<n>.tmp`` directory, which is renamed to ``step_<n>`` only
    after every leaf and the manifest are written: a crash mid-save never
    corrupts the latest checkpoint;
  * the manifest records each leaf's name, dtype and shape;
  * ``keep_last`` retention prunes old steps after a successful commit;
  * ``restore`` loads into the tensors of a template state (the same
    model's ``init_state``), on the template's device. Re-sharding onto
    another mesh (the reference's ``mesh=``/``specs=``) comes with the
    multi-device layers (ROADMAP Queue A item 6) and raises here.

Leaf names join the dotted parameter name's parts with ``__`` under the
state's field (``params__layers__0__attn__wq__w``, ``m__...``, ``v__...``),
as the reference joins its pytree paths.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from .optimizer import TrainState

__all__ = ["MANIFEST", "save", "latest_step", "restore"]

MANIFEST = "manifest.json"


def _leaves(state: TrainState) -> Iterator[Tuple[str, torch.Tensor]]:
    for name, p in state.params.named_parameters():
        yield "params__" + name.replace(".", "__"), p
    for field in ("m", "v"):
        for name, t in getattr(state, field).items():
            yield f"{field}__" + name.replace(".", "__"), t


def save(directory: str, step: int, state: TrainState,
         keep_last: int = 3) -> str:
    """Atomically save ``state``; returns the committed path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": []}
    leaves = [("step", np.asarray(state.step, np.int32))]
    leaves += [(name, t.detach().cpu().numpy()) for name, t in _leaves(state)]
    for name, arr in leaves:
        np.save(os.path.join(tmp, name + ".npy"), arr)
        manifest["leaves"].append({"name": name, "dtype": str(arr.dtype),
                                   "shape": list(arr.shape)})
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)           # atomic commit
    _retain(directory, keep_last)
    return final


def _retain(directory: str, keep_last: int) -> None:
    steps = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep_last]:
        shutil.rmtree(os.path.join(directory, d))


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(directory, d, MANIFEST))]
    return max(steps) if steps else None


@torch.no_grad()
def restore(directory: str, step: int, template: TrainState, *, mesh=None,
            specs=None) -> TrainState:
    """The state saved at ``step``, loaded into ``template``'s tensors (in
    place, on their devices) and returned with the saved step. A leaf whose
    shape or dtype differs from the template's raises ``ValueError``."""
    if mesh is not None or specs is not None:
        raise NotImplementedError(
            "restore onto a mesh (mesh=, specs=) comes with the multi-device "
            "layers, ROADMAP Queue A item 6")
    src = os.path.join(directory, f"step_{step:08d}")
    for name, t in _leaves(template):
        arr = np.load(os.path.join(src, name + ".npy"))
        dtype = torch.empty((), dtype=t.dtype).numpy().dtype
        if arr.shape != tuple(t.shape) or arr.dtype != dtype:
            raise ValueError(f"{name}: saved {arr.dtype}{list(arr.shape)}, "
                             f"template {dtype}{list(t.shape)}")
        t.copy_(torch.from_numpy(arr))
    saved = int(np.load(os.path.join(src, "step.npy")))
    return template._replace(step=saved)
