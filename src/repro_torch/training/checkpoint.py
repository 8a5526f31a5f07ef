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
    model's ``init_state``), on the template's device; with ``mesh=`` and
    ``specs=`` it loads each leaf whole and distributes it to its spec's
    placements on that ``DeviceMesh`` instead (the reference's
    ``device_put`` with ``NamedSharding``s), whatever mesh it was saved
    from;
  * a state of DTensors (the ZeRO layout) is saved as full logical arrays,
    one leaf at a time: every rank gathers the leaf (``full_tensor()``),
    rank 0 writes it before the next is gathered, and the ranks meet at a
    barrier before ``save`` returns.

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
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor

from .optimizer import TrainState

__all__ = ["MANIFEST", "save", "latest_step", "restore"]

MANIFEST = "manifest.json"


def _leaves(state: TrainState) -> Iterator[Tuple[str, str, torch.Tensor]]:
    """(leaf name, parameter name, tensor) of every master and moment."""
    for name, p in state.params.named_parameters():
        yield "params__" + name.replace(".", "__"), name, p
    for field in ("m", "v"):
        for name, t in getattr(state, field).items():
            yield f"{field}__" + name.replace(".", "__"), name, t


def save(directory: str, step: int, state: TrainState,
         keep_last: int = 3) -> str:
    """Atomically save ``state``; returns the committed path. A state of
    DTensors is saved by every rank of its mesh together (see above), one
    leaf at a time: no rank holds more than one whole leaf at once."""
    final = os.path.join(directory, f"step_{step:08d}")
    sharded = any(isinstance(t, DTensor) for _, _, t in _leaves(state))
    writer = not sharded or dist.get_rank() == 0
    tmp = final + ".tmp"
    manifest = {"step": step, "leaves": []}
    if writer:
        os.makedirs(directory, exist_ok=True)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.save(os.path.join(tmp, "step.npy"), np.asarray(state.step,
                                                           np.int32))
        manifest["leaves"].append({"name": "step", "dtype": "int32",
                                   "shape": []})
    for name, _, t in _leaves(state):
        if isinstance(t, DTensor):
            t = t.full_tensor()         # a collective: every rank takes part
        if writer:
            arr = t.detach().cpu().numpy()
            np.save(os.path.join(tmp, name + ".npy"), arr)
            manifest["leaves"].append({"name": name, "dtype": str(arr.dtype),
                                       "shape": list(arr.shape)})
            del arr
        del t
    if writer:
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)           # atomic commit
        _retain(directory, keep_last)
    if sharded:
        dist.barrier()
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
    shape or dtype differs from the template's raises ``ValueError``.

    With ``mesh`` (a ``DeviceMesh``) and ``specs`` (``{parameter name:
    sharding.P}``, the layout of the masters and of both moments, e.g.
    ``sharding.opt_specs``): each leaf in turn is loaded whole on every
    rank and distributed to its spec's placements (every rank keeps its
    own shard) before the next one loads, and the returned state holds
    those DTensors; ``template`` gives the names, shapes and dtypes only."""
    from ..distributed.sharding import shard

    if (mesh is None) != (specs is None):
        raise ValueError("restore onto a mesh needs both mesh= and specs=")
    src = os.path.join(directory, f"step_{step:08d}")
    placed = {}
    for name, pname, t in _leaves(template):
        arr = np.load(os.path.join(src, name + ".npy"))
        dtype = torch.empty((), dtype=t.dtype).numpy().dtype
        if arr.shape != tuple(t.shape) or arr.dtype != dtype:
            raise ValueError(f"{name}: saved {arr.dtype}{list(arr.shape)}, "
                             f"template {dtype}{list(t.shape)}")
        if mesh is None:
            t.copy_(torch.from_numpy(arr))
        else:                           # placed before the next leaf loads
            placed[name] = shard(torch.from_numpy(arr), mesh, specs[pname])
        del arr
    saved = int(np.load(os.path.join(src, "step.npy")))
    if mesh is None:
        return template._replace(step=saved)

    def place(field: str, pname: str) -> torch.Tensor:
        return placed.pop(f"{field}__" + pname.replace(".", "__"))

    params = template.params
    for pname, p in list(params.named_parameters()):
        owner, _, leaf = pname.rpartition(".")
        mod = params.get_submodule(owner) if owner else params
        setattr(mod, leaf, nn.Parameter(place("params", pname),
                                        requires_grad=p.requires_grad))
    return TrainState(step=saved, params=params,
                      m={n: place("m", n) for n in template.m},
                      v={n: place("v", n) for n in template.v})
