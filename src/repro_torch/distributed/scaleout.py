"""Data-parallel scale-out of the app axis: the port of
``repro/distributed/scaleout.py`` (with ``launch/mesh.py::make_app_mesh``).

Every app's simulation is independent, so the app axis is embarrassingly
parallel. The sweep engines (:mod:`repro_torch.core.simulator`) and the
cluster engine's phase B (:mod:`repro_torch.serving.cluster_vector`) split
each chunk's app rows across an ordered list of devices (the "mesh") and
run the single-device program on each slice.

Bit-identity contract (``tests/test_torch_scaleout.py``):

  * each shard runs exactly the single-device program on a row slice — no
    collectives, no cross-app reductions inside any engine scan (per-config
    totals are accumulated on the host in float64, unchanged);
  * shard outputs are concatenated in mesh order, so the assembled arrays
    are the single-device arrays element for element;
  * app counts not divisible by the mesh size are padded by
    :func:`pad_app_rows` with ``+inf`` timestamps, which every scan masks
    with ``isfinite``; they contribute zero to every accumulator and are
    sliced off the outputs.

The knob is ``EngineOptions(devices=...)``: ``None`` keeps the engines'
single-device paths untouched; an int ``k`` always takes the sharded path
(``k=1`` exercises it on one device): ``cuda:0..k-1`` on the card, or ``k``
shards run one after another on the CPU (how the CPU tests cover ``k >
1``); ``"auto"`` shards over every card, collapsing to the single-device
path where there is one card or the engine runs on the CPU.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

__all__ = ["APP_AXIS", "mesh_for", "pad_app_rows", "shard_along_apps"]

#: The one mesh axis the engines shard over.
APP_AXIS = "apps"

Mesh = List[torch.device]


def mesh_for(devices: Union[None, int, str],
             device: Union[str, torch.device]) -> Optional[Mesh]:
    """Resolve an ``EngineOptions.devices`` knob into the ordered devices
    the app rows split across, or ``None`` (the single-device path).

    ``device`` is the engine's device. On CUDA an int ``k`` gives
    ``cuda:0..k-1`` and raises ``RuntimeError`` when ``k`` exceeds
    ``torch.cuda.device_count()``; on the CPU it gives ``k`` CPU shards.
    ``"auto"`` gives every card when there are several, else ``None``."""
    if devices is None:
        return None
    dev = torch.device(device)
    if isinstance(devices, str):
        if devices != "auto":
            raise ValueError(f"devices must be None, an int, or 'auto'; "
                             f"got {devices!r}")
        if dev.type == "cuda" and torch.cuda.device_count() > 1:
            return _cards(torch.cuda.device_count())
        return None
    if isinstance(devices, bool) or not isinstance(devices,
                                                   (int, np.integer)):
        raise ValueError(f"devices must be None, an int, or 'auto'; got "
                         f"{devices!r}")
    k = int(devices)
    if k < 1:
        raise ValueError(f"an app mesh needs at least one device, got "
                         f"devices={devices!r}")
    if dev.type == "cuda":
        return _cards(k)
    return [dev] * k


def _cards(k: int) -> Mesh:
    have = torch.cuda.device_count()
    if k > have:
        raise RuntimeError(
            f"devices={k} requested but torch.cuda.device_count() is {have}; "
            f"pass devices<={have}, or run on the CPU (EngineOptions("
            f"device='cpu')), where {k} shards run one after another")
    return [torch.device("cuda", i) for i in range(k)]


def pad_app_rows(arr: np.ndarray, multiple: int,
                 fill: float = np.inf) -> np.ndarray:
    """Pad the leading app axis up to a multiple of ``multiple`` with rows
    of ``fill`` (``+inf`` timestamps: never finite, so every step's
    ``isfinite`` mask excludes them). Callers slice the rows back off the
    outputs."""
    pad = (-arr.shape[0]) % multiple
    if not pad:
        return arr
    return np.concatenate(
        [arr, np.full((pad,) + arr.shape[1:], fill, arr.dtype)])


def _to(x, dev: torch.device):
    """``x`` with every tensor leaf on ``dev`` (tuples, NamedTuples and
    lists walked; other values as they are)."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to(v, dev) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_to(v, dev) for v in x)
    return x


def _split(x, ax: int, mesh: Mesh) -> list:
    """The per-shard pieces of a sharded argument: a sequence of one
    placed tensor per device is taken as it is; a tensor is split along
    ``ax`` into equal slices, each moved to its device."""
    if isinstance(x, (list, tuple)):
        if len(x) != len(mesh):
            raise ValueError(f"shard_along_apps: {len(x)} pieces for a mesh "
                             f"of {len(mesh)} devices")
        return list(x)
    if x.shape[ax] % len(mesh):
        raise ValueError(f"shard_along_apps: {x.shape[ax]} rows do not split "
                         f"evenly over {len(mesh)} devices; pad them with "
                         f"pad_app_rows")
    return [p.to(d) for p, d in zip(torch.tensor_split(x, len(mesh), ax),
                                    mesh)]


def shard_along_apps(fn: Callable, mesh: Mesh, in_axes: Sequence,
                     out_axes: int) -> Callable:
    """``fn`` run on each device's slice of the app axis, its outputs
    concatenated in mesh order.

    ``in_axes`` has one entry per positional argument: an int naming the
    app axis of a sharded argument (a tensor, split evenly, or a sequence
    of one tensor per device already placed there, as the engines' chunk
    streams hand them over), or ``None`` for a replicated argument (its
    tensors are copied to each device; config blocks, knobs, scalars).
    ``fn`` returns a tensor or a tuple of tensors; each is concatenated
    along ``out_axes`` on the host. Each shard runs with its device
    current, so a kernel launches on that device's stream; launches are
    asynchronous, so the cards of a mesh overlap until the outputs are
    gathered."""
    def call(*args):
        if len(args) != len(in_axes):
            raise ValueError(f"shard_along_apps: {len(in_axes)} in_axes for "
                             f"{len(args)} arguments")
        per_arg = [_split(a, ax, mesh) if ax is not None else None
                   for a, ax in zip(args, in_axes)]
        outs = []
        for i, dev in enumerate(mesh):
            shard = [_to(a, dev) if parts is None else parts[i]
                     for a, parts in zip(args, per_arg)]
            if dev.type == "cuda":
                with torch.cuda.device(dev):
                    outs.append(fn(*shard))
            else:
                outs.append(fn(*shard))

        def gather(parts):
            if len(parts) == 1:
                return parts[0].cpu()
            return torch.cat([x.cpu() for x in parts], dim=out_axes)
        if isinstance(outs[0], torch.Tensor):
            return gather(outs)
        return tuple(gather([o[j] for o in outs])
                     for j in range(len(outs[0])))

    return call
