"""Activation-sharding hint context (the port of ``repro/distributed/ctx.py``).

Model code is mesh-agnostic; the launcher, the dry-run and the mesh train
step install the active ``DeviceMesh`` here and layers call :func:`hint`
with symbolic axis roles ("data", "model", None). Outside a mesh context,
and on a plain tensor, the hints return their input unchanged, so every
single-device path of the port runs as before.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple, Union

from torch.distributed.tensor import DTensor

from ..launch.mesh import axis_sizes

__all__ = ["set_mesh", "use_mesh", "axis_size", "active_mesh", "spec", "hint"]

_ACTIVE: dict = {"mesh": None, "data": None, "model": None}

Role = Union[str, None, Tuple[str, ...]]


def set_mesh(mesh) -> None:
    if mesh is None:
        _ACTIVE.update(mesh=None, data=None, model=None)
        return
    names = mesh.mesh_dim_names
    data = tuple(a for a in ("pod", "data") if a in names)
    _ACTIVE.update(
        mesh=mesh,
        data=(data if len(data) > 1 else (data[0] if data else None)),
        model="model" if "model" in names else None,
    )


@contextlib.contextmanager
def use_mesh(mesh):
    prev = dict(_ACTIVE)
    set_mesh(mesh)
    try:
        yield
    finally:
        _ACTIVE.update(prev)


def active_mesh():
    """The ``DeviceMesh`` installed by :func:`set_mesh`, or None."""
    return _ACTIVE["mesh"]


def axis_size(role: str) -> int:
    mesh = _ACTIVE["mesh"]
    ax = _ACTIVE.get(role)
    if mesh is None or ax is None:
        return 1
    sizes = axis_sizes(mesh)
    n = 1
    for a in (ax if isinstance(ax, tuple) else (ax,)):
        n *= sizes[a]
    return n


def spec(shape, *roles: Role):
    """The spec (``sharding.P``) that roles name for a tensor of
    ``shape`` under the active mesh: per dim the axis (or axes) of the role,
    dropped where it is size 1 or does not divide the dim."""
    from .sharding import P
    out = []
    for dim, role in zip(shape, roles):
        ax = _ACTIVE.get(role) if isinstance(role, str) else None
        size = axis_size(role) if ax is not None else 1
        out.append(ax if (size > 1 and dim % size == 0) else None)
    return P(*out)


def hint(x, *roles: Role):
    """``x`` redistributed to the placements its roles name (the
    reference's ``with_sharding_constraint`` by role); an axis whose size
    does not divide the dim is dropped. Returns ``x`` itself outside a mesh
    or when ``x`` is not a DTensor."""
    mesh = _ACTIVE["mesh"]
    if mesh is None or not isinstance(x, DTensor):
        return x
    from .sharding import placements
    # redistributed even where the placements already agree: the backward
    # then pins the gradient to them too, as the reference's constraint does
    return x.redistribute(x.device_mesh,
                          placements(spec(x.shape, *roles), x.device_mesh))
