"""``shard_map`` for the port (the counterpart of
``repro/distributed/compat.py``, which hides a JAX version split).

The reference's manual regions (``jax.shard_map``) run a body on each
device's shard with named mesh axes for the collectives inside. The
PyTorch counterpart is one helper over
``torch.distributed.tensor.experimental.local_map``: DTensor arguments are
redistributed to ``in_specs`` and the body sees their local tensors; its
outputs are wrapped back as DTensors with ``out_specs``. Collectives inside
the body name a mesh axis through :func:`axis_index`, :func:`psum`,
:func:`pmax` and :func:`ppermute`.

The reference's ``kernels/compat.py`` (the ``pltpu.CompilerParams``
spelling) has no PyTorch meaning and no counterpart.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

__all__ = ["shard_map", "per_shard", "axis_index", "psum", "pmax", "psum_replicated",
           "ppermute"]


def shard_map(f: Callable, mesh, in_specs, out_specs):
    """``f`` over local shards: each DTensor argument redistributed to its
    spec in ``in_specs`` (``None`` for a non-tensor argument), each output
    wrapped with its spec in ``out_specs``. The reference's ``axis_names``
    (its manual axes) has no counterpart: on a ``DeviceMesh`` every axis is
    manual inside the body, and an axis a spec does not name is
    replicated.

    Gradients: an argument replicated over a mesh axis that some other
    argument is split over gets its gradient summed over that axis (each
    rank's body saw only its part of the work: ``Partial``), as the
    transpose of the reference's replicated input does; over an axis
    nothing is split on, every rank computed the same gradient."""
    from .sharding import P, placements

    def place(spec):   # a list: local_map reads a tuple as one per output
        return None if spec is None else list(placements(spec, mesh))

    ins = [place(s) for s in in_specs]
    split = {d for pl in ins if pl is not None
             for d, p in enumerate(pl) if isinstance(p, Shard)}
    grads = tuple(None if pl is None else
                  [Partial() if (d in split and isinstance(p, Replicate))
                   else p for d, p in enumerate(pl)] for pl in ins)
    outs = (place(out_specs) if isinstance(out_specs, P)
            else tuple(place(s) for s in out_specs))
    return local_map(f, out_placements=outs, in_placements=tuple(ins),
                     in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)


def per_shard(f: Callable, in_specs, out_specs, *args):
    """``f(*args)`` as it is when no argument is a DTensor (no mesh);
    else :func:`shard_map` of ``f`` on the mesh of the DTensor arguments.
    For an op DTensor has no sharding rule for, whose work splits along
    the dims the specs name."""
    dts = [a for a in args if isinstance(a, DTensor)]
    if not dts:
        return f(*args)
    return shard_map(f, dts[0].device_mesh, in_specs, out_specs)(*args)


def _group(mesh, axis: str):
    return mesh.get_group(axis)


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return mesh.get_local_rank(axis)


def psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Sum of ``x`` over ``axis`` (in place, and returned)."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=_group(mesh, axis))
    return x


def pmax(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Maximum of ``x`` over ``axis`` (in place, and returned)."""
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=_group(mesh, axis))
    return x


class _SumReplicated(torch.autograd.Function):
    """All-reduce SUM whose result every rank then uses as one replicated
    value: the backward passes the cotangent through unchanged (each rank
    holds the same copy of it), as ``psum`` into a replicated output
    transposes in the reference."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def psum_replicated(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Differentiable sum over ``axis`` into a replicated value."""
    return _SumReplicated.apply(x, _group(mesh, axis))


def _shift(x: torch.Tensor, group, perm: Sequence[int]) -> torch.Tensor:
    """Send ``x`` to ``perm[me]`` and receive from the rank that sends to
    me (ranks are coordinates within ``group``)."""
    me = dist.get_rank(group)
    src = list(perm).index(me)
    out = torch.empty_like(x)
    ops = []
    if perm[me] != me:
        ops = [dist.P2POp(dist.isend, x.contiguous(),
                          dist.get_global_rank(group, perm[me]), group),
               dist.P2POp(dist.irecv, out,
                          dist.get_global_rank(group, src), group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out
    return x.clone()


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group, ctx.perm = group, perm
        return _shift(x, group, perm)

    @staticmethod
    def backward(ctx, g):
        inv = [0] * len(ctx.perm)
        for i, j in enumerate(ctx.perm):
            inv[j] = i
        return _shift(g, ctx.group, inv), None, None


def ppermute(x: torch.Tensor, mesh, axis: str,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``x`` moved along ``axis`` by the (source, destination) pairs of
    ``perm`` (a full permutation), as ``jax.lax.ppermute``; differentiable:
    the backward moves the cotangent by the inverse permutation."""
    dest = [0] * len(perm)
    for i, j in perm:
        dest[i] = j
    return _PPermute.apply(x, _group(mesh, axis), tuple(dest))
