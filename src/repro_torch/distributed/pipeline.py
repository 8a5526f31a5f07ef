"""Pipeline parallelism over the pod axis, GPipe schedule (the port of
``repro/distributed/pipeline.py``).

At multi-pod scale the cross-pod links are the slowest; instead of using
the "pod" axis for data parallelism, pods are *pipeline stages*. The layer
stack is split into ``n_stages`` contiguous groups; activations flow stage
to stage by ``compat.ppermute`` (point to point, the cheapest collective
there is), and microbatching keeps every stage busy: M microbatches,
M + S - 1 ticks, bubble fraction (S-1)/(M+S-1).

One process per device: each rank runs its stage's layers
``[s·L/S, (s+1)·L/S)`` of the list it is given, on its own tensors. The
backward needs no extra code: ``compat.ppermute``'s backward moves the
cotangent by the inverse permutation, as ``jax.grad`` transposes the
reference's ``ppermute``. The input enters every stage's graph and its
gradient (stage 0's) is summed over the stage axis, so every rank gets
the full gradient of what feeds the pipeline; the last stage's outputs are
replicated by a masked all-reduce whose backward passes the (replicated)
cotangent through. This keeps the reference's schedule and gradients
exactly; ``torch.distributed.pipelining`` was not taken: its schedules own
the loss and the microbatch loop, where this function is one differentiable
call inside the model's forward, as the reference's is.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.distributed as dist

from ..launch.mesh import axis_sizes
from . import compat, ctx

__all__ = ["pipeline_scan"]


class _FeedAllStages(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the stage
    axis (only stage 0 reads the input, and every rank needs its full
    gradient)."""

    @staticmethod
    def forward(ctx_, x, group):
        ctx_.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx_, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx_.group)
        return g, None


def pipeline_scan(block_fn: Callable, layer_params: Sequence, x, *,
                  n_stages: int, n_microbatches: int,
                  stage_axis: str = "pod"):
    """Run ``x`` through the whole layer list, pipelined over
    ``stage_axis`` of the active mesh.

    block_fn(params_i, x) -> x (one layer); ``layer_params`` the per-layer
    parameters (L of them, L % n_stages == 0); x: [B, ...] with
    B % n_microbatches == 0, the same on every rank. Returns y [B, ...]
    after all L layers, replicated over the stage axis."""
    mesh = ctx.active_mesh()
    if mesh is None or stage_axis not in mesh.mesh_dim_names:
        raise ValueError(f"pipeline_scan needs an active mesh with a "
                         f"{stage_axis!r} axis (ctx.use_mesh)")
    S, M = n_stages, n_microbatches
    if axis_sizes(mesh)[stage_axis] != S:
        raise ValueError(f"the {stage_axis!r} axis is not {S} stages")
    B, L = x.shape[0], len(layer_params)
    if B % M or L % S:
        raise ValueError(f"batch {B} / {M} microbatches or {L} layers / "
                         f"{S} stages do not divide")
    mb, per = B // M, L // S
    stage = compat.axis_index(mesh, stage_axis)
    here = list(layer_params)[stage * per:(stage + 1) * per]
    is_first = torch.tensor(stage == 0, device=x.device)
    perm = [(i, (i + 1) % S) for i in range(S)]

    def run_stage(h):
        for lp in here:
            h = block_fn(lp, h)
        return h

    xs = _FeedAllStages.apply(x, mesh.get_group(stage_axis)).reshape(
        (M, mb) + tuple(x.shape[1:]))
    buf = torch.zeros((mb,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    outs = [torch.zeros_like(buf) for _ in range(M)]
    # hints name data/model layouts, which have no meaning on the stage's
    # local tensors
    with ctx.use_mesh(None):
        for t in range(M + S - 1):
            mb_idx = t - stage                # microbatch at this stage
            h_in = torch.where(is_first, xs[min(t, M - 1)], buf)
            h_out = run_stage(h_in) if 0 <= mb_idx < M else h_in
            if 0 <= mb_idx < M:
                outs[mb_idx] = h_out
            # hand activations downstream (stage i -> i+1); the wraparound
            # edge S-1 -> 0 is ignored by stage 0 (it reads the feed)
            buf = compat.ppermute(h_out, mesh, stage_axis, perm)
    # only the last stage holds real outputs: masked, not dropped, and the
    # last hand-off tied in at zero weight, so that every rank's graph
    # reaches every ppermute and the backward's sends and receives pair up
    # tick for tick on all stages
    ys = (torch.stack(outs) * float(stage == S - 1)
          + 0.0 * buf.sum())
    ys = compat.psum_replicated(ys, mesh, stage_axis)
    return ys.reshape((B,) + tuple(x.shape[1:]))
