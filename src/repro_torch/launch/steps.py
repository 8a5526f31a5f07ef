"""Step builders: train_step / prefill_step / serve_step for any arch (the
port of ``repro/launch/steps.py``).

PyTorch runs eagerly, so each builder returns a plain function (the
reference returns one the launcher jits). Under a mesh the train step is
the ZeRO step: the state's tensors are DTensors (``grad_shardings``).
"""
from __future__ import annotations

import copy
from typing import Callable, Dict

import torch
from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from ..distributed import ctx
from ..distributed import sharding as shd
from ..models import Model
from ..training import optimizer as opt

__all__ = ["make_train_step", "make_prefill_step", "make_serve_step",
           "place_batch"]


def _differentiable(params: nn.Module, cast_bf16: bool,
                    placements=None) -> nn.Module:
    """A copy of the module whose parameters are new leaves that require
    grad: views of the f32 masters, or bf16 copies of them with
    ``cast_bf16``. (A copy, not ``functional_call``: ``cfg.remat``
    re-computes blocks in the backward, after such a call would have put
    the masters back.) With ``placements`` (``{name: DTensor placements}``)
    each leaf is its master cast on the master's shards, then
    redistributed to those placements: the ZeRO all-gather, in bf16 under
    ``cast_bf16``."""
    memo = {}
    for name, p in params.named_parameters():
        t = p.detach()
        if cast_bf16 and t.dtype == torch.float32:
            t = t.to(torch.bfloat16)
        if placements is not None:
            t = t.redistribute(t.device_mesh, placements[name])
        memo[id(p)] = nn.Parameter(t, requires_grad=True)
    return copy.deepcopy(params, memo)


def place_batch(batch: Dict, mesh, cfg) -> Dict:
    """The global ``batch`` (the same on every rank) as DTensors in the
    placements of ``sharding.batch_specs``; each rank keeps its shard (no
    communication). Leaves that are DTensors already stay as they are."""
    specs = shd.batch_specs(cfg, {k: v for k, v in batch.items()
                                  if v is not None}, mesh)
    return {k: (v if v is None or isinstance(v, DTensor) else
                distribute_tensor(v, mesh, shd.placements(specs[k], mesh),
                                  src_data_rank=None))
            for k, v in batch.items()}


def make_train_step(model: Model, opt_cfg: opt.OptConfig,
                    grad_shardings=None, cast_bf16: bool = False) -> Callable:
    """Build the train step ``(state, batch) -> (state, metrics)``: the loss
    and its gradients with respect to every master parameter
    (``torch.autograd.grad``), then :func:`optimizer.apply_updates` (in
    place); ``metrics`` holds ``loss``, ``grad_norm`` and ``lr`` as scalar
    tensors on the state's device.

    cast_bf16: differentiate with respect to bf16 copies of the f32
    masters (the reference casts them before its ZeRO all-gathers); the
    gradients come back to f32 and the optimizer math stays f32.

    grad_shardings: ``{parameter name: DTensor placements}`` of the ZeRO
    layout (``sharding.named(sharding.opt_specs(...), mesh)``). The
    state's masters and moments are then DTensors in those placements on
    one ``DeviceMesh``; the forward takes each master (cast to bf16 first
    under ``cast_bf16``, on its shards) redistributed to the placements of
    ``sharding.param_specs`` (the all-gather over data), the batch is placed
    by ``sharding.batch_specs`` (:func:`place_batch`), the gradients come
    back redistributed to ``grad_shardings`` (the reduce-scatter), and
    AdamW and the gradient norm run on the shards."""
    fwd = {}

    def train_step(state: opt.TrainState, batch: Dict):
        mesh = None
        if grad_shardings is not None:
            master = next(state.params.parameters())
            if not isinstance(master, DTensor):
                raise ValueError("grad_shardings needs the state's masters "
                                 "and moments as DTensors on one mesh "
                                 "(sharding.distribute_state)")
            mesh = master.device_mesh
            if not fwd:
                fwd.update(shd.named(shd.param_specs(state.params, mesh,
                                                     model.cfg), mesh))
            batch = place_batch(batch, mesh, model.cfg)
        diff = _differentiable(state.params, cast_bf16,
                               fwd if mesh is not None else None)
        names, leaves = zip(*diff.named_parameters())
        with ctx.use_mesh(mesh), implicit_replication():
            loss = model.loss(diff, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        out = {}
        for n, p, g in zip(names, leaves, grads):
            if g is None:
                g = torch.zeros_like(p)
            if mesh is not None:
                g = g.redistribute(mesh, grad_shardings[n])
            out[n] = g.float()
        with implicit_replication():
            new_state, metrics = opt.apply_updates(state, out, opt_cfg)
        return new_state, dict(metrics, loss=loss.detach())

    return train_step


def _serving():
    """``torch.inference_mode()``; ``torch.no_grad()`` under a mesh
    (DTensor's views need the version counters inference tensors lack)."""
    return torch.no_grad() if ctx.active_mesh() else torch.inference_mode()


def _greedy(logits) -> torch.Tensor:
    """argmax over the vocabulary, int32; a vocabulary-sharded DTensor is
    gathered along it first (DTensor's sharded argmax is data-dependent)."""
    logits = ctx.hint(logits, *("data",) + (None,) * (logits.dim() - 1))
    return torch.argmax(logits, dim=-1).to(torch.int32)


def make_prefill_step(model: Model, max_len: int) -> Callable:
    """``(params, batch) -> (greedy next token [B, 1] int32, cache)``."""
    def prefill_step(params, batch: Dict):
        with _serving():
            logits, cache = model.prefill(params, batch.get("tokens"),
                                          max_len, embeds=batch.get("embeds"))
            return _greedy(logits), cache

    return prefill_step


def make_serve_step(model: Model) -> Callable:
    """``(params, token [B], cache) -> (greedy next token [B] int32, cache)``
    (the cache's tensors are written in place)."""
    def serve_step(params, token, cache):
        with _serving():
            logits, new_cache = model.decode_step(params, token, cache)
            return _greedy(logits), new_cache

    return serve_step
