"""Step builders: train_step / prefill_step / serve_step for any arch (the
port of ``repro/launch/steps.py``).

PyTorch runs eagerly, so each builder returns a plain function (the
reference returns one the launcher jits).
"""
from __future__ import annotations

import copy
from typing import Callable, Dict

import torch
from torch import nn

from ..models import Model
from ..training import optimizer as opt

__all__ = ["make_train_step", "make_prefill_step", "make_serve_step"]


def _differentiable(params: nn.Module, cast_bf16: bool) -> nn.Module:
    """A copy of the module whose parameters are new leaves that require
    grad: views of the f32 masters, or bf16 copies of them with
    ``cast_bf16``. (A copy, not ``functional_call``: ``cfg.remat``
    re-computes blocks in the backward, after such a call would have put
    the masters back.)"""
    memo = {}
    for p in params.parameters():
        t = p.detach()
        if cast_bf16 and t.dtype == torch.float32:
            t = t.to(torch.bfloat16)
        memo[id(p)] = nn.Parameter(t, requires_grad=True)
    return copy.deepcopy(params, memo)


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

    grad_shardings: the ZeRO gradient layout, which comes with the
    multi-device layers (ROADMAP Queue A item 6); anything but None raises.
    """
    if grad_shardings is not None:
        raise NotImplementedError(
            "grad_shardings (the ZeRO gradient layout) comes with the "
            "multi-device layers, ROADMAP Queue A item 6")

    def train_step(state: opt.TrainState, batch: Dict):
        diff = _differentiable(state.params, cast_bf16)
        names, leaves = zip(*diff.named_parameters())
        loss = model.loss(diff, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = {n: (torch.zeros(p.shape, device=p.device) if g is None
                     else g.float()) for n, p, g in zip(names, leaves, grads)}
        new_state, metrics = opt.apply_updates(state, grads, opt_cfg)
        return new_state, dict(metrics, loss=loss.detach())

    return train_step


def make_prefill_step(model: Model, max_len: int) -> Callable:
    """``(params, batch) -> (greedy next token [B, 1] int32, cache)``."""
    @torch.inference_mode()
    def prefill_step(params, batch: Dict):
        logits, cache = model.prefill(params, batch.get("tokens"), max_len,
                                      embeds=batch.get("embeds"))
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return prefill_step


def make_serve_step(model: Model) -> Callable:
    """``(params, token [B], cache) -> (greedy next token [B] int32, cache)``
    (the cache's tensors are written in place)."""
    @torch.inference_mode()
    def serve_step(params, token, cache):
        logits, new_cache = model.decode_step(params, token, cache)
        return torch.argmax(logits, dim=-1).to(torch.int32), new_cache

    return serve_step
