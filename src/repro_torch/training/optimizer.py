"""AdamW with fp32 master weights (the port of
``repro/training/optimizer.py``).

The state is the master parameter module and two moments per parameter,
keyed by the parameter's dotted name. :func:`apply_updates` takes the
reference's order of operations elementwise, in f32, and updates the
masters and moments in place (the reference returns new arrays, which
``jax.jit``'s donation lets XLA write over the old ones).

Weight decay applies where the reference's leaf has more than one
dimension. The reference stacks each repeated block's parameters on a
leading axis (``STACKED`` of the parameter module), so a per-layer norm
scale or bias is a ``[n_layers, d]`` leaf there and decays; the port's
unrolled ``[d]`` tensor decays with it. Unstacked vectors (``ln_f``, the
hybrid family's trailing layers) do not.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Tuple

import torch
from torch import nn

__all__ = ["OptConfig", "TrainState", "init_state", "global_norm",
           "decays", "apply_updates"]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


class TrainState(NamedTuple):
    step: int                        # updates applied
    params: nn.Module                # fp32 masters
    m: Dict[str, torch.Tensor]       # first moments, by parameter name
    v: Dict[str, torch.Tensor]       # second moments


def init_state(params: nn.Module) -> TrainState:
    """Step 0: the parameters as fp32 masters (cast in place where they are
    not fp32), zero moments on the parameters' devices."""
    params = params.float()
    zeros = {n: torch.zeros_like(p) for n, p in params.named_parameters()}
    return TrainState(step=0, params=params, m=zeros,
                      v={n: torch.zeros_like(p) for n, p in zeros.items()})


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def _schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr``, then a cosine to 0.1 ``lr`` at
    ``total_steps``; ``step`` an f32 scalar tensor, the result f32."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cosine = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (0.1 + 0.9 * cosine)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in tensors))


def decays(params: nn.Module) -> Dict[str, bool]:
    """Which parameters take weight decay: those whose reference leaf has
    more than one dimension (the port's tensor has, or it lies under one
    of the module's ``STACKED`` lists)."""
    stacked = getattr(params, "STACKED", ())
    return {n: p.dim() > 1 or n.split(".", 1)[0] in stacked
            for n, p in params.named_parameters()}


@torch.no_grad()
def apply_updates(state: TrainState, grads: Dict[str, torch.Tensor],
                  cfg: OptConfig) -> Tuple[TrainState, Dict]:
    """One AdamW update from ``grads`` (by parameter name, any float
    dtype): the global norm clipped to ``grad_clip``, bias-corrected
    moments, decoupled decay. Writes the masters and moments in place and
    returns the state at ``step + 1`` and ``{"grad_norm", "lr"}`` (f32
    scalar tensors)."""
    named = dict(state.params.named_parameters())
    if set(grads) != set(named):
        raise ValueError(f"grads and params differ: "
                         f"{sorted(set(grads) ^ set(named))}")
    dev = next(iter(named.values())).device
    step = state.step + 1
    gnorm = global_norm(grads.values())
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step_f = _f32(step, dev)
    lr = _schedule(cfg, step_f)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1.0 - torch.pow(_f32(b1, dev), step_f)
    bc2 = 1.0 - torch.pow(_f32(b2, dev), step_f)
    decay = decays(state.params)
    for name, p in named.items():
        m, v = state.m[name], state.v[name]
        g = grads[name].float() * scale
        m.mul_(b1).add_((1.0 - b1) * g)
        v.mul_(b2).add_((1.0 - b2) * g * g)
        mh = m / bc1
        vh = v / bc2
        upd = mh / (torch.sqrt(vh) + cfg.eps)
        if decay[name]:
            upd = upd + cfg.weight_decay * p
        p.sub_(lr * upd)
    new_state = TrainState(step=step, params=state.params, m=state.m,
                           v=state.v)
    return new_state, {"grad_norm": gnorm, "lr": lr}
