"""Carry inputs, scan state and model weights across from the JAX reference
as numpy.

The policy simulator's inputs are traces and its state the scan state; the
serving slice's models have weights (the reference's parameter pytree). The
tests make traces and state with numpy from a seed, take the weights from
the reference's own ``Model.init``, and hand the same arrays to the
reference and, through these functions, to the port.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .configs.base import ModelConfig
from .core.policy_math import HybridSweepBlock
from .core.workload import Trace
from .device import resolve_device

__all__ = ["trace_from_numpy", "step_state_from_numpy",
           "cfg_blocks_from_numpy", "sweep_block_from_numpy",
           "model_params_from_numpy",
           "train_state_from_numpy"]

_STEP_DTYPES = (torch.float32, torch.int32, torch.int32, torch.float32,
                torch.float32, torch.float32, torch.float32, torch.int32,
                torch.float32)


def trace_from_numpy(times: Union[np.ndarray, Sequence[np.ndarray]],
                     counts: Optional[np.ndarray] = None, *,
                     duration_minutes: float) -> Trace:
    """A port :class:`Trace` from the reference's data: either the padded
    ``Trace.to_padded()`` pair (``times`` [n, width] +inf-padded, ``counts``
    [n]) or a list of per-app sorted time arrays (``counts`` None)."""
    if counts is None:
        return Trace(specs=None,
                     times=[np.asarray(t).copy() for t in times],
                     duration_minutes=float(duration_minutes))
    times = np.ascontiguousarray(times)
    counts = np.asarray(counts, np.int32)
    if times.ndim != 2 or counts.shape != (times.shape[0],):
        raise ValueError("padded times must be [n, width] with counts [n]")
    return Trace(specs=None, times=None,
                 duration_minutes=float(duration_minutes),
                 _padded=(times.copy(), counts.copy()))


def step_state_from_numpy(prev_t, cum, oob, cv_sum, cv_sum_sq, prewarm,
                          unload_at, cold, waste, *,
                          device="cuda") -> Tuple[torch.Tensor, ...]:
    """The nine sweep-step states (reference order: prev_t, cum, oob,
    cv_sum, cv_sum_sq, prewarm, unload_at, cold, waste) as contiguous
    float32/int32 tensors on ``device``."""
    dev = resolve_device(device)
    arrays = (prev_t, cum, oob, cv_sum, cv_sum_sq, prewarm, unload_at, cold,
              waste)
    return tuple(torch.tensor(np.asarray(a), dtype=dt, device=dev)
                 for a, dt in zip(arrays, _STEP_DTYPES))


def cfg_blocks_from_numpy(cfg_i32, cfg_f32, *, device="cuda"
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``_build_pallas_cfg`` blocks ([S, 4] int32, [S, 7]
    float32) as tensors on ``device``."""
    dev = resolve_device(device)
    return (torch.tensor(np.asarray(cfg_i32), dtype=torch.int32, device=dev),
            torch.tensor(np.asarray(cfg_f32), dtype=torch.float32,
                         device=dev))


def sweep_block_from_numpy(blk, *, device="cuda") -> HybridSweepBlock:
    """A reference ``HybridSweepBlock`` (``simulator._build_sweep_block``,
    numpy leaves) as the port's block: each leaf a tensor of the same
    shape and dtype on ``device``."""
    dev = resolve_device(device)
    return HybridSweepBlock(*(torch.from_numpy(np.array(leaf)).to(dev)
                              for leaf in blk))


def _flatten(tree: Dict, prefix: str = "") -> Iterator[Tuple[str, object]]:
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from _flatten(val, path + ".")
        else:
            yield path, val


def _param_module(cfg: ModelConfig) -> type:
    """The port's parameter module of ``cfg``'s family (its ``STACKED``
    names the keys under which the reference stacks per-layer leaves)."""
    from .models.mamba2 import SSMParams
    from .models.moe import MoEParams
    from .models.rglru import HybridParams
    from .models.transformer import DenseParams, EncDecParams

    return {"dense": DenseParams, "moe": MoEParams, "encdec": EncDecParams,
            "hybrid": HybridParams, "ssm": SSMParams}[cfg.family]


def model_params_from_numpy(cfg: ModelConfig, tree: Dict, *,
                            device="cuda") -> torch.nn.Module:
    """The reference's parameter pytree (nested dicts of numpy arrays, the
    repeated blocks stacked on a leading axis: ``[n_super, ...]`` under
    ``blocks`` for the hybrid family, ``[n_layers, ...]`` under ``layers``
    for the dense, MoE and SSM families (the MoE experts' leaves are
    ``[n_layers, E, D, F]``), ``[n_encoder_layers, ...]`` under
    ``enc_layers`` and ``[n_layers, ...]`` under ``layers`` for the
    encoder-decoder) as the port's fp32 parameter module on ``device``.

    Names map one to one (``blocks/rec1/wx/w``[i] -> ``blocks.i.rec1.wx.w``,
    ``layers/A_log``[i] -> ``layers.i.A_log``, ``layers/attn/wq/b``[i] ->
    ``layers.i.attn.wq.b``, ``head/w`` -> ``head.w`` where the unembedding
    is not tied); linear weights keep the
    reference's ``[d_in, d_out]`` layout, which the port multiplies the same
    way (``x @ w``). Raises ``ValueError`` on a missing or extra leaf or a
    shape that differs."""
    module = _param_module(cfg)
    stacked_keys = module.STACKED
    dev = resolve_device(device)
    flat = {}
    for path, arr in _flatten(tree):
        arr = np.asarray(arr)
        stacked = next((k for k in stacked_keys
                        if path.startswith(k + ".")), None)
        if stacked is not None:
            for i in range(arr.shape[0]):
                flat[f"{stacked}.{i}.{path[len(stacked) + 1:]}"] = arr[i]
        else:
            flat[path] = arr
    with torch.device("meta"):
        params = module(cfg)
    params = params.to_empty(device=dev).requires_grad_(False)
    names = dict(params.named_parameters())
    if set(flat) != set(names):
        raise ValueError(
            f"parameter names differ: missing {sorted(set(names) - set(flat))}"
            f", extra {sorted(set(flat) - set(names))}")
    for name, p in names.items():
        if tuple(flat[name].shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {flat[name].shape} != "
                             f"{tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.array(flat[name], dtype=np.float32)))
    return params


def train_state_from_numpy(cfg: ModelConfig, state, *, device="cuda"):
    """The reference's ``TrainState`` (``step``, ``params``, ``m``, ``v``;
    numpy leaves, each tree laid out as the parameters) as the port's
    :class:`~repro_torch.training.optimizer.TrainState` on ``device``: the
    masters through :func:`model_params_from_numpy`, each moment tree
    through it too and keyed by the port's parameter names. The same call
    carries the reference's gradients (a tree of the parameters' layout)
    across leaf by leaf."""
    from .training.optimizer import TrainState

    def named(tree):
        return {n: p.detach() for n, p in model_params_from_numpy(
            cfg, tree, device=device).named_parameters()}

    return TrainState(step=int(np.asarray(state.step)),
                      params=model_params_from_numpy(cfg, state.params,
                                                     device=device),
                      m=named(state.m), v=named(state.v))
