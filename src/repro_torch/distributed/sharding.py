"""Sharding rules: parameter, optimizer-state, input and cache specs (the
port of ``repro/distributed/sharding.py``).

Parallelism map, as in the reference:
  * DP  — batch over ("pod", "data")
  * TP  — attention heads / FFN / vocab over "model"
  * EP  — MoE experts over "model"
  * SP  — KV-cache sequence over "model" (distributed decode)
  * ZeRO — optimizer state and fp32 masters also sharded over the data
    axes (first divisible dim): the gradient all-reduce becomes a
    reduce-scatter, the update runs on shards, the forward all-gathers.

A spec (:class:`P`) names a mesh axis (or a tuple of axes, or None) per
tensor dim, as a ``PartitionSpec`` does. Specs are derived from anything
with axis names and sizes (``launch.mesh.axis_sizes``: a ``DeviceMesh``, or
a stand-in with ``axis_names`` and a ``shape`` mapping), so derivation
needs no process group; :func:`named` turns them into DTensor placements
on a real ``DeviceMesh``.

The port's parameters are unstacked (``layers.3.attn.wq.w``) where the
reference stacks each repeated block's leaves on a leading axis
(``layers/attn/wq/w`` of ``[n_layers, ...]``). A port leaf's spec is the
reference's spec of the stacked leaf with its leading entry dropped: the
rules below run on the reference's path and stacked shape. Where the
reference puts a data axis on that leading entry (``zero_spec``'s
layer-dim fallback: whole layers on different data shards, which is no
DTensor placement of a per-layer tensor), the port replicates the leaf over
data instead (:func:`layer_axis_dropped` lists those leaves).
"""
from __future__ import annotations

import re
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
from torch import nn
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from ..configs.base import ModelConfig
from ..launch.mesh import axis_sizes, data_axes

__all__ = ["P", "MP", "param_spec", "param_specs", "zero_spec", "opt_specs",
           "layer_axis_dropped", "batch_specs", "cache_specs_tree", "named",
           "placements", "shard", "distribute_params", "distribute_state",
           "full"]

MP = "model"


class P(tuple):
    """A partition spec: per tensor dim a mesh axis name, a tuple of axis
    names, or None (replicated); trailing dims not named are replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P" + super().__repr__()


# (path regex, spec for the *unstacked* leaf). `MP` marks the TP dim. The
# reference's table, on its slash-joined paths.
_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    (r"embed/table$",              (MP, None)),
    (r"(attn|xattn)/w[qkv]/w$",    (None, MP)),
    (r"(attn|xattn)/w[qkv]/b$",    (MP,)),
    (r"(attn|xattn)/wo/w$",        (MP, None)),
    (r"(mlp|ffn)/(wi|wg)/w$",      (None, MP)),
    (r"(mlp|ffn)/wo/w$",           (MP, None)),
    (r"head/w$",                   (None, MP)),
    # MoE: experts over the model axis (EP)
    (r"moe/router/w$",             (None, None)),
    (r"moe/(wi|wg|wo)$",           (MP, None, None)),
    # Mamba-2
    (r"in_proj/w$",                (None, MP)),
    (r"out_proj/w$",               (MP, None)),
    (r"conv_w$",                   (None, MP)),
    (r"(A_log|dt_bias|D)$",        (MP,)),
    # RG-LRU
    (r"(wx|wy|wa|wi)/w$",          (None, MP)),
    (r"(wx|wy|wa|wi)/b$",          (MP,)),
    (r"out/w$",                    (MP, None)),
    (r"lam$",                      (MP,)),
)

# The reference's test for a layer-stacked path (``enc_layers/`` does not
# match it: the reference treats those leaves as unstacked).
_STACKED = re.compile(r"(^|/)(layers|blocks)/")

# The port's per-layer module lists (the reference's stacked subtrees).
_PORT_STACKED = re.compile(r"^(layers|blocks|enc_layers)\.(\d+)\.(.+)$")


def _fit(spec, shape, mesh) -> P:
    """Drop axes whose dim isn't divisible by the mesh axis size."""
    sizes = axis_sizes(mesh)
    out = []
    for dim, ax in zip(shape, spec):
        if ax is None:
            out.append(None)
            continue
        size = 1
        for a in ((ax,) if isinstance(ax, str) else ax):
            size *= sizes[a]
        out.append(ax if dim % size == 0 else None)
    return P(*out)


def param_spec(path_str: str, shape, mesh,
               cfg: Optional[ModelConfig] = None) -> P:
    """The reference's spec of the leaf at slash-joined ``path_str`` with
    (possibly stacked) ``shape``."""
    stacked = bool(_STACKED.search(path_str))
    # GQA: if the KV heads don't divide the model axis, shard-slicing wk/wv
    # would cut across head boundaries — replicate them instead.
    if cfg is not None and re.search(r"(attn|xattn)/w[kv]/(w|b)$", path_str):
        if cfg.n_kv_heads % axis_sizes(mesh)[MP] != 0:
            return P()
    for pat, spec in _RULES:
        if re.search(pat, path_str):
            if stacked:
                spec = (None,) + tuple(spec)
            spec = spec[: len(shape)]
            spec = tuple(spec) + (None,) * (len(shape) - len(spec))
            return _fit(spec, shape, mesh)
    return P()  # replicate (norms, biases, scalars)


#: As in the reference: ZeRO skips the layer dim of a stacked leaf.
ZERO_SKIP_STACKED_DIM = True


def zero_spec(spec: P, shape, mesh, stacked: bool = False) -> P:
    """Add data-axis sharding (ZeRO) to the first divisible unsharded dim
    (the reference's rule, on its stacked shapes)."""
    daxes = data_axes(mesh)
    if not daxes:
        return spec
    sizes = axis_sizes(mesh)
    dsize = 1
    for a in daxes:
        dsize *= sizes[a]
    out = list(spec) + [None] * (len(shape) - len(spec))
    start = 1 if (stacked and ZERO_SKIP_STACKED_DIM and len(shape) > 1) else 0
    for i in range(start, len(shape)):
        dim, ax = shape[i], out[i]
        if ax is None and dim % dsize == 0 and dim >= dsize:
            out[i] = daxes if len(daxes) > 1 else daxes[0]
            return P(*out)
    if start == 1 and shape[0] % dsize == 0 and out[0] is None:
        out[0] = daxes if len(daxes) > 1 else daxes[0]  # fallback: layer dim
        return P(*out)
    return spec


# ---------------------------------------------------------------------------
# The port's leaves, seen as the reference's
# ---------------------------------------------------------------------------


def _shapes(params) -> Dict[str, Tuple[int, ...]]:
    """``{dotted name: shape}`` of a parameter module, or of a mapping of
    names to tensors or shapes."""
    if isinstance(params, nn.Module):
        return {n: tuple(p.shape) for n, p in params.named_parameters()}
    return {n: tuple(getattr(v, "shape", v)) for n, v in params.items()}


def _reference_leaves(shapes: Dict[str, Tuple[int, ...]]
                      ) -> Iterator[Tuple[str, str, Tuple[int, ...], bool]]:
    """Per port leaf: (port name, the reference's slash path, the
    reference's shape, whether the reference stacks it on a leading
    axis)."""
    counts: Dict[str, set] = {}
    for name in shapes:
        m = _PORT_STACKED.match(name)
        if m:
            counts.setdefault(m.group(1), set()).add(int(m.group(2)))
    for name, shape in shapes.items():
        m = _PORT_STACKED.match(name)
        if m:
            path = m.group(1) + "/" + m.group(3).replace(".", "/")
            yield name, path, (len(counts[m.group(1)]),) + shape, True
        else:
            yield name, name.replace(".", "/"), shape, False


def _port_spec(ref: P, layered: bool) -> Tuple[P, bool]:
    """The port leaf's spec from the reference's (stacked) spec: the
    leading entry dropped; True when that entry named a mesh axis."""
    if not layered:
        return ref, False
    return P(*ref[1:]), len(ref) > 0 and ref[0] is not None


def param_specs(params, mesh, cfg: Optional[ModelConfig] = None
                ) -> Dict[str, P]:
    """``{parameter name: spec}`` (tensor parallelism) for a parameter
    module or a ``{name: tensor or shape}`` mapping."""
    shapes = _shapes(params)
    out = {}
    for name, path, ref_shape, layered in _reference_leaves(shapes):
        out[name], _ = _port_spec(param_spec(path, ref_shape, mesh, cfg),
                                  layered)
    return out


def _opt_specs(params, mesh, cfg) -> Dict[str, Tuple[P, bool]]:
    shapes = _shapes(params)
    out = {}
    for name, path, ref_shape, layered in _reference_leaves(shapes):
        base = param_spec(path, ref_shape, mesh, cfg)
        ref = zero_spec(base, ref_shape, mesh,
                        stacked=bool(_STACKED.search(path)))
        out[name] = _port_spec(ref, layered)
    return out


def opt_specs(params, mesh, cfg: Optional[ModelConfig] = None
              ) -> Dict[str, P]:
    """ZeRO specs for the optimizer state and the fp32 masters."""
    return {n: s for n, (s, _) in _opt_specs(params, mesh, cfg).items()}


def layer_axis_dropped(params, mesh, cfg: Optional[ModelConfig] = None
                       ) -> List[str]:
    """The leaves whose ZeRO spec in the reference puts a data axis on the
    layer dim of the stacked leaf, which the port replicates over data
    instead (sorted names)."""
    return sorted(n for n, (_, dropped) in
                  _opt_specs(params, mesh, cfg).items() if dropped)


# ---------------------------------------------------------------------------
# Input / cache specs
# ---------------------------------------------------------------------------


def _dp(mesh):
    da = data_axes(mesh)
    return da if len(da) > 1 else (da[0] if da else None)


def batch_specs(cfg: ModelConfig, specs: Dict[str, Any], mesh
                ) -> Dict[str, Any]:
    """Specs for ``Model.input_specs()`` structures (divisibility-guarded:
    a batch of 1 — long_500k — simply drops the data axis)."""
    dp = _dp(mesh)
    out: Dict[str, Any] = {}
    for name, leaf in specs.items():
        if name == "cache":
            out[name] = cache_specs_tree(cfg, leaf, mesh)
        elif name == "token":
            out[name] = _fit((dp,), leaf.shape, mesh)
        elif name in ("tokens", "labels", "mask"):
            out[name] = _fit((dp, None), leaf.shape, mesh)
        elif name == "embeds":
            out[name] = _fit((dp, None, None), leaf.shape, mesh)
        else:
            out[name] = P()
    return out


def _cache_spec(ps: str, shape, mesh) -> P:
    """The reference's spec of the cache leaf at slash path ``ps`` with
    its (stacked) ``shape``."""
    dp = _dp(mesh)
    msize = axis_sizes(mesh)[MP]
    if re.search(r"(^|/)(h1|h2)$", ps):
        spec = P(None, dp, MP if shape[2] % msize == 0 else None)
    elif re.search(r"(^|/)(conv1|conv2)$", ps):
        spec = P(None, dp, None, MP if shape[3] % msize == 0 else None)
    elif re.search(r"(^|/)tail\d+/h$", ps):
        spec = P(dp, MP if shape[1] % msize == 0 else None)
    elif re.search(r"(^|/)tail\d+/conv$", ps):
        spec = P(dp, None, MP if shape[2] % msize == 0 else None)
    elif re.search(r"(^|/)conv$", ps):  # ssm conv: [L, B, W-1, C]
        spec = P(None, dp, None, MP if shape[3] % msize == 0 else None)
    elif ps.endswith("enc"):
        spec = P(dp, None, None)
    elif re.search(r"(^|/)(k|v|ring_k|ring_v)$", ps):
        # [L, B, S, Hkv, hd]. Preference order: distributed decode ->
        # sequence-sharded; KV heads over model; head_dim over model;
        # sequence (SP) as a last resort.
        from . import dist_decode
        heads, hd = shape[3], shape[4]
        if (dist_decode.ENABLED and "ring" not in ps
                and shape[2] % msize == 0):
            spec = P(None, dp, MP, None, None)
        elif heads % msize == 0:
            spec = P(None, dp, None, MP, None)
        elif hd % msize == 0:
            spec = P(None, dp, None, None, MP)
        elif shape[2] % msize == 0:
            spec = P(None, dp, MP, None, None)
        else:
            spec = P(None, dp, None, None, None)
    elif ps.endswith("ssm"):        # [L, B, H, N, Pdim]
        spec = P(None, dp, MP if shape[2] % msize == 0 else None, None, None)
    elif re.search(r"(^|/)h\d?$", ps):
        spec = P(dp, MP if shape[-1] % msize == 0 else None)
    else:
        spec = P()
    return _fit(tuple(spec) + (None,) * (len(shape) - len(spec)), shape,
                mesh)


def cache_specs_tree(cfg: ModelConfig, cache, mesh):
    """Decode-cache specs for the port's cache layout: the same structure
    with a :class:`P` for every tensor (or ``TensorSpec``) and for ``pos``.

    The port keeps one tensor per layer where the reference stacks them
    (``{"k": [per layer [B, S, Hkv, hd]], ...}``, the SSM's ``ssm`` and
    ``conv`` lists, the hybrid's list of ``blocks``); each gets the
    reference's stacked spec with the leading (layer) entry dropped, which
    is never a mesh axis there. KV caches: batch over data; KV heads over
    model when they divide it, else head_dim, else the sequence (and the
    sequence first under ``dist_decode.ENABLED``). SSM states: heads over
    model."""
    def leaf(path: str, x, n_stacked: Optional[int]):
        if not hasattr(x, "shape"):
            return P()                     # pos (a host int)
        shape = tuple(x.shape)
        if n_stacked is None:
            return _cache_spec(path, shape, mesh)
        return P(*_cache_spec(path, (n_stacked,) + shape, mesh)[1:])

    def walk(path: str, node, n_stacked: Optional[int]):
        if hasattr(node, "shape"):
            return leaf(path, node, n_stacked)
        if isinstance(node, dict):
            return {k: walk(f"{path}/{k}" if path else k, v, n_stacked)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(path, v, len(node)) for v in node]
        return leaf(path, node, n_stacked)

    return walk("", cache, None)


# ---------------------------------------------------------------------------
# Specs -> DTensor placements
# ---------------------------------------------------------------------------


def placements(spec: P, mesh) -> Tuple:
    """The DTensor placements of ``spec`` on ``mesh``: per mesh dim,
    ``Shard(d)`` for the tensor dim ``d`` whose entry names that axis, else
    ``Replicate()``. A tensor dim over several axes (``("pod", "data")``)
    is sharded over each of them in mesh order, as the reference's
    ``NamedSharding`` splits it major to minor."""
    names = mesh.mesh_dim_names
    out = [Replicate()] * len(names)
    for d, ax in enumerate(spec):
        for a in (() if ax is None else (ax,) if isinstance(ax, str) else ax):
            out[names.index(a)] = Shard(d)
    return tuple(out)


def shard(t: torch.Tensor, mesh, spec: P) -> DTensor:
    """``t`` (the whole tensor, the same on every rank, as a seeded init or
    a checkpoint gives it) as a DTensor in ``spec``'s placements on
    ``mesh``, each rank keeping only its own shard (no communication)."""
    pl = placements(spec, mesh)
    d = distribute_tensor(t, mesh, pl, src_data_rank=None)
    local = d.to_local()
    if local.untyped_storage().nbytes() > local.numel() * local.element_size():
        # a view into the whole tensor: copy the shard out, so that the
        # whole one can be freed
        d = DTensor.from_local(local.clone(), mesh, pl, run_check=False)
    return d


def distribute_params(params: nn.Module, mesh,
                      specs: Dict[str, P]) -> nn.Module:
    """Replace every parameter of ``params`` (in place) by a DTensor in the
    placements of its spec (:func:`shard`)."""
    for name, p in list(params.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = params.get_submodule(owner) if owner else params
        d = shard(p.detach(), mesh, specs[name])
        setattr(mod, leaf, nn.Parameter(d, requires_grad=p.requires_grad))
    return params


def distribute_state(state, mesh, specs: Dict[str, P]):
    """A ``TrainState`` with its masters and moments as DTensors in the
    placements of ``specs`` (``opt_specs``: the ZeRO layout)."""
    params = distribute_params(state.params, mesh, specs)
    return state._replace(
        params=params,
        m={n: shard(t, mesh, specs[n]) for n, t in state.m.items()},
        v={n: shard(t, mesh, specs[n]) for n, t in state.v.items()})


def full(t: torch.Tensor) -> torch.Tensor:
    """The whole logical tensor of a DTensor (gathered), or ``t``."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def named(tree_specs, mesh):
    """The placements of every :class:`P` in ``tree_specs`` (dicts and
    lists walked) on the ``DeviceMesh`` ``mesh``."""
    if isinstance(tree_specs, P):
        return placements(tree_specs, mesh)
    if isinstance(tree_specs, dict):
        return {k: named(v, mesh) for k, v in tree_specs.items()}
    if isinstance(tree_specs, (list, tuple)):
        return [named(v, mesh) for v in tree_specs]
    raise TypeError(f"not a spec tree: {type(tree_specs).__name__}")
