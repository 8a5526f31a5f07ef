"""The benchmark's draw of an endpoint's weights, and their hand-over to the
program.

Each group of the reference's layout (the embedding, one layer, the final
norm and head) is one ``torch.randn`` call on the device, from a generator
seeded by (run seed, endpoint, group), scaled by kind and rounded to the
served type, bfloat16. So both sides get the same numbers, and the
reference draws any group again on its own, without holding the rest.

The scales (the configuration file's ``init``): the embedding at
``embed_std``; a matrix into the residual stream's width ("in") at
``1/sqrt(fan_in)``, the query and key projections ("qk") at ``qk_gain``
times that; the residual branches' output projections ("out", and
the experts' ``wo``) also times ``1/sqrt(2 n_layers)``; the experts'
stacked ``[E, D, F]`` inputs at ``1/sqrt(D)``; biases at ``bias_std``; norm
scales at ``1 + norm_jitter * N(0, 1)``. At this draw token identity lasts
through the depth (a unit-scale embedding, depth-scaled residual
branches), so a router stays about balanced and logits differ from
position to position; the query and key gain makes attention select a
few positions, as trained attention does, where at unit gain it would
average over the whole prefix and the cache and positions would hardly
move the logits; biases and norm scales are not zero and one, so that the
paths that read them are checked.
"""
from __future__ import annotations

import hashlib
import importlib
import math
from typing import Dict, List, Tuple

import torch

__all__ = ["group_seed", "draw_group", "program_params"]


def group_seed(seed: int, endpoint: int, group: str) -> int:
    """A 63-bit generator seed for one group of one endpoint's weights."""
    h = hashlib.blake2b(f"weights/{seed}/{endpoint}/{group}".encode(),
                        digest_size=8)
    return int.from_bytes(h.digest(), "little") & ((1 << 63) - 1)


def _std(kind: str, shape, init: dict, n_layers: int) -> float:
    depth = 1.0 / math.sqrt(2 * n_layers)
    if kind == "embed":
        return init["embed_std"]
    if kind == "in":
        return 1.0 / math.sqrt(shape[0])
    if kind == "qk":
        return init["qk_gain"] / math.sqrt(shape[0])
    if kind == "out":
        return depth / math.sqrt(shape[0])
    if kind == "experts_in":
        return 1.0 / math.sqrt(shape[1])
    if kind == "experts_out":
        return depth / math.sqrt(shape[1])
    if kind == "bias":
        return init["bias_std"]
    if kind == "norm":
        return init["norm_jitter"]
    raise ValueError(f"unknown kind {kind!r}")


def draw_group(items: List[Tuple[str, Tuple[int, ...], str]], init: dict,
               n_layers: int, seed: int, endpoint: int, group: str,
               device, dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """One group's weights (name -> tensor in ``dtype``), from one normal
    draw of all its elements."""
    sizes = [math.prod(shape) for _, shape, _ in items]
    gen = torch.Generator(device=device).manual_seed(
        group_seed(seed, endpoint, group))
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32)
    out, off = {}, 0
    for (name, shape, kind), n in zip(items, sizes):
        t = flat[off:off + n].view(shape) * _std(kind, shape, init, n_layers)
        if kind == "norm":
            t = t + 1.0
        out[name] = t.to(dtype)
        off += n
    return out


def program_params(config: dict, layout, seed: int, endpoint: int, device):
    """The program's parameter module (``config["params_module"]``, the
    class the program builds its weights in), in float32 on ``device``,
    holding this endpoint's draw: every name and shape of the layout, and no
    other."""
    mod_name, cls_name = config["params_module"].rsplit(".", 1)
    cls = getattr(importlib.import_module(mod_name), cls_name)
    from repro_torch.configs.base import ModelConfig
    with torch.device("meta"):
        params = cls(ModelConfig(**config["model"]))
    params = params.to_empty(device=device).requires_grad_(False)
    have = {n: p for n, p in params.named_parameters()}
    want = {name: shape for _, items in layout for name, shape, _ in items}
    if {n: tuple(p.shape) for n, p in have.items()} != want:
        raise ValueError(f"{config['params_module']} does not hold the "
                         f"reference's layout: "
                         f"{sorted(set(have) ^ set(want))[:8]}")
    m = config["model"]
    with torch.no_grad():
        for group, items in layout:
            for name, t in draw_group(items, config["init"], m["n_layers"],
                                      seed, endpoint, group, device).items():
                have[name].copy_(t)
    return params
