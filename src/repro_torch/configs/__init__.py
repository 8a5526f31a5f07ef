"""Architecture registry: ``get(<arch id>)`` resolves through here.

The port's own copy of the reference's configuration data (the same ten
architectures, fields and defaults), so that ``get()`` resolves the same
ids without importing the reference package."""
from .base import ModelConfig, ShapeConfig, SHAPES, reduced
from . import (smollm_135m, qwen2_72b, qwen2_7b, deepseek_67b, mamba2_2p7b,
               qwen3_moe_30b_a3b, olmoe_1b_7b, recurrentgemma_2b,
               llava_next_34b, seamless_m4t_medium)

ARCHS = {m.CONFIG.arch_id: m.CONFIG for m in (
    smollm_135m, qwen2_72b, qwen2_7b, deepseek_67b, mamba2_2p7b,
    qwen3_moe_30b_a3b, olmoe_1b_7b, recurrentgemma_2b, llava_next_34b,
    seamless_m4t_medium,
)}

# Sub-quadratic archs run the long_500k shape; pure full-attention archs
# skip it.
SUBQUADRATIC = {"mamba2-2.7b", "recurrentgemma-2b"}


def get(arch_id: str) -> ModelConfig:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch '{arch_id}'; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]


def cells(include_skipped: bool = False):
    """Yield every (arch_id, shape_name) dry-run cell; with
    ``include_skipped`` every (arch_id, shape_name, status) with status
    ``"run"`` or ``"skip:full-attention"`` (long_500k on a pure
    full-attention arch)."""
    for arch_id in ARCHS:
        for shape in SHAPES.values():
            if shape.name == "long_500k" and arch_id not in SUBQUADRATIC:
                if include_skipped:
                    yield arch_id, shape.name, "skip:full-attention"
                continue
            if include_skipped:
                yield arch_id, shape.name, "run"
            else:
                yield arch_id, shape.name


__all__ = ["ARCHS", "SHAPES", "SUBQUADRATIC", "get", "cells", "ModelConfig",
           "ShapeConfig", "reduced"]
