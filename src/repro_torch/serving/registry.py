"""Model registry: the serverless platform's "application" catalog.

Each endpoint is a deployed model (an application in the paper's sense):
architecture config + weights seed + the cold-start cost model inputs
(weight bytes, estimated compile seconds). The registry is what the warm
pool resolves app ids against. The port of ``repro/serving/registry.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

from ..configs.base import ModelConfig
from ..models import n_params

__all__ = ["H2D_BANDWIDTH", "BASE_LOAD_LATENCY", "COMPILE_MISS_LATENCY",
           "ModelEndpoint", "Registry"]

# Cold-start cost model constants: weights move host->HBM over PCIe-class
# links; a compile-cache miss adds compilation time.
H2D_BANDWIDTH = 25e9          # bytes/s host->device
BASE_LOAD_LATENCY = 0.15      # s — allocation, runtime bookkeeping
COMPILE_MISS_LATENCY = 8.0    # s — compile on executable-cache miss


@dataclasses.dataclass
class ModelEndpoint:
    app_id: str
    cfg: ModelConfig
    seed: int = 0
    replicas: int = 1
    weight_bytes: int = 0          # 0 -> derived from cfg (bf16)
    avg_request_s: float = 0.5     # mean request execution time
    init: str = "reference"        # the weights' draw (Model.init scheme)

    def __post_init__(self):
        if not self.weight_bytes:
            self.weight_bytes = 2 * n_params(self.cfg)

    def cold_start_seconds(self, compile_cached: bool) -> float:
        t = BASE_LOAD_LATENCY + self.weight_bytes / H2D_BANDWIDTH
        if not compile_cached:
            t += COMPILE_MISS_LATENCY
        return t


class Registry:
    def __init__(self):
        self._apps: Dict[str, ModelEndpoint] = {}

    def register(self, ep: ModelEndpoint) -> None:
        self._apps[ep.app_id] = ep

    def get(self, app_id: str) -> ModelEndpoint:
        return self._apps[app_id]

    def __contains__(self, app_id: str) -> bool:
        return app_id in self._apps

    def __iter__(self) -> Iterator[ModelEndpoint]:
        return iter(self._apps.values())

    def __len__(self) -> int:
        return len(self._apps)
