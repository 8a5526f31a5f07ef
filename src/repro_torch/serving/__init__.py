"""Serving: a serverless model platform (the paper's policy as the warm
pool's residency policy) in front of a real engine.

:class:`~repro_torch.serving.registry.Registry` holds the endpoints,
:class:`~repro_torch.serving.warmpool.WarmPool` decides when each one's
weights are on the device, and
:class:`~repro_torch.serving.engine.ServeEngine` loads them and runs
prefill and decode."""
from .engine import ServeEngine
from .registry import ModelEndpoint, Registry
from .warmpool import AppState, PoolStats, WarmPool

__all__ = ["ServeEngine", "ModelEndpoint", "Registry", "AppState",
           "PoolStats", "WarmPool"]
