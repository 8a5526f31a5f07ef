"""Serving: a serverless model platform (the paper's policy as the warm
pool's residency policy) in front of a real engine.

:class:`~repro_torch.serving.registry.Registry` holds the endpoints,
:class:`~repro_torch.serving.warmpool.WarmPool` decides when each one's
weights are on the device, and
:class:`~repro_torch.serving.engine.ServeEngine` loads them and runs
prefill and decode.

Fleet simulation (the paper's §5.3 cluster: N invoker workers, each with
its own warm pool) lives in two engines over one columnar
:class:`~repro_torch.serving.apptable.AppTable`: the per-event oracle
(:mod:`~repro_torch.serving.cluster_sim`) and the vectorized engine
(:mod:`~repro_torch.serving.cluster_vector`)."""
from .apptable import AppTable, fnv1a64, fnv1a64_app_indices
from .cluster_sim import ClusterConfig, ClusterResult, ClusterSim
from .cluster_vector import (CLUSTER_ENGINES, ClusterSpec, ClusterSweep,
                             EvictionRoundsExceeded, run_cluster,
                             sweep_cluster)
from .engine import ServeEngine
from .registry import ModelEndpoint, Registry
from .warmpool import AppState, PoolStats, WarmPool

__all__ = ["ServeEngine", "ModelEndpoint", "Registry", "AppState",
           "PoolStats", "WarmPool", "AppTable", "fnv1a64",
           "fnv1a64_app_indices", "ClusterConfig", "ClusterResult",
           "ClusterSim", "CLUSTER_ENGINES", "ClusterSpec", "ClusterSweep",
           "EvictionRoundsExceeded", "run_cluster", "sweep_cluster"]
