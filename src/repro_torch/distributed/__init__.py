"""Multi-device layers of the port (the port of ``repro/distributed``).

:mod:`~repro_torch.distributed.scaleout` splits the simulator's app axis
across devices (``EngineOptions(devices=)``, ``run_cluster(devices=)``).
The model layers run one process per device on a ``DeviceMesh``:
:mod:`~repro_torch.distributed.sharding` (the plan: specs and their DTensor
placements), :mod:`~repro_torch.distributed.ctx` (the active mesh and
activation hints), :mod:`~repro_torch.distributed.compat` (``shard_map``
and the named-axis collectives), :mod:`~repro_torch.distributed.pipeline`,
:mod:`~repro_torch.distributed.dist_decode` and
:mod:`~repro_torch.distributed.compression`.
"""
