"""Multi-device layers of the port (the port of ``repro/distributed``).

:mod:`repro_torch.distributed.scaleout` splits the simulator's app axis
across devices (``EngineOptions(devices=)``, ``run_cluster(devices=)``).
"""
