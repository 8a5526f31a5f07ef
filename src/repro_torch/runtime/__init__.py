"""Runtime: fault tolerance for training (``runtime.fault_tolerance``),
elastic re-sharding of checkpoints (``runtime.elastic``) and straggler
mitigation for the fleet simulation (the port of ``repro/runtime``)."""
from .straggler import HedgePolicy

__all__ = ["HedgePolicy"]
