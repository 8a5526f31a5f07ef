"""Runtime: fault tolerance for training (``runtime.fault_tolerance``) and
straggler mitigation for the fleet simulation (the port of
``repro/runtime``; elastic scaling comes with the multi-device layers,
ROADMAP Queue A item 6)."""
from .straggler import HedgePolicy

__all__ = ["HedgePolicy"]
