"""Runtime: straggler mitigation for the fleet simulation (the port of
``repro/runtime``; fault tolerance and elastic scaling are not here yet)."""
from .straggler import HedgePolicy

__all__ = ["HedgePolicy"]
