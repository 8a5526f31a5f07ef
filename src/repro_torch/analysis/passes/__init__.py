"""The concrete pass suite — one rule per cross-cutting repo contract."""
from __future__ import annotations

from typing import Dict, List

from ..framework import Rule
from .conformance import ConformanceCoverage
from .decision_math import SingleSourceDecisionMath
from .deprecations import DeprecationHygiene
from .determinism import Nondeterminism
from .pytree import PytreeCompleteness
from .tracer import TracerLeak
from .x64 import X64Discipline

__all__ = ["ALL_RULES", "rule_by_name"]

ALL_RULES: List[Rule] = [
    SingleSourceDecisionMath(),
    X64Discipline(),
    TracerLeak(),
    Nondeterminism(),
    PytreeCompleteness(),
    DeprecationHygiene(),
    ConformanceCoverage(),
]

_BY_NAME: Dict[str, Rule] = {r.name: r for r in ALL_RULES}


def rule_by_name(name: str) -> Rule:
    try:
        return _BY_NAME[name]
    except KeyError:
        raise KeyError(
            f"unknown rule {name!r}; known: {sorted(_BY_NAME)}") from None
