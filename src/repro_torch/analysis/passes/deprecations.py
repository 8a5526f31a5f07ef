"""Pass 6 — deprecation hygiene: removed entry points stay removed.

The reference deleted the ``simulate*`` free functions and
``Trace.synthesize`` in favor of the declarative ``experiment.run(trace,
spec)`` / ``WorkloadSpec`` API, and the port never had them. This pass
keeps them out at lint time: calling or importing a removed name (or
touching ``.synthesize`` on anything) is flagged with the replacement
spelled out. A module that *defines* one of these names locally (the
fixtures, or a tombstone table) is of course free to mention it.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, Set

from ..framework import Finding, LintConfig, Module, Rule, dotted_name


def _locally_defined(tree: ast.Module) -> Set[str]:
    defined: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            defined.add(node.name)
        elif isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    defined.add(tgt.id)
    return defined


class DeprecationHygiene(Rule):
    name = "deprecation-hygiene"
    description = "use of removed simulate*/Trace.synthesize entry points"

    def check(self, module: Module, config: LintConfig) -> Iterator[Finding]:
        removed: Dict[str, str] = dict(config.removed_calls)
        removed_attrs: Dict[str, str] = dict(config.removed_attrs)
        defined = _locally_defined(module.tree)
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Call):
                name = dotted_name(node.func)
                if name is None:
                    continue
                tail = name.rpartition(".")[2]
                if tail in removed and tail not in defined:
                    yield self.finding(
                        module, node,
                        f"{tail}() was removed; use {removed[tail]}")
            elif isinstance(node, ast.ImportFrom):
                for alias in node.names:
                    if alias.name in removed:
                        yield self.finding(
                            module, node,
                            f"import of removed {alias.name!r}; use "
                            f"{removed[alias.name]}")
            elif isinstance(node, ast.Attribute):
                if node.attr in removed_attrs and node.attr not in defined:
                    yield self.finding(
                        module, node,
                        f".{node.attr} was removed; use "
                        f"{removed_attrs[node.attr]}")
