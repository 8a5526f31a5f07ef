"""Pass 5 — pytree registration completeness.

The spec dataclasses (PolicySpec family, WorkloadSpec/Cohort, ...) are
registered as pytrees so grids of them can ride through ``vmap`` and
``tree_map`` (``torch.utils._pytree.register_pytree_node(cls, flatten,
unflatten)`` has JAX's name and argument order; the port registers none
today, so the rule guards the first that does). A field that lands in
*neither* the children nor the aux_data silently disappears on every flatten/unflatten roundtrip — specs
come back with defaults and sweeps quietly run the wrong experiment.
Three registration spellings are audited:

  * ``_register_pytree(Cls, meta=(...))`` — the repo helper flattens
    "every dataclass field not named in ``meta``", so the only failure
    mode is a typo'd meta name: every meta entry must be a real field;
  * raw ``register_pytree_node(Cls, flatten, unflatten)`` — the flatten
    callable must mention every dataclass field (attribute access or
    string key); ``dataclasses.fields/astuple/asdict`` counts as full
    coverage;
  * ``@register_pytree_node_class`` — same coverage check against the
    class's ``tree_flatten`` method.

Only classes defined (as dataclasses) in the same module are checked —
cross-module registration is rare here and out of reach for an
intraprocedural pass.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set

from ..framework import (Finding, LintConfig, Module, Rule, dotted_name,
                         terminal_name)

_FULL_COVERAGE_CALLS = {"fields", "astuple", "asdict"}


def _dataclass_fields(cls: ast.ClassDef) -> Optional[List[str]]:
    """Field names if ``cls`` is a dataclass we can read, else None."""
    is_dc = False
    for dec in cls.decorator_list:
        name = dotted_name(dec.func if isinstance(dec, ast.Call) else dec)
        if name in ("dataclass", "dataclasses.dataclass"):
            is_dc = True
    if not is_dc:
        return None
    fields: List[str] = []
    for stmt in cls.body:
        if isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target,
                                                          ast.Name):
            ann = stmt.annotation
            ann_txt = ast.dump(ann)
            if "ClassVar" in ann_txt:
                continue
            fields.append(stmt.target.id)
    return fields


def _str_tuple(node: ast.AST) -> List[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [node.value]
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        return [el.value for el in node.elts
                if isinstance(el, ast.Constant) and isinstance(el.value, str)]
    return []


def _mentioned_fields(func: ast.AST) -> Optional[Set[str]]:
    """Field-ish names a flatten body touches; None => full coverage
    (iterates ``dataclasses.fields``/``astuple``/``asdict``)."""
    mentioned: Set[str] = set()
    for node in ast.walk(func):
        if isinstance(node, ast.Call):
            tn = terminal_name(node.func)
            if tn in _FULL_COVERAGE_CALLS:
                return None
        if isinstance(node, ast.Attribute):
            mentioned.add(node.attr)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            mentioned.add(node.value)
    return mentioned


class PytreeCompleteness(Rule):
    name = "pytree-completeness"
    description = ("registered dataclasses whose flatten drops fields "
                   "(neither children nor aux_data)")

    def check(self, module: Module, config: LintConfig) -> Iterator[Finding]:
        classes: Dict[str, ast.ClassDef] = {}
        funcs: Dict[str, ast.AST] = {}
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ClassDef):
                classes.setdefault(node.name, node)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                funcs.setdefault(node.name, node)
            elif isinstance(node, ast.Assign) and isinstance(node.value,
                                                             ast.Lambda):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        funcs.setdefault(tgt.id, node.value)

        for node in ast.walk(module.tree):
            if isinstance(node, ast.Call):
                tn = terminal_name(node.func)
                if tn in config.register_helpers:
                    yield from self._check_helper(module, node, classes)
                elif tn == "register_pytree_node":
                    yield from self._check_raw(module, node, classes, funcs)
        for cls in classes.values():
            if any(terminal_name(d.func if isinstance(d, ast.Call) else d)
                   == "register_pytree_node_class"
                   for d in cls.decorator_list):
                yield from self._check_node_class(module, cls)

    # -- _register_pytree(Cls, meta=(...)) -----------------------------------

    def _check_helper(self, module: Module, call: ast.Call,
                      classes: Dict[str, ast.ClassDef]) -> Iterator[Finding]:
        if not call.args:
            return
        cls_name = dotted_name(call.args[0])
        cls = classes.get(cls_name or "")
        if cls is None:
            return
        fields = _dataclass_fields(cls)
        if fields is None:
            return
        meta_node = call.args[1] if len(call.args) > 1 else next(
            (kw.value for kw in call.keywords if kw.arg == "meta"), None)
        meta = _str_tuple(meta_node) if meta_node is not None else []
        for name in meta:
            if name not in fields:
                yield self.finding(
                    module, call,
                    f"meta field {name!r} is not a field of {cls_name}: the "
                    "typo'd entry never moves to aux_data and getattr will "
                    "fail (or silently mis-flatten) at trace time")

    # -- register_pytree_node(Cls, flatten, unflatten) -----------------------

    def _check_raw(self, module: Module, call: ast.Call,
                   classes: Dict[str, ast.ClassDef],
                   funcs: Dict[str, ast.AST]) -> Iterator[Finding]:
        if len(call.args) < 2:
            return
        cls_name = dotted_name(call.args[0])
        cls = classes.get(cls_name or "")
        if cls is None:
            return
        fields = _dataclass_fields(cls)
        if not fields:
            return
        flat = call.args[1]
        func = flat if isinstance(flat, ast.Lambda) \
            else funcs.get(dotted_name(flat) or "")
        if func is None:
            return
        yield from self._coverage(module, call, cls_name, fields, func)

    # -- @register_pytree_node_class -----------------------------------------

    def _check_node_class(self, module: Module,
                          cls: ast.ClassDef) -> Iterator[Finding]:
        fields = _dataclass_fields(cls)
        if not fields:
            return
        flatten = next((n for n in cls.body
                        if isinstance(n, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))
                        and n.name == "tree_flatten"), None)
        if flatten is None:
            return
        yield from self._coverage(module, flatten, cls.name, fields, flatten)

    def _coverage(self, module: Module, site: ast.AST, cls_name: str,
                  fields: List[str], func: ast.AST) -> Iterator[Finding]:
        mentioned = _mentioned_fields(func)
        if mentioned is None:
            return
        missing = [f for f in fields if f not in mentioned]
        if missing:
            yield self.finding(
                module, site,
                f"flatten for {cls_name} drops field(s) {missing}: values "
                "land in neither children nor aux_data and reset to "
                "defaults on every unflatten")
