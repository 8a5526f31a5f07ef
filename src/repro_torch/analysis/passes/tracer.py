"""Pass 3 — host syncs in scan bodies, captures and compiled functions.

The port's hot path is a Python loop that launches device work one event
column at a time (and, at the kernel level, one launch a chunk). A host
read of a device value inside that loop — ``.item()``, ``.cpu()``, a
python ``if`` on a tensor — waits for the card every column, so the loop
runs at the host's round-trip rate instead of the card's: the host idle
the port's measurements keep finding. Inside a CUDA-graph capture the same
read fails the capture; inside a ``torch.compile`` target it is a graph
break. Inside the contexts discovered by :mod:`repro_torch.analysis.traced`
this pass flags:

  * ``if``/``while`` whose condition reads a traced value (shape, dtype,
    ndim and size probes and ``isinstance`` tests are host constants and
    exempt, and so is an ``is``/``is not`` test);
  * ``float()`` / ``int()`` / ``bool()`` of a traced value;
  * ``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()`` /
    ``.synchronize()`` / ``.to("cpu")``, ``np.asarray`` / ``np.array`` —
    host syncs regardless of argument.

A value is traced when it is one of the context's traced names (see
:mod:`repro_torch.analysis.traced`) or is assigned, inside the region,
from one.

The analysis is intraprocedural: helpers *called from* a hot context
(e.g. the policy_math step functions) are not entered.
"""
from __future__ import annotations

import ast
from typing import Iterator, Set

from ..framework import Finding, LintConfig, Module, Rule, dotted_name
from ..traced import find_hot_contexts

_STATIC_ATTRS = {"shape", "ndim", "dtype", "size"}
_PY_CASTS = {"float", "int", "bool"}
_HOST_SYNC_CALLS = {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize"}


def _names_in(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _static_probe_names(node: ast.AST) -> Set[str]:
    """Names only used under shape/ndim/dtype/size probes, isinstance or
    an identity test — host constants, safe to branch on."""
    exempt: Set[str] = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr in _STATIC_ATTRS:
            exempt |= _names_in(sub.value)
        elif isinstance(sub, ast.Call) and \
                dotted_name(sub.func) == "isinstance":
            exempt |= _names_in(sub)
        elif isinstance(sub, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot)) for op in sub.ops):
            exempt |= _names_in(sub)     # "x is None": identity, no sync
    return exempt


def _propagate(nodes, traced: Set[str]) -> Set[str]:
    """``traced`` plus every name the region assigns from a traced value
    (``valid = torch.isfinite(t_now)``), to a fixed point; a value read
    only through a static probe (``n = x.shape[0]``) stays a host value."""
    assigns = []
    for stmt in nodes:
        for node in ast.walk(stmt):
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign,
                                 ast.NamedExpr)) and node.value is not None:
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                stores = set().union(*(_names_in(t) for t in targets))
                reads = _names_in(node.value) - \
                    _static_probe_names(node.value)
                assigns.append((stores, reads))
    out = set(traced)
    changed = True
    while changed:
        changed = False
        for stores, reads in assigns:
            if reads & out and not stores <= out:
                out |= stores
                changed = True
    return out


def _to_cpu(node: ast.Call) -> bool:
    """``x.to("cpu")`` / ``x.to(device="cpu")``."""
    args = list(node.args[:1]) + [kw.value for kw in node.keywords
                                  if kw.arg == "device"]
    return any(isinstance(a, ast.Constant) and a.value == "cpu"
               for a in args)


class TracerLeak(Rule):
    name = "tracer-leak"
    description = ("host syncs (.item()/.cpu()/float()/python if on a "
                   "tensor) inside scan loops, CUDA-graph captures and "
                   "torch.compile/vmap targets")

    def check(self, module: Module, config: LintConfig) -> Iterator[Finding]:
        seen: Set[int] = set()
        for ctx in find_hot_contexts(module.tree, config):
            traced = _propagate(ctx.nodes, ctx.traced)
            for stmt in ctx.nodes:
                for node in ast.walk(stmt):
                    if id(node) in seen:
                        continue     # regions may nest: report once
                    seen.add(id(node))
                    yield from self._check_node(module, node, traced,
                                                ctx.kind)

    def _check_node(self, module: Module, node: ast.AST,
                    traced: Set[str], kind: str) -> Iterator[Finding]:
        if isinstance(node, (ast.If, ast.While)):
            hot = (_names_in(node.test) - _static_probe_names(node.test)) \
                & traced
            if hot:
                kw = "while" if isinstance(node, ast.While) else "if"
                yield self.finding(
                    module, node,
                    f"python '{kw}' on traced value(s) {sorted(hot)} inside "
                    f"a {kind}: a device->host sync each time — keep it a "
                    "tensor (torch.where) or decide on the host before the "
                    "loop")
        elif isinstance(node, ast.Call):
            name = dotted_name(node.func)
            if name in _PY_CASTS and node.args:
                hot = (_names_in(node.args[0])
                       - _static_probe_names(node.args[0])) & traced
                if hot:
                    yield self.finding(
                        module, node,
                        f"{name}() of traced value(s) {sorted(hot)} inside "
                        f"a {kind}: forces a host sync — keep it a tensor "
                        "(.to(dtype)) or compute it outside the hot region")
            elif name in _HOST_SYNC_CALLS:
                yield self.finding(
                    module, node,
                    f"{name}() inside a {kind}: device->host transfer "
                    "serializes the loop — move result assembly outside "
                    "the hot region")
            elif isinstance(node.func, ast.Attribute) and (
                    node.func.attr in _SYNC_METHODS
                    or (node.func.attr == "to" and _to_cpu(node))):
                yield self.finding(
                    module, node,
                    f".{node.func.attr}() inside a {kind}: waits for the "
                    "card on every pass")
