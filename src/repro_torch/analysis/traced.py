"""Hot-context discovery: where a host sync stalls the card.

The reference finds the regions JAX traces (``jax.jit``, ``lax.scan`` step
bodies, ``pl.pallas_call`` kernels). The port has none of them: its
kernels are CUDA C++ under ``kernels/csrc/``, which a Python AST pass
cannot read, and its scans are Python loops that launch device work column
by column. Four syntactic sources, matching how the port runs its hot
paths:

  * functions decorated with, or passed as the first argument of,
    ``torch.compile`` / ``torch.jit.script`` / ``torch.jit.trace`` (the
    ``functools.partial`` spelling too): a host sync there is a graph
    break;
  * functions (or lambdas) passed to ``torch.vmap`` / ``torch.func.vmap``:
    a host read of a batched value raises;
  * bodies of ``with torch.cuda.graph(...)``: a sync inside a capture
    fails it;
  * **scan bodies**: every ``for``/``while`` loop in a function whose name
    matches :attr:`LintConfig.scan_function_pattern` — ``for t_now in
    cols`` over a chunk's event columns is the port's ``lax.scan``, and a
    sync in it serializes the loop on the card (one round trip a column).

Traced values are the context function's non-scalar parameters (a
parameter annotated ``int``/``float``/``bool``/``str`` or defaulted to
such a constant is a host value), the targets of its loops (not a
``range`` counter or an ``enumerate`` index), and, inside a CUDA-graph
capture, every name the capture binds. Everything is intraprocedural:
helpers *called from* a hot context are not visited.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from typing import Dict, List, Optional, Set, Union

from .framework import LintConfig, dotted_name

__all__ = ["HotContext", "find_hot_contexts"]

FuncNode = Union[ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda]

_COMPILE_NAMES = {"torch.compile", "torch.jit.script", "torch.jit.trace",
                  "jit.script", "jit.trace"}
_VMAP_NAMES = {"torch.vmap", "torch.func.vmap", "func.vmap", "vmap"}
_GRAPH_NAMES = {"torch.cuda.graph", "cuda.graph"}
_PARTIAL_NAMES = {"partial", "functools.partial"}
_SCALAR_ANNOTATIONS = {"int", "float", "bool", "str", "bytes", "None",
                       "Optional", "Union"}
_HOST_PARAMS = {"self", "cls"}
_NESTED = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)


@dataclasses.dataclass
class HotContext:
    kind: str                    # "compile" | "vmap" | "cuda-graph" |
    #                              "scan-body"
    func_name: str               # the function it lies in ("<module>")
    nodes: List[ast.AST]         # what runs hot (statements or an expr)
    traced: Set[str]             # names holding device values there


def _is_scalar_param(arg: ast.arg, default: Optional[ast.AST]) -> bool:
    if arg.annotation is not None:
        names = {n.id for n in ast.walk(arg.annotation)
                 if isinstance(n, ast.Name)}
        names |= {n.value for n in ast.walk(arg.annotation)
                  if isinstance(n, ast.Constant) and isinstance(n.value, str)}
        if isinstance(arg.annotation, ast.Constant) and \
                arg.annotation.value is None:
            names.add("None")
        return bool(names) and names <= _SCALAR_ANNOTATIONS
    return isinstance(default, ast.Constant) and \
        isinstance(default.value, (bool, int, float, str))


def traced_params(func: FuncNode) -> Set[str]:
    """The parameters of ``func`` that may hold tensors."""
    a = func.args
    positional = [*a.posonlyargs, *a.args]
    defaults: List[Optional[ast.AST]] = \
        [None] * (len(positional) - len(a.defaults)) + list(a.defaults)
    pairs = list(zip(positional, defaults)) + \
        list(zip(a.kwonlyargs, a.kw_defaults))
    out = {arg.arg for arg, default in pairs
           if not _is_scalar_param(arg, default)}
    for extra in (a.vararg, a.kwarg):
        if extra is not None:
            out.add(extra.arg)
    return out - _HOST_PARAMS


def _target_names(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _loop_traced(loop: ast.For) -> Set[str]:
    """Names a ``for`` binds to device values: not a ``range`` counter,
    not the index of an ``enumerate``."""
    it = loop.iter
    name = dotted_name(it.func) if isinstance(it, ast.Call) else None
    if name == "range":
        return set()
    if name == "enumerate" and isinstance(loop.target, ast.Tuple) and \
            len(loop.target.elts) == 2:
        return _target_names(loop.target.elts[1])
    return _target_names(loop.target)


def _bound_names(stmts: List[ast.stmt]) -> Set[str]:
    out: Set[str] = set()
    for stmt in stmts:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
                out.add(node.id)
    return out


def _walk_local(nodes: List[ast.AST]):
    """Every node under ``nodes`` that is not inside a nested function or
    class (those are contexts of their own)."""
    todo = list(nodes)
    while todo:
        node = todo.pop()
        if isinstance(node, _NESTED):
            continue
        yield node
        todo.extend(ast.iter_child_nodes(node))


def _outer_loops(stmts: List[ast.stmt]) -> List[ast.AST]:
    """The loops of a function body that no other loop of it encloses."""
    out: List[ast.AST] = []
    todo = list(stmts)
    while todo:
        node = todo.pop(0)
        if isinstance(node, _NESTED):
            continue
        if isinstance(node, (ast.For, ast.AsyncFor, ast.While)):
            out.append(node)
            continue
        todo.extend(ast.iter_child_nodes(node))
    return out


def _loop_region(loop: ast.AST) -> List[ast.AST]:
    """What runs once per iteration: a ``for``'s body (its iterable is
    evaluated once), a ``while``'s test and body."""
    if isinstance(loop, ast.While):
        return [loop]
    return [*loop.body, *loop.orelse]


def _func_body(func: FuncNode) -> List[ast.AST]:
    return [func.body] if isinstance(func, ast.Lambda) else list(func.body)


def _callable_target(node: ast.AST,
                     by_name: Dict[str, FuncNode]) -> Optional[FuncNode]:
    """Resolve a callable expression to a local function/lambda node."""
    if isinstance(node, ast.Lambda):
        return node
    name = dotted_name(node)
    if name is not None:
        return by_name.get(name)
    if isinstance(node, ast.Call) and \
            dotted_name(node.func) in _PARTIAL_NAMES and node.args:
        return _callable_target(node.args[0], by_name)
    return None


def _decorator_kind(dec: ast.AST) -> Optional[str]:
    for node in (dec, dec.func if isinstance(dec, ast.Call) else None):
        name = dotted_name(node) if node is not None else None
        if name in _COMPILE_NAMES:
            return "compile"
        if name in _VMAP_NAMES:
            return "vmap"
    if isinstance(dec, ast.Call) and \
            dotted_name(dec.func) in _PARTIAL_NAMES and dec.args:
        return _decorator_kind(dec.args[0])
    return None


def _func_name(func: FuncNode) -> str:
    return getattr(func, "name", "<lambda>")


def find_hot_contexts(tree: ast.Module,
                      config: Optional[LintConfig] = None
                      ) -> List[HotContext]:
    config = config or LintConfig()
    scan_re = re.compile(config.scan_function_pattern)
    by_name: Dict[str, FuncNode] = {}
    funcs: List[FuncNode] = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            by_name.setdefault(node.name, node)
            funcs.append(node)
        elif isinstance(node, ast.Assign) and isinstance(node.value,
                                                         ast.Lambda):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    by_name.setdefault(tgt.id, node.value)

    out: List[HotContext] = []
    seen: Set[int] = set()

    def add_func(func: Optional[FuncNode], kind: str) -> None:
        if func is None or id(func) in seen:
            return
        seen.add(id(func))
        body = _func_body(func)
        traced = traced_params(func)
        for loop in _walk_local(body):
            if isinstance(loop, (ast.For, ast.AsyncFor)):
                traced |= _loop_traced(loop)
        out.append(HotContext(kind, _func_name(func), body, traced))

    for func in funcs:
        for dec in func.decorator_list:
            kind = _decorator_kind(dec)
            if kind is not None:
                add_func(func, kind)

    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and node.args:
            name = dotted_name(node.func)
            if name in _COMPILE_NAMES:
                add_func(_callable_target(node.args[0], by_name), "compile")
            elif name in _VMAP_NAMES:
                add_func(_callable_target(node.args[0], by_name), "vmap")

    for func in (None, *funcs):
        body = tree.body if func is None else func.body
        for node in _walk_local(list(body)):
            if not (isinstance(node, (ast.With, ast.AsyncWith)) and any(
                    isinstance(item.context_expr, ast.Call)
                    and dotted_name(item.context_expr.func) in _GRAPH_NAMES
                    for item in node.items)):
                continue
            traced = _bound_names(node.body)
            if func is not None:
                traced |= traced_params(func)
            for loop in _walk_local(node.body):
                if isinstance(loop, (ast.For, ast.AsyncFor)):
                    traced -= _target_names(loop.target)
                    traced |= _loop_traced(loop)
            out.append(HotContext(
                "cuda-graph", func.name if func else "<module>",
                list(node.body), traced))

    for func in funcs:
        if not scan_re.search(func.name):
            continue
        params = traced_params(func)
        for loop in _outer_loops(func.body):
            traced = set(params)
            for sub in _walk_local([loop]):
                if isinstance(sub, (ast.For, ast.AsyncFor)):
                    traced |= _loop_traced(sub)
            out.append(HotContext("scan-body", func.name,
                                  _loop_region(loop), traced))
    return out
