"""Pass 1 — single-sourced decision math (the "grep invariant").

Every engine reproduces the paper's §4 policy bit-exactly because the
percentile/margin/verdict arithmetic is written ONCE, in
:mod:`repro_torch.core.policy_math` (the port's copy of the reference's
module, itself held bit for bit against it). Re-deriving any of it
elsewhere (even "equivalently") brings back float-rounding parity bugs.
Outside that module this pass flags:

  * ``PCT_SCALE`` used in arithmetic or comparisons — scaled-percentile
    math belongs behind ``percentile_threshold_scaled*`` /
    ``first_bin_ge_scaled``;
  * ``1 ± margin`` expressions — callers must use ``margin_factors`` (the
    host-side single rounding is what makes traced margin axes bit-equal);
  * inline warm-verdict conjunctions (``it >= load & it <= unload``) —
    callers must use ``warm_from_bounds`` / ``idle_from_bounds``.

Passing ``PCT_SCALE`` around as an opaque value (imports, function
arguments) is fine; only *doing math* with it is flagged.
"""
from __future__ import annotations

import ast
import re
from typing import Iterator, Optional, Tuple

from ..framework import Finding, LintConfig, Module, Rule, terminal_name

_MARGIN_RE = re.compile(r"margin", re.IGNORECASE)
# Dtype casts are transparent when deciding whether PCT_SCALE feeds
# arithmetic: ``x * np.int32(PCT_SCALE)`` is still scaled-threshold math.
_CAST_NAMES = {"int8", "int16", "int32", "int64", "uint8", "uint16",
               "uint32", "uint64", "float32", "float64", "astype",
               "asarray", "array"}
_LOAD_RE = re.compile(r"(?:^|_)(?:load|prewarm|pre_warm)", re.IGNORECASE)
_UNLOAD_RE = re.compile(r"(?:^|_)(?:unload|keep)", re.IGNORECASE)


def _build_parents(tree: ast.AST) -> dict:
    parents = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[id(child)] = node
    return parents


class SingleSourceDecisionMath(Rule):
    name = "single-source-decision-math"
    description = ("percentile/margin/verdict/PCT_SCALE arithmetic outside "
                   "core/policy_math.py")

    def check(self, module: Module, config: LintConfig) -> Iterator[Finding]:
        if module.relkey == config.policy_math_relkey:
            return
        parents = _build_parents(module.tree)
        for node in ast.walk(module.tree):
            yield from self._check_pct_scale(module, node, parents)
            yield from self._check_margin(module, node)
            yield from self._check_verdict(module, node)

    # -- PCT_SCALE arithmetic ------------------------------------------------

    def _check_pct_scale(self, module: Module, node: ast.AST,
                         parents: dict) -> Iterator[Finding]:
        if terminal_name(node) != "PCT_SCALE":
            return
        cur = parents.get(id(node))
        # skip the attribute chain the name sits in (policy_math.PCT_SCALE)
        while isinstance(cur, ast.Attribute):
            cur = parents.get(id(cur))
        while cur is not None:
            if isinstance(cur, (ast.BinOp, ast.Compare, ast.UnaryOp,
                                ast.BoolOp)):
                yield self.finding(
                    module, node,
                    "PCT_SCALE arithmetic outside core/policy_math.py; use "
                    "percentile_threshold_scaled*/first_bin_ge_scaled (or "
                    "add a policy_math helper)")
                return
            if isinstance(cur, ast.Call) and \
                    terminal_name(cur.func) in _CAST_NAMES:
                cur = parents.get(id(cur))   # see through dtype casts
                continue
            if isinstance(cur, (ast.stmt, ast.Call)):
                return        # opaque use: argument / assignment / import
            cur = parents.get(id(cur))

    # -- 1 +/- margin --------------------------------------------------------

    def _check_margin(self, module: Module,
                      node: ast.AST) -> Iterator[Finding]:
        if not (isinstance(node, ast.BinOp)
                and isinstance(node.op, (ast.Add, ast.Sub))):
            return
        sides = (node.left, node.right)
        has_one = any(isinstance(s, ast.Constant) and s.value in (1, 1.0)
                      for s in sides)
        margin = any(
            (t := terminal_name(s)) is not None and _MARGIN_RE.search(t)
            for s in sides)
        if has_one and margin:
            yield self.finding(
                module, node,
                "inline '1 +/- margin' arithmetic; use "
                "policy_math.margin_factors (one host-side rounding keeps "
                "traced margin axes bit-identical)")

    # -- warm-verdict conjunction -------------------------------------------

    def _check_verdict(self, module: Module,
                       node: ast.AST) -> Iterator[Finding]:
        if isinstance(node, ast.BoolOp) and isinstance(node.op, ast.And):
            operands = node.values
        elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.BitAnd):
            operands = [node.left, node.right]
        else:
            return
        lower: dict = {}
        upper: dict = {}
        for op in operands:
            cmp = self._normalized_compare(op)
            if cmp is None:
                continue
            subject, bound, kind = cmp
            (lower if kind == "lower" else upper)[subject] = bound
        for subject in set(lower) & set(upper):
            if _LOAD_RE.search(lower[subject]) and \
                    _UNLOAD_RE.search(upper[subject]):
                yield self.finding(
                    module, node,
                    f"inline warm-verdict conjunction on {subject!r}; use "
                    "policy_math.warm_from_bounds / idle_from_bounds")
                return

    @staticmethod
    def _normalized_compare(node: ast.AST
                            ) -> Optional[Tuple[str, str, str]]:
        """``x >= load`` / ``load <= x`` -> ("x", "load", "lower")."""
        if not (isinstance(node, ast.Compare) and len(node.ops) == 1):
            return None
        left = terminal_name(node.left)
        right = terminal_name(node.comparators[0])
        if left is None or right is None:
            return None
        op = node.ops[0]
        if isinstance(op, (ast.GtE, ast.Gt)):     # x >= bound
            subject, bound, kind = left, right, "lower"
        elif isinstance(op, (ast.LtE, ast.Lt)):   # x <= bound
            subject, bound, kind = left, right, "upper"
        else:
            return None
        if _LOAD_RE.search(subject) or _UNLOAD_RE.search(subject):
            # reversed spelling: bound on the left ("load <= x")
            subject, bound = bound, subject
            kind = "upper" if kind == "lower" else "lower"
        return subject, bound, kind
