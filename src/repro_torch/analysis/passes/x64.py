"""Pass 2 — x64 discipline: exact float arithmetic on the card.

The reference's rule guards float32 exactness on a TPU, which has no
float64. The H100 has float64, and the port's kernel engine and its sweep
kernels keep float64 time by design, so float64 in ``kernels/`` is not a
finding here. What breaks the port's exactness is elsewhere. Three
sub-checks:

  * **un-rebased absolute time** (kept from the reference): anywhere,
    casting a variable that *names itself* an absolute-time column
    (``times``, ``t_abs``, ...) straight to float32 is flagged unless the
    enclosing function also rebases (calls a ``*rebase*`` helper).
    Multi-week absolute clocks do not fit float32 — per-chunk float64
    rebasing before the cast is the contract (``simulator._rebase_chunk``).
    Spellings: ``.to(torch.float32)``, ``.float()``,
    ``torch.as_tensor``/``torch.tensor(..., dtype=torch.float32)``,
    ``.astype(np.float32)``, ``np.float32(x)``, ``np.asarray(x,
    np.float32)`` and the reference's own;
  * **inexact nvcc flags**: inside ``kernel_scopes`` a flag that gives up
    IEEE results (``--use_fast_math``, ``-prec-div=false``,
    ``-prec-sqrt=false``, ``-ftz=true``, ``-fmad=true``), and a
    ``SOURCE_FLAGS`` mapping whose bit-exact sources
    (:attr:`LintConfig.bit_exact_sources`) lack ``-fmad=false``: the sweep
    step's and the policy tick's decision layers match the reference bit
    for bit only without multiply-add contraction;
  * **TF32**: anywhere, ``torch.backends.cuda.matmul.allow_tf32`` or
    ``torch.backends.cudnn.allow_tf32`` set to anything but False, an
    ``fp32_precision`` set to anything but ``"ieee"``, and
    ``torch.set_float32_matmul_precision`` with anything but
    ``"highest"``: float32 products would round their inputs to 10 bits.
"""
from __future__ import annotations

import ast
import re
from typing import Iterator, Optional

from ..framework import (Finding, LintConfig, Module, Rule, dotted_name,
                         terminal_name)

# The reference's spellings stay: pointed at the reference's tree, this
# sub-check gives the reference linter's findings.
_F32_CASTERS = {"np.float32", "jnp.float32", "numpy.float32",
                "jax.numpy.float32"}
_ARRAY_CTORS = {"np.asarray", "np.array", "jnp.asarray", "jnp.array",
                "numpy.asarray", "numpy.array", "jax.numpy.asarray",
                "jax.numpy.array", "np.ascontiguousarray",
                "numpy.ascontiguousarray", "torch.as_tensor", "torch.tensor"}
# nvcc flags that trade IEEE results for speed (leading dashes dropped).
# The sweep step and the policy tick are compared bit for bit, the other
# kernels within stated tolerances: none of them may be built so.
_INEXACT_NVCC_FLAGS = {"use_fast_math", "prec-div=false", "prec-sqrt=false",
                       "ftz=true", "fmad=true"}
_TF32_SWITCHES = ("matmul.allow_tf32", "cudnn.allow_tf32")
_EXACT_FMAD = "-fmad=false"


def _is_f32_dtype(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant):
        return node.value == "float32"
    return terminal_name(node) == "float32"


def _nvcc_flag(value: object) -> Optional[str]:
    """``value`` without its leading dashes when it is one nvcc flag (a
    string with no blanks that starts with a dash), else None."""
    if isinstance(value, str) and value.startswith("-") and \
            not any(c.isspace() for c in value):
        return value.lstrip("-")
    return None


def _string_elements(node: Optional[ast.AST]) -> Optional[set]:
    """The strings of a literal tuple/list, or None when it cannot be
    read."""
    if isinstance(node, (ast.Tuple, ast.List)):
        out = set()
        for el in node.elts:
            if not (isinstance(el, ast.Constant)
                    and isinstance(el.value, str)):
                return None
            out.add(el.value)
        return out
    return None


class X64Discipline(Rule):
    name = "x64-discipline"
    description = ("float32 casts of un-rebased absolute-time columns; "
                   "inexact nvcc flags or a bit-exact source without "
                   "-fmad=false; TF32 switched on")

    def check(self, module: Module, config: LintConfig) -> Iterator[Finding]:
        time_re = re.compile(config.time_name_pattern)
        in_kernels = module.in_scope(config.kernel_scopes)
        # map every node to its nearest enclosing function (for the rebase
        # exemption) in one pre-pass
        enclosing = {}
        rebasing_funcs = set()

        def tag(node: ast.AST, func: Optional[ast.AST]) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                func = node
            enclosing[id(node)] = func
            for child in ast.iter_child_nodes(node):
                tag(child, func)

        tag(module.tree, None)
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Call):
                tn = terminal_name(node.func)
                if tn is not None and "rebase" in tn:
                    func = enclosing.get(id(node))
                    if func is not None:
                        rebasing_funcs.add(id(func))

        if in_kernels:
            yield from self._check_source_flags(module, config)
        for node in ast.walk(module.tree):
            if in_kernels:
                yield from self._check_nvcc_flag(module, node, config)
            yield from self._check_tf32(module, node)
            yield from self._check_unrebased_cast(module, node, time_re,
                                                  enclosing, rebasing_funcs)

    # -- kernels: IEEE results ----------------------------------------------

    def _check_nvcc_flag(self, module: Module, node: ast.AST,
                         config: LintConfig) -> Iterator[Finding]:
        if not isinstance(node, ast.Constant):
            return
        flag = _nvcc_flag(node.value)
        if flag in _INEXACT_NVCC_FLAGS:
            yield self.finding(
                module, node,
                f"nvcc flag {node.value!r} in a kernel module: it gives up "
                "IEEE results, and the kernels are held to the plain "
                "versions bit for bit or within stated tolerances")

    def _check_source_flags(self, module: Module,
                            config: LintConfig) -> Iterator[Finding]:
        table = next((stmt.value for stmt in module.tree.body
                      if isinstance(stmt, ast.Assign)
                      and any(isinstance(t, ast.Name)
                              and t.id == "SOURCE_FLAGS"
                              for t in stmt.targets)), None)
        if table is None:
            return
        if not isinstance(table, ast.Dict):
            yield self.finding(
                module, table,
                "SOURCE_FLAGS is not a literal mapping: the linter cannot "
                "check that the bit-exact sources keep -fmad=false")
            return
        entries = {k.value: v for k, v in zip(table.keys, table.values)
                   if isinstance(k, ast.Constant)}
        for stem in config.bit_exact_sources:
            got = _string_elements(entries.get(stem))
            if got is None or _EXACT_FMAD not in got:
                yield self.finding(
                    module, table,
                    f"SOURCE_FLAGS[{stem!r}] lacks {_EXACT_FMAD!r}: nvcc "
                    "would contract its decision math into multiply-adds, "
                    "which round differently from the reference")

    # -- TF32 ---------------------------------------------------------------

    def _check_tf32(self, module: Module, node: ast.AST) -> Iterator[Finding]:
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            value = node.value
            for tgt in targets:
                name = dotted_name(tgt) or ""
                if name.endswith(_TF32_SWITCHES) and not (
                        isinstance(value, ast.Constant)
                        and value.value is False):
                    yield self.finding(
                        module, node,
                        f"{name} switched on: float32 products would run "
                        "in TF32 (10-bit mantissa)")
                elif name.endswith("fp32_precision") and not (
                        isinstance(value, ast.Constant)
                        and value.value == "ieee"):
                    yield self.finding(
                        module, node,
                        f"{name} set to other than 'ieee': float32 "
                        "products may run in TF32")
        elif isinstance(node, ast.Call) and \
                terminal_name(node.func) == "set_float32_matmul_precision":
            arg = node.args[0] if node.args else None
            if not (isinstance(arg, ast.Constant) and
                    arg.value == "highest"):
                yield self.finding(
                    module, node,
                    "set_float32_matmul_precision with other than "
                    "'highest': float32 matmuls may run in TF32")

    # -- float32 cast of absolute time --------------------------------------

    def _check_unrebased_cast(self, module: Module, node: ast.AST,
                              time_re, enclosing: dict,
                              rebasing_funcs: set) -> Iterator[Finding]:
        if not isinstance(node, ast.Call):
            return
        subject = self._cast_subject(node)
        if subject is None:
            return
        tn = terminal_name(subject)
        if tn is None or not time_re.search(tn):
            return
        func = enclosing.get(id(node))
        if func is not None and id(func) in rebasing_funcs:
            return       # the function rebases; trust its data flow
        yield self.finding(
            module, node,
            f"float32 cast of absolute-time column {tn!r} without per-chunk "
            "rebasing: multi-week clocks lose sub-minute IAT structure in "
            "float32 (see simulator._rebase_chunk)")

    @staticmethod
    def _cast_subject(node: ast.Call) -> Optional[ast.AST]:
        """The value being cast to float32, if this call is such a cast."""
        func = node.func
        if isinstance(func, ast.Attribute):
            # X.astype(float32) / X.to(torch.float32) / X.to(dev, float32)
            if func.attr in ("astype", "to"):
                cands = (node.args if func.attr != "astype"
                         else node.args[:1])
                dtype = next((a for a in cands if _is_f32_dtype(a)), None) \
                    or next((kw.value for kw in node.keywords
                             if kw.arg == "dtype"), None)
                if dtype is not None and _is_f32_dtype(dtype):
                    return func.value
                return None
            # X.float()
            if func.attr == "float" and not node.args:
                return func.value
        name = dotted_name(func)
        if name in _F32_CASTERS and node.args:
            return node.args[0]
        if name in _ARRAY_CTORS and node.args:
            dtype = node.args[1] if len(node.args) > 1 else next(
                (kw.value for kw in node.keywords if kw.arg == "dtype"), None)
            if dtype is not None and _is_f32_dtype(dtype):
                return node.args[0]
        return None
