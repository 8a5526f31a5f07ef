"""Pass 7 — conformance coverage: public engine entry points stay pinned.

The repo's correctness story is the conformance suite: every engine
(scalar oracle, fused scan, pallas, reference, cluster, batched forecast)
is pinned bit-exactly against an independent implementation by a
``tests/test_torch_*conformance*.py`` file (the port's engines against the
reference's and its goldens). That only works if new public entry
points actually *enter* that suite — a subsystem that ships with its own
private tests can silently drift from the oracle contract.

This pass closes the loop: for each configured entry-point module, every
listed public function must be mentioned (as a call, ``name(...)``) in at
least one conformance test file. The test tree is found by walking up
from the linted file toward the filesystem root until a directory named
``config.conformance_test_dir`` appears — so the rule fires identically
from the repo root, from ``src/``, and on fixture trees the lint tests
point at a temp directory.
"""
from __future__ import annotations

import ast
import glob
import os
import re
from typing import Iterator, List, Optional

from ..framework import Finding, LintConfig, Module, Rule


def _resolve_test_dir(module_path: str, test_dir: str) -> Optional[str]:
    """Nearest ancestor of ``module_path`` containing ``test_dir``.

    ``test_dir`` may also be an absolute path (fixture trees), which is
    returned as-is when it exists.
    """
    if os.path.isabs(test_dir):
        return test_dir if os.path.isdir(test_dir) else None
    cur = os.path.dirname(os.path.abspath(module_path))
    while True:
        cand = os.path.join(cur, test_dir)
        if os.path.isdir(cand):
            return cand
        parent = os.path.dirname(cur)
        if parent == cur:
            return None
        cur = parent


def _conformance_sources(test_dir: str, pattern: str) -> List[str]:
    out = []
    for fp in sorted(glob.glob(os.path.join(test_dir, pattern))):
        try:
            with open(fp, "r", encoding="utf-8") as fh:
                out.append(fh.read())
        except OSError:
            continue
    return out


class ConformanceCoverage(Rule):
    name = "conformance-coverage"
    description = ("public engine entry points must be exercised by a "
                   "tests/test_torch_*conformance* file")

    def check(self, module: Module, config: LintConfig) -> Iterator[Finding]:
        wanted = dict(config.conformance_entry_points).get(module.relkey)
        if not wanted:
            return
        test_dir = _resolve_test_dir(module.path,
                                     config.conformance_test_dir)
        defs = {node.name: node for node in module.tree.body
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))}
        if test_dir is None:
            for name in wanted:
                if name in defs:
                    yield self.finding(
                        module, defs[name],
                        f"cannot verify conformance coverage of {name}(): "
                        f"no {config.conformance_test_dir!r} directory on "
                        f"the path to the filesystem root")
            return
        sources = _conformance_sources(test_dir,
                                       config.conformance_test_glob)
        for name in wanted:
            node = defs.get(name)
            if node is None:
                continue  # entry point moved/renamed: nothing to anchor
            called = re.compile(rf"\b{re.escape(name)}\s*\(")
            if not any(called.search(src) for src in sources):
                yield self.finding(
                    module, node,
                    f"public entry point {name}() is not exercised by any "
                    f"{config.conformance_test_glob} file under "
                    f"{config.conformance_test_dir}/ — pin it against an "
                    f"independent oracle in the conformance suite")
