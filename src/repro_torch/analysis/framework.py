"""Pass framework: findings, per-rule config, suppressions, file driving.

Design (mirrors the sanitizer/conformance philosophy of the test suite):

  * a :class:`Rule` is a named pass with a ``check(module, config)``
    generator — rules are pure functions of one module's AST, so the whole
    suite is trivially parallel-safe and fixture-testable on virtual paths;
  * :class:`Finding` records are stable, sortable, and JSON-serializable —
    the ``--json`` schema (``version`` 1) is the reference linter's, and
    ``tests/test_torch_lint.py`` holds the two equal;
  * suppressions are *inline and reasoned*: ``# repro-lint: ignore[rule]
    -- reason``. A directive without a reason does not suppress and is
    itself reported (rule ``lint-directive``) — the point of the linter is
    that every exception to a contract is written down next to the code.

Scope matching uses the module's ``relkey`` — its path from the last
package segment named :attr:`LintConfig.package` (``repro_torch`` by
default: ``repro_torch/kernels/histogram.py``) — so the same rules fire
identically from the repo root, from ``src/``, and on the in-memory
fixture snippets the tests feed through :func:`run_source`. Pointed at
``repro``, the carried-over rules give the reference linter's findings.
"""
from __future__ import annotations

import ast
import dataclasses
import io
import json
import os
import re
import subprocess
import tokenize
from typing import Iterator, List, Optional, Sequence, Tuple

__all__ = [
    "Finding", "LintConfig", "Module", "Rule", "Suppression",
    "changed_files", "dotted_name", "iter_python_files",
    "parse_suppressions", "render_human", "render_json", "run_paths",
    "run_source",
]

JSON_SCHEMA_VERSION = 1

#: Sentinel rule name for malformed / reasonless suppression directives.
DIRECTIVE_RULE = "lint-directive"
#: Sentinel rule name for files the parser rejects.
PARSE_RULE = "parse-error"

_SUPPRESS_RE = re.compile(
    r"#\s*repro-lint:\s*ignore\[(?P<rules>[^\]]*)\]"
    r"(?:\s*--\s*(?P<reason>\S.*))?")


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One rule violation at a source location."""
    file: str
    line: int
    col: int
    rule: str
    message: str

    def to_json(self) -> dict:
        return {"file": self.file, "line": self.line, "col": self.col,
                "rule": self.rule, "message": self.message}

    def render(self) -> str:
        return f"{self.file}:{self.line}:{self.col}: [{self.rule}] " \
               f"{self.message}"


@dataclasses.dataclass(frozen=True)
class Suppression:
    """A parsed ``# repro-lint: ignore[...]`` directive."""
    line: int                 # 1-based line the directive sits on
    rules: Tuple[str, ...]    # rule names, or ("*",)
    reason: Optional[str]     # None => invalid (reasons are mandatory)
    standalone: bool          # comment-only line: covers the next CODE line
    target: Optional[int] = None   # resolved covered line (parse-time)

    def covers(self, rule: str, line: int) -> bool:
        if self.reason is None:
            return False
        target = self.target if self.target is not None else (
            self.line + 1 if self.standalone else self.line)
        return line == target and ("*" in self.rules or rule in self.rules)


@dataclasses.dataclass(frozen=True)
class LintConfig:
    """Per-rule knobs with repo-contract defaults.

    Everything is overridable so the fixture tests can point rules at
    virtual trees, but the defaults ARE the contract the port is held to
    (by its tier-1 tests and by ``chip_smoke.py``'s ``lint`` phase).
    """
    # relkeys start at the last path segment of this name.
    package: str = "repro_torch"
    # single-source-decision-math: the one file allowed to spell the math.
    policy_math_relkey: str = "repro_torch/core/policy_math.py"
    # x64-discipline: the modules that build and launch the CUDA kernels.
    kernel_scopes: Tuple[str, ...] = ("repro_torch/kernels/",)
    # x64-discipline: csrc stems whose SOURCE_FLAGS entry must carry
    # -fmad=false (no multiply-add contraction in a bit-exact decision
    # layer).
    bit_exact_sources: Tuple[str, ...] = ("hybrid_sweep_step",
                                          "policy_update")
    # x64-discipline: names that smell like absolute-time columns. A direct
    # float32 cast of one of these (outside a function that also rebases)
    # is exactly the float32 time parity bug class.
    time_name_pattern: str = \
        r"(?:^|_)(?:t|ts|time|times|timestamp|timestamps)(?:64|_abs|_min)?$"
    # tracer-leak: a for/while loop in a function whose name matches is a
    # scan body, the port's counterpart of a lax.scan step (``_fixed_scan``,
    # ``_spes_states``, ``fused_hybrid_sweep_scan_plain``,
    # ``fused_hybrid_sweep_scan_factored_plain``, ``decode_step``).
    scan_function_pattern: str = \
        r"(?:^|_)(?:scan|states|step)(?:_factored)?(?:_plain|_reference)?$"
    # determinism: packages whose outputs must be seed-deterministic.
    determinism_scopes: Tuple[str, ...] = (
        "repro_torch/core/", "repro_torch/serving/", "repro_torch/kernels/",
        "repro_torch/forecast/")
    # determinism: np.random attributes that are fine (counter/seeded RNG
    # construction rather than global-state draws).
    rng_allowed: Tuple[str, ...] = (
        "default_rng", "Generator", "SeedSequence", "PCG64", "Philox",
        "BitGenerator")
    # deprecation-hygiene: removed name -> replacement hint.
    removed_calls: Tuple[Tuple[str, str], ...] = (
        ("simulate", "experiment.run(trace, spec)"),
        ("simulate_fixed_batch", "experiment.run(trace, FixedSpec(ka))"),
        ("simulate_hybrid_batch", "experiment.run(trace, HybridSpec(...))"),
        ("simulate_hybrid_batch_reference",
         'experiment.run(trace, spec, engine="reference")'),
    )
    removed_attrs: Tuple[Tuple[str, str], ...] = (
        ("synthesize", "WorkloadSpec.uniform(...).materialize()"),
    )
    # pytree-completeness: the registration helper every spec family uses.
    register_helpers: Tuple[str, ...] = ("_register_pytree",)
    # conformance-coverage: per-module public entry points that must appear
    # (as calls) in some conformance test file.
    conformance_entry_points: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
        ("repro_torch/core/experiment.py", ("run", "sweep")),
        ("repro_torch/serving/cluster_vector.py", ("run_cluster",
                                                   "sweep_cluster")),
        ("repro_torch/forecast/arima_batched.py", ("fit_arima_grid",)),
    )
    # conformance-coverage: test tree location (resolved by walking up from
    # the linted file; absolute paths are honored as-is) and file pattern.
    conformance_test_dir: str = "tests"
    conformance_test_glob: str = "test_torch_*conformance*.py"


@dataclasses.dataclass
class Module:
    """One parsed source file plus the metadata rules key off."""
    path: str                  # path as given (display / finding key)
    relkey: str                # normalized package-relative posix key
    source: str
    tree: ast.Module
    suppressions: List[Suppression]

    def in_scope(self, scopes: Sequence[str]) -> bool:
        return any(self.relkey.startswith(s) for s in scopes)


class Rule:
    """Base class for passes. Subclasses set ``name``/``description`` and
    implement :meth:`check` as a generator of findings."""

    name: str = "base"
    description: str = ""

    def check(self, module: Module,
              config: LintConfig) -> Iterator[Finding]:  # pragma: no cover
        raise NotImplementedError

    def finding(self, module: Module, node: ast.AST, message: str) -> Finding:
        return Finding(file=module.path, line=getattr(node, "lineno", 1),
                       col=getattr(node, "col_offset", 0) + 1,
                       rule=self.name, message=message)


# ---------------------------------------------------------------------------
# Shared AST utilities
# ---------------------------------------------------------------------------


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for Name/Attribute chains, else None."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted_name(node.value)
        return None if base is None else f"{base}.{node.attr}"
    return None


def terminal_name(node: ast.AST) -> Optional[str]:
    """The last identifier of a Name/Attribute chain (``a.b.c`` -> ``c``)."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def relkey_for(path: str, package: str = "repro_torch") -> str:
    """Path from the last ``package`` segment, posix-separated.

    Makes scope matching invariant to where the tree is rooted (repo root,
    ``src/``, a tmp fixture dir, or a virtual test path).
    """
    parts = [p for p in re.split(r"[\\/]+", path) if p not in ("", ".")]
    if package in parts:
        idx = len(parts) - 1 - parts[::-1].index(package)
        parts = parts[idx:]
    return "/".join(parts)


# ---------------------------------------------------------------------------
# Suppressions
# ---------------------------------------------------------------------------


def parse_suppressions(source: str) -> List[Suppression]:
    """Directives from real COMMENT tokens only — a docstring that *talks
    about* the syntax (like this package's own docs) is not a directive."""
    out: List[Suppression] = []
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        comments = [t for t in tokens if t.type == tokenize.COMMENT]
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return out
    lines = source.splitlines()
    for tok in comments:
        m = _SUPPRESS_RE.search(tok.string)
        if not m:
            continue
        rules = tuple(r.strip() for r in m.group("rules").split(",")
                      if r.strip())
        standalone = tok.line[:tok.start[1]].strip() == ""
        target = tok.start[0]
        if standalone:
            # cover the next code line, skipping the rest of the comment
            # block (multi-line reasons) and blank lines
            target += 1
            while target <= len(lines) and (
                    not lines[target - 1].strip()
                    or lines[target - 1].lstrip().startswith("#")):
                target += 1
        out.append(Suppression(line=tok.start[0], rules=rules or ("*",),
                               reason=m.group("reason"),
                               standalone=standalone, target=target))
    return out


def _directive_findings(module: Module, known_rules: Sequence[str]
                        ) -> List[Finding]:
    """Malformed directives are findings themselves: a suppression without
    a reason (or naming an unknown rule) silently rots the contract it was
    meant to document."""
    out = []
    known = set(known_rules) | {"*", DIRECTIVE_RULE, PARSE_RULE}
    for s in module.suppressions:
        if s.reason is None:
            out.append(Finding(
                module.path, s.line, 1, DIRECTIVE_RULE,
                "suppression without a reason: write "
                "'# repro-lint: ignore[rule] -- why this is safe'"))
        for r in s.rules:
            if r not in known:
                out.append(Finding(
                    module.path, s.line, 1, DIRECTIVE_RULE,
                    f"suppression names unknown rule {r!r}"))
    return out


# ---------------------------------------------------------------------------
# Driving
# ---------------------------------------------------------------------------


def run_source(source: str, path: str, rules: Sequence[Rule],
               config: Optional[LintConfig] = None
               ) -> Tuple[List[Finding], int]:
    """Lint one in-memory module. Returns (findings, n_suppressed)."""
    config = config or LintConfig()
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Finding(path, e.lineno or 1, (e.offset or 0) + 1, PARSE_RULE,
                        f"cannot parse: {e.msg}")], 0
    module = Module(path=path, relkey=relkey_for(path, config.package),
                    source=source,
                    tree=tree, suppressions=parse_suppressions(source))
    raw: List[Finding] = []
    for rule in rules:
        raw.extend(rule.check(module, config))
    kept, suppressed = [], 0
    for f in raw:
        if any(s.covers(f.rule, f.line) for s in module.suppressions):
            suppressed += 1
        else:
            kept.append(f)
    kept.extend(_directive_findings(module, [r.name for r in rules]))
    return sorted(kept), suppressed


def iter_python_files(paths: Sequence[str]) -> Iterator[str]:
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
        elif os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(d for d in dirnames
                                     if not d.startswith((".", "__pycache__")))
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        yield os.path.join(dirpath, fn)


def changed_files(paths: Sequence[str]) -> List[str]:
    """The ``--changed`` working set: files touched vs HEAD plus untracked,
    intersected with ``paths``. Requires a git checkout."""
    def git(*args: str) -> List[str]:
        out = subprocess.run(["git", *args], check=True,
                             capture_output=True, text=True).stdout
        return [l for l in out.splitlines() if l]

    names = set(git("diff", "--name-only", "HEAD", "--"))
    names |= set(git("ls-files", "--others", "--exclude-standard"))
    wanted = []
    roots = [os.path.normpath(p) for p in paths]
    for name in sorted(names):
        if not name.endswith(".py") or not os.path.exists(name):
            continue
        norm = os.path.normpath(name)
        if any(norm == r or norm.startswith(r + os.sep) for r in roots):
            wanted.append(name)
    return wanted


def run_paths(paths: Sequence[str], rules: Sequence[Rule],
              config: Optional[LintConfig] = None,
              changed: bool = False) -> dict:
    """Lint files under ``paths``; returns the report dict the CLI renders
    (the same object ``--json`` serializes)."""
    config = config or LintConfig()
    files = changed_files(paths) if changed else list(iter_python_files(paths))
    findings: List[Finding] = []
    suppressed = 0
    for fp in files:
        with open(fp, "r", encoding="utf-8") as fh:
            src = fh.read()
        got, n_sup = run_source(src, fp, rules, config)
        findings.extend(got)
        suppressed += n_sup
    return {
        "version": JSON_SCHEMA_VERSION,
        "counts": {"files": len(files), "findings": len(findings),
                   "suppressed": suppressed},
        "findings": sorted(findings),
    }


def render_json(report: dict) -> str:
    out = dict(report)
    out["findings"] = [f.to_json() for f in report["findings"]]
    return json.dumps(out, indent=2, sort_keys=True)


def render_human(report: dict) -> str:
    lines = [f.render() for f in report["findings"]]
    c = report["counts"]
    lines.append(f"{c['findings']} finding(s) in {c['files']} file(s) "
                 f"({c['suppressed']} suppressed)")
    return "\n".join(lines)
