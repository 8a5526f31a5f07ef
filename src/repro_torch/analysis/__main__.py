"""CLI: ``python -m repro_torch.analysis [paths] [--json] [--changed]``.

Exit codes: 0 clean, 1 findings, 2 usage/environment error. Stdlib-only —
it runs with neither torch nor jax installed.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from typing import List, Optional

from .framework import LintConfig, render_human, render_json, run_paths
from .passes import ALL_RULES, rule_by_name

DEFAULT_PATH = "src/repro_torch"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Invariant linter for the PyTorch/CUDA port: mechanizes "
                    "the cross-cutting contracts (single-source decision "
                    "math, exact float discipline, host syncs in hot "
                    "loops, determinism, pytree completeness, "
                    "deprecations, conformance coverage).")
    p.add_argument("paths", nargs="*", default=[DEFAULT_PATH],
                   help=f"files/directories to lint (default: "
                        f"{DEFAULT_PATH})")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit the machine-readable report (schema v1)")
    p.add_argument("--changed", action="store_true",
                   help="lint only files changed vs HEAD (plus untracked) "
                        "under the given paths — pre-commit mode")
    p.add_argument("--select", action="append", metavar="RULE",
                   help="run only the named rule(s); repeatable")
    p.add_argument("--list-rules", action="store_true",
                   help="print rule names + descriptions and exit")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_rules:
        for rule in ALL_RULES:
            print(f"{rule.name}: {rule.description}")
        return 0
    rules = ALL_RULES
    if args.select:
        try:
            rules = [rule_by_name(name) for name in args.select]
        except KeyError as e:
            print(f"error: {e.args[0]}", file=sys.stderr)
            return 2
    try:
        report = run_paths(args.paths or [DEFAULT_PATH], rules, LintConfig(),
                           changed=args.changed)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        print(f"error: --changed needs a git checkout ({e})", file=sys.stderr)
        return 2
    print(render_json(report) if args.as_json else render_human(report))
    return 1 if report["findings"] else 0


if __name__ == "__main__":
    sys.exit(main())
