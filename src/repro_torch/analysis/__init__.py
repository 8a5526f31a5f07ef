"""`repro_torch.analysis` — AST-based invariant linter for the port.

The port's engines match the reference, and each other, bit for bit only
while a handful of cross-cutting contracts hold. They are the reference
linter's (:mod:`repro.analysis`), re-aimed at what the port runs:

  * all decision math (percentiles, margins, warm/cold verdicts,
    ``PCT_SCALE`` arithmetic) lives in :mod:`repro_torch.core.policy_math`;
  * float32 engines never difference un-rebased absolute timestamps; the
    kernels keep float64 time (the card has it), but they are never built
    with nvcc flags that give up IEEE results (fast math, flushed
    denormals, inexact division or square root, multiply-add contraction
    in the bit-exact sources), and nothing switches TF32 on;
  * scan bodies (the Python loops over event columns), CUDA-graph
    captures and ``torch.compile``/``vmap`` targets never host-sync
    (``.item()``/``.cpu()``/``float()``/``np.asarray``/python ``if``);
  * trace generation and the simulators are seed-deterministic — no
    global NumPy, stdlib or torch RNG, no wall-clock reads;
  * registered ``*Spec`` pytrees flatten every dataclass field;
  * removed ``simulate*`` / ``Trace.synthesize`` entry points stay removed;
  * the public engine entry points are pinned by a
    ``tests/test_torch_*conformance*`` file.

Standard library only: it imports neither ``torch`` nor ``jax``, nor
anything of the reference package. The rule names and the directive
syntax are the reference's, so one directive serves both linters:

    x = risky_thing()  # repro-lint: ignore[rule-name] -- why this is fine

Run it as ``python -m repro_torch.analysis [paths] [--json] [--changed]``;
see ``README.md`` (the port's section) for the rule catalogue.
"""
from .framework import (Finding, LintConfig, Module, Rule, Suppression,
                        changed_files, dotted_name, parse_suppressions,
                        render_human, render_json, run_paths, run_source)
from .passes import ALL_RULES, rule_by_name

__all__ = [
    "ALL_RULES", "Finding", "LintConfig", "Module", "Rule", "Suppression",
    "changed_files", "dotted_name", "parse_suppressions", "render_human",
    "render_json", "rule_by_name", "run_paths", "run_source",
]
