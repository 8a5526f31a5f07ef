"""Pass 4 — nondeterminism sources in seed-deterministic packages.

Every result in ``repro_torch/{core,serving,kernels,forecast}`` must be a
pure function of ``(trace, spec, seed)`` — that is what lets conformance
tests pin engine outputs bit-exactly and lets sweeps be resumed/sharded
without drift. Inside those scopes this pass flags:

  * global NumPy RNG draws (``np.random.rand`` etc.) — constructing
    seeded generators (``np.random.default_rng``, ``Generator``,
    ``SeedSequence``, ...) is the sanctioned pattern and stays allowed;
  * stdlib ``random.*`` module-level draws (when ``import random`` is in
    the module — a local variable named ``random`` is not the module);
  * torch's global generator: ``torch.rand/randn/randint/randperm/normal/
    bernoulli/multinomial/poisson`` and their ``*_like`` forms called
    without ``generator=``, the in-place ``.uniform_/.normal_/.random_/
    .exponential_/.bernoulli_/...`` without ``generator=``, and re-seeding
    it (``torch.manual_seed``, ``torch.seed``,
    ``torch.cuda.manual_seed(_all)``) — thread a seeded
    ``torch.Generator`` instead;
  * wall-clock reads: ``time.time/time_ns/monotonic/perf_counter``,
    ``datetime.now/utcnow/today``;
  * entropy taps: ``os.urandom``, ``uuid.uuid4``, ``secrets.*``.

Measured wall-clock *latency reporting* is a legitimate exception (the
serving engine's deliverable is the measurement) — suppress those sites
with a reasoned directive.
"""
from __future__ import annotations

import ast
from typing import Iterator, Set

from ..framework import Finding, LintConfig, Module, Rule, dotted_name

_CLOCK_CALLS = {
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns",
    "datetime.now", "datetime.utcnow", "datetime.today",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.datetime.today", "datetime.date.today",
}
_ENTROPY_CALLS = {"os.urandom", "uuid.uuid4", "uuid.uuid1"}
_TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "normal",
                "bernoulli", "multinomial", "poisson", "rand_like",
                "randn_like", "randint_like"}
_TORCH_INPLACE_DRAWS = {"uniform_", "normal_", "random_", "exponential_",
                        "bernoulli_", "cauchy_", "log_normal_",
                        "geometric_"}
_TORCH_GLOBAL_SEEDS = {
    "torch.manual_seed", "torch.seed", "torch.random.manual_seed",
    "torch.random.seed", "torch.cuda.manual_seed",
    "torch.cuda.manual_seed_all", "torch.cuda.seed", "torch.cuda.seed_all"}


def _stdlib_random_imported(tree: ast.Module) -> Set[str]:
    """Local names bound to the stdlib ``random``/``secrets`` modules."""
    names: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name in ("random", "secrets"):
                    names.add(alias.asname or alias.name)
    return names


class Nondeterminism(Rule):
    name = "nondeterminism"
    description = ("global NumPy/stdlib/torch RNG, wall-clock or entropy "
                   "use in seed-deterministic packages")

    def check(self, module: Module, config: LintConfig) -> Iterator[Finding]:
        if not module.in_scope(config.determinism_scopes):
            return
        rng_modules = _stdlib_random_imported(module.tree)
        allowed = set(config.rng_allowed)
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            seeded = any(kw.arg == "generator" for kw in node.keywords)
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _TORCH_INPLACE_DRAWS and not seeded:
                yield self.finding(
                    module, node,
                    f"in-place draw .{node.func.attr}() without generator=: "
                    "reads torch's global RNG — pass a seeded "
                    "torch.Generator")
                continue
            name = dotted_name(node.func)
            if name is None:
                continue
            if name in _TORCH_GLOBAL_SEEDS:
                yield self.finding(
                    module, node,
                    f"{name}() re-seeds torch's global RNG: results then "
                    "depend on call order — pass a seeded torch.Generator")
                continue
            if name.startswith("torch.") and \
                    name[len("torch."):] in _TORCH_DRAWS and not seeded:
                yield self.finding(
                    module, node,
                    f"global torch RNG draw {name}() without generator=: "
                    "breaks (trace, spec, seed) determinism — pass a "
                    "seeded torch.Generator")
                continue
            head, _, tail = name.rpartition(".")
            if head in ("np.random", "numpy.random", "jax.numpy.random"):
                if tail not in allowed:
                    yield self.finding(
                        module, node,
                        f"global NumPy RNG draw {name}(): breaks "
                        "(trace, spec, seed) determinism — thread a "
                        "np.random.default_rng(seed) Generator instead")
            elif head in rng_modules:
                yield self.finding(
                    module, node,
                    f"stdlib {name}(): module-global entropy in a "
                    "seed-deterministic package — use a keyed "
                    "np.random.default_rng(seed)")
            elif name in _CLOCK_CALLS:
                yield self.finding(
                    module, node,
                    f"wall-clock read {name}(): simulated results must not "
                    "depend on host time (suppress with a reason if this "
                    "is latency *measurement*, not simulation state)")
            elif name in _ENTROPY_CALLS:
                yield self.finding(
                    module, node,
                    f"entropy tap {name}(): derive identifiers from the "
                    "seed/spec instead")
