"""Tests for the port's invariant linter (``repro_torch.analysis``).

Four layers, on the CPU, with no torch needed by the linter itself:

  * per-rule fixtures — each test of the reference's ``tests/test_lint.py``
    has a counterpart here on a ``src/repro_torch/...`` virtual path, with
    the same name where the contract carries over. Where the port's
    contract differs the name says so: float64 in ``repro_torch/kernels/``
    is not flagged (the card has float64 and the kernels keep float64 time
    on purpose); inexact nvcc flags, a ``SOURCE_FLAGS`` without
    ``-fmad=false`` for a bit-exact source and TF32 switched on are; torch
    RNG draws are flagged without ``generator=`` and not with it; host
    syncs are flagged in scan loops, CUDA-graph captures and
    ``torch.compile``/``vmap`` targets, and not outside them;
  * parity with the reference — on every file of ``src/repro/`` with the
    directives disabled in memory, and on the reference's own fixture
    snippets, the rules whose contract carries over give the reference
    linter's findings; ``parse_suppressions`` and the ``--json`` schema
    are the reference's;
  * the port's own findings — with the directives stripped, the linter
    finds the fifteen wall-clock reads the port suppresses, and the
    ``run_cluster``/``sweep_cluster`` coverage gap when the cluster tests
    are not a conformance file;
  * dogfooding — ``src/repro_torch`` is clean, through the same CLI that
    ``chip_smoke.py``'s ``lint`` phase runs in-process, and the CLI runs
    with torch and jax blocked.
"""
import ast
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import repro.analysis as ref_lint
from repro_torch.analysis import (ALL_RULES, LintConfig, parse_suppressions,
                                  render_json, rule_by_name, run_paths,
                                  run_source)
from repro_torch.analysis.traced import find_hot_contexts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
PORT = os.path.join(SRC, "repro_torch")
REF = os.path.join(SRC, "repro")

CORE = "src/repro_torch/core/x.py"          # determinism scope, non-kernel
KERNEL = "src/repro_torch/kernels/x.py"     # kernel + determinism scope
OUTSIDE = "src/repro_torch/bench/x.py"      # outside determinism scope


def lint(source, path=CORE, rules=None, config=None):
    findings, _ = run_source(source, path, rules or ALL_RULES, config)
    return findings


def rules_of(findings):
    return [f.rule for f in findings]


def without_directives(source):
    """``source`` with every ``# repro-lint:`` directive disabled, at the
    same lines and columns."""
    return source.replace("repro-lint:", "repro-lynt:")


# ---------------------------------------------------------------------------
# Pass 1: single-source decision math
# ---------------------------------------------------------------------------


class TestDecisionMath:
    RULE = "single-source-decision-math"

    def test_pct_scale_arithmetic_flagged(self):
        bad = "thr = total * policy_math.PCT_SCALE\n"
        assert rules_of(lint(bad)) == [self.RULE]

    def test_pct_scale_through_dtype_cast_flagged(self):
        bad = "thr = t.to(torch.int32) * np.int32(policy_math.PCT_SCALE)\n"
        assert rules_of(lint(bad)) == [self.RULE]

    def test_pct_scale_opaque_use_ok(self):
        good = ("from repro_torch.core.policy_math import PCT_SCALE\n"
                "check(width, PCT_SCALE)\n"
                "limit = policy_math.MAX_SCALED_COUNT\n")
        assert lint(good) == []

    def test_policy_math_itself_exempt(self):
        src = "thr = total * PCT_SCALE\n"
        assert lint(src, path="src/repro_torch/core/policy_math.py") == []
        # the reference's module is not the port's exemption
        assert rules_of(lint(src, path="src/repro/core/policy_math.py")) \
            == [self.RULE]

    def test_inline_margin_flagged_and_helper_ok(self):
        bad = "lo = it * (1.0 - margin)\n"
        good = "lo, hi = policy_math.margin_factors(margin)\n"
        assert rules_of(lint(bad)) == [self.RULE]
        assert lint(good) == []

    def test_inline_warm_verdict_flagged(self):
        bad = "warm = (it >= load_at) & (it <= unload_at)\n"
        assert rules_of(lint(bad)) == [self.RULE]
        reversed_bad = "warm = load_at <= it and it <= unload_at\n"
        assert rules_of(lint(reversed_bad)) == [self.RULE]

    def test_warm_helper_ok(self):
        good = "warm = policy_math.warm_from_bounds(it, load_at, unload_at)\n"
        assert lint(good) == []


# ---------------------------------------------------------------------------
# Pass 2: x64 discipline, re-aimed at exact arithmetic on the card
# ---------------------------------------------------------------------------


class TestX64:
    RULE = "x64-discipline"

    def test_f64_in_kernel_not_flagged_in_port(self):
        # the reference flags this (no f64 on a TPU); the port's kernel
        # engine keeps float64 time on purpose
        src = "acc = torch.zeros(8, dtype=torch.float64)\n"
        assert lint(src, path=KERNEL) == []
        assert rules_of(ref_lint.run_source(
            "acc = jnp.zeros(8, jnp.float64)\n", "src/repro/kernels/x.py",
            ref_lint.ALL_RULES)[0]) == [self.RULE]

    def test_f64_string_in_kernel_not_flagged_in_port(self):
        assert lint("x = y.astype('float64')\n", path=KERNEL) == []
        assert lint("x = y.to(getattr(torch, 'float64'))\n",
                    path=KERNEL) == []

    @pytest.mark.parametrize("flag", [
        "--use_fast_math", "-use_fast_math", "-prec-div=false",
        "-prec-sqrt=false", "-ftz=true", "-fmad=true"])
    def test_inexact_nvcc_flag_in_kernel_flagged(self, flag):
        # the port's replacement of the reference's enable_x64 check
        bad = f"NVCC_FLAGS = ('-O3', {flag!r})\n"
        assert rules_of(lint(bad, path=KERNEL)) == [self.RULE]
        assert lint(bad, path=CORE) == []          # kernel scope only

    def test_exact_nvcc_flags_ok(self):
        good = ("NVCC_FLAGS = ('-O3', '-fmad=false', '-prec-div=true')\n"
                '"""Docs: never build with --use_fast_math here."""\n')
        assert lint(good, path=KERNEL) == []

    def test_source_flags_without_fmad_false_flagged(self):
        bad = ("SOURCE_FLAGS = {'hybrid_sweep_step': ('-fmad=false',),\n"
               "                'policy_update': ()}\n")
        found = lint(bad, path=KERNEL)
        assert rules_of(found) == [self.RULE]
        assert "policy_update" in found[0].message
        missing = "SOURCE_FLAGS = {'policy_update': ('-fmad=false',)}\n"
        found = lint(missing, path=KERNEL)
        assert rules_of(found) == [self.RULE]
        assert "hybrid_sweep_step" in found[0].message
        opaque = "SOURCE_FLAGS = dict(policy_update=EXACT)\n"
        assert rules_of(lint(opaque, path=KERNEL)) == [self.RULE]

    def test_source_flags_with_fmad_false_ok(self):
        good = ("SOURCE_FLAGS = {'hybrid_sweep_step': ['-fmad=false'],\n"
                "                'policy_update': ('-fmad=false', '-O3')}\n")
        assert lint(good, path=KERNEL) == []

    def test_shipped_source_flags_without_fmad_false_flagged(self):
        """The real build table, with one source's -fmad=false taken out."""
        src = open(os.path.join(PORT, "kernels", "build.py"),
                   encoding="utf-8").read()
        assert lint(src, path=os.path.join(PORT, "kernels", "build.py")) \
            == []
        broken = src.replace('"policy_update": ("-fmad=false",)',
                             '"policy_update": ()')
        assert broken != src
        found = lint(broken, path="src/repro_torch/kernels/build.py")
        assert rules_of(found) == [self.RULE]

    @pytest.mark.parametrize("bad", [
        "torch.backends.cuda.matmul.allow_tf32 = True\n",
        "torch.backends.cudnn.allow_tf32 = True\n",
        "torch.backends.cuda.matmul.allow_tf32 = flag\n",
        "torch.set_float32_matmul_precision('high')\n",
        "torch.set_float32_matmul_precision('medium')\n",
        "torch.backends.cuda.matmul.fp32_precision = 'tf32'\n",
    ])
    def test_tf32_switched_on_flagged_everywhere(self, bad):
        for path in (CORE, KERNEL, OUTSIDE):
            assert rules_of(lint(bad, path=path)) == [self.RULE]

    def test_tf32_off_ok(self):
        good = ("torch.backends.cuda.matmul.allow_tf32 = False\n"
                "torch.backends.cudnn.allow_tf32 = False\n"
                "torch.set_float32_matmul_precision('highest')\n"
                "torch.backends.cuda.matmul.fp32_precision = 'ieee'\n"
                "assert torch.get_float32_matmul_precision() == 'highest'\n")
        assert lint(good, path=OUTSIDE) == []

    def test_f64_outside_kernels_ok(self):
        good = "oracle = times.astype(np.float64)\n"
        assert lint(good, path=CORE) == []

    @pytest.mark.parametrize("bad", [
        "def f(times):\n    return times.astype(np.float32)\n",
        "def f(t_abs):\n    return np.asarray(t_abs, np.float32)\n",
        "def f(times):\n    return times.to(torch.float32)\n",
        "def f(times):\n    return times.to(dtype=torch.float32)\n",
        "def f(times, dev):\n    return times.to(dev, torch.float32)\n",
        "def f(times):\n    return times.float()\n",
        "def f(t_min):\n    return torch.as_tensor(t_min, "
        "dtype=torch.float32)\n",
        "def f(ts):\n    return torch.tensor(ts, dtype=torch.float32)\n",
    ])
    def test_unrebased_time_cast_flagged_everywhere(self, bad):
        assert rules_of(lint(bad, path=CORE)) == [self.RULE]
        assert rules_of(lint(bad, path=OUTSIDE)) == [self.RULE]

    def test_rebasing_function_exempt(self):
        good = ("def f(times):\n"
                "    t = _rebase_chunk(times)\n"
                "    return t.to(torch.float32)\n")
        assert lint(good, path=CORE) == []

    def test_non_time_cast_ok(self):
        good = ("def f(counts, times):\n"
                "    a = counts.to(torch.float32)\n"
                "    b = times.to(torch.float64)\n"
                "    return a, b, counts.float()\n")
        assert lint(good, path=CORE) == []


# ---------------------------------------------------------------------------
# Pass 3: tracer leaks, re-aimed at the port's hot contexts
# ---------------------------------------------------------------------------


class TestTracerLeak:
    RULE = "tracer-leak"

    def test_if_on_traced_param_flagged(self):
        # a torch.compile target, the port's counterpart of a jitted fn
        bad = ("@torch.compile\n"
               "def f(x):\n"
               "    if x.sum() > 0:\n"
               "        return x\n"
               "    return -x\n")
        assert rules_of(lint(bad)) == [self.RULE]

    def test_if_on_scalar_param_ok(self):
        # the counterpart of the reference's static_argnums case: a
        # parameter annotated as a host scalar is a host value
        good = ("@partial(torch.compile, dynamic=False)\n"
                "def f(x, include_trailing: bool, n: int = 3):\n"
                "    if include_trailing and n > 1:\n"
                "        return x + 1\n"
                "    return x\n")
        assert lint(good) == []

    def test_shape_probe_ok(self):
        good = ("@torch.compile\n"
                "def f(x, y=None):\n"
                "    if x.ndim == 0 or x.shape[0] == 1 or x.size(1) > 4:\n"
                "        x = x[None]\n"
                "    if y is None or isinstance(x, tuple):\n"
                "        return x\n"
                "    return x + y\n")
        assert lint(good) == []

    def test_scan_body_host_sync_flagged(self):
        bad = ("def _fixed_scan(cols, keep_alive):\n"
               "    carry = 0.0\n"
               "    for t_now in cols:\n"
               "        v = float(t_now)\n"
               "        carry = carry + np.asarray(keep_alive)\n"
               "    return carry\n")
        assert rules_of(lint(bad)).count(self.RULE) == 2

    def test_item_in_scan_body_flagged(self):
        bad = ("def _spes_states(cols, knobs):\n"
               "    for t_now in cols:\n"
               "        yield t_now.item()\n")
        assert rules_of(lint(bad)) == [self.RULE]

    @pytest.mark.parametrize("sync", [
        "x.tolist()", "x.cpu()", "x.numpy()", "x.to('cpu')",
        "torch.cuda.synchronize()", "int(valid.sum())"])
    def test_scan_body_host_syncs_flagged(self, sync):
        bad = ("def fused_hybrid_sweep_scan_plain(cols, cum):\n"
               "    for x in cols:\n"
               "        valid = torch.isfinite(x)\n"
               f"        y = {sync}\n"
               "    return cum\n")
        assert rules_of(lint(bad)) == [self.RULE]

    def test_branch_on_derived_value_in_scan_flagged(self):
        bad = ("def _branch_scan(cols, cfg):\n"
               "    for t_now in cols:\n"
               "        late = t_now > cfg\n"
               "        if late.any():\n"
               "            pass\n")
        assert rules_of(lint(bad)) == [self.RULE]

    def test_clean_scan_body_ok(self):
        good = ("def _hybrid_scan_reference(cols, n: int):\n"
                "    carry = torch.zeros(n)\n"
                "    for i in range(n):\n"
                "        if i == 0:\n"
                "            carry = carry + 1\n"
                "    for k, t_now in enumerate(cols):\n"
                "        if k % 2:\n"
                "            carry = carry + torch.where(t_now > 0, t_now, 0)\n"
                "    return carry\n")
        assert lint(good) == []

    def test_host_code_outside_traced_context_ok(self):
        # while/float/.item() on host values is fine — only hot contexts
        good = ("def host(xs):\n"
                "    while len(xs) > 0:\n"
                "        xs = xs[1:]\n"
                "    for x in xs:\n"
                "        print(x.item())\n"
                "    return float(np.asarray(xs).sum())\n"
                "def scan_form(n_bins: int):\n"
                "    return 'columns'\n")
        assert lint(good) == []

    def test_cuda_graph_capture_sync_flagged(self):
        bad = ("def graph_ms(fn, x):\n"
               "    fn()\n"
               "    torch.cuda.synchronize()\n"
               "    graph = torch.cuda.CUDAGraph()\n"
               "    with torch.cuda.graph(graph):\n"
               "        for _ in range(3):\n"
               "            y = fn(x)\n"
               "        if y.sum() > 0:\n"
               "            torch.cuda.synchronize()\n"
               "    graph.replay()\n"
               "    torch.cuda.synchronize()\n")
        found = [f for f in lint(bad) if f.rule == self.RULE]
        assert [f.line for f in found] == [8, 9]

    @pytest.mark.parametrize("wrap", [
        "torch.vmap(per_row)", "torch.func.vmap(per_row, in_dims=0)",
        "torch.compile(per_row)", "torch.jit.trace(per_row, (x,))",
        "torch.compile(partial(per_row, k=2))"])
    def test_compile_and_vmap_targets_flagged(self, wrap):
        bad = ("def per_row(r, k=1):\n"
               "    if r.max() > k:\n"
               "        return r\n"
               "    return bool(r)\n"
               f"f = {wrap}\n")
        assert rules_of(lint(bad)).count(self.RULE) == 2

    def test_vmap_lambda_flagged(self):
        bad = "f = torch.vmap(lambda r: r.item())\n"
        assert rules_of(lint(bad)) == [self.RULE]

    def test_hot_contexts_of_the_port(self):
        """The scan loops, the CUDA-graph capture and nothing compiled: the
        regions the rule holds in ``src/repro_torch`` today."""
        found = set()
        for fp in sorted(Path(PORT).rglob("*.py")):
            tree = ast.parse(fp.read_text(encoding="utf-8"))
            rel = fp.relative_to(PORT).as_posix()
            for ctx in find_hot_contexts(tree):
                found.add((rel, ctx.func_name, ctx.kind))
        for want in [
                ("core/simulator.py", "_fixed_scan", "scan-body"),
                ("core/simulator.py", "_spes_states", "scan-body"),
                ("core/simulator.py", "_hybrid_scan_reference", "scan-body"),
                ("forecast/replay.py", "_branch_scan", "scan-body"),
                ("kernels/histogram.py", "fused_hybrid_sweep_scan_plain",
                 "scan-body"),
                ("kernels/timing.py", "graph_ms", "cuda-graph")]:
            assert want in found, want
        assert {kind for _, _, kind in found} == {"scan-body", "cuda-graph"}
        assert len(found) >= 15

    def test_sync_injected_into_the_ports_scan_flagged(self):
        path = os.path.join(PORT, "core", "simulator.py")
        src = open(path, encoding="utf-8").read()
        anchor = "        valid = torch.isfinite(t_now)\n"
        assert src.count(anchor) >= 1
        bad = src.replace(anchor, anchor + "        n = int(valid.sum())\n",
                          1)
        found = [f for f in lint(bad, path=path) if f.rule == self.RULE]
        assert len(found) == 1
        assert "'valid'" in found[0].message


# ---------------------------------------------------------------------------
# Pass 4: nondeterminism
# ---------------------------------------------------------------------------


class TestNondeterminism:
    RULE = "nondeterminism"

    def test_global_np_random_flagged(self):
        bad = "noise = np.random.rand(8)\n"
        assert rules_of(lint(bad)) == [self.RULE]

    def test_seeded_generator_ok(self):
        good = ("rng = np.random.default_rng(seed)\n"
                "noise = rng.random(8)\n"
                "g = torch.Generator(device=dev).manual_seed(seed)\n"
                "g.manual_seed(seed + 1)\n")
        assert lint(good) == []

    def test_stdlib_random_flagged(self):
        bad = "import random\nx = random.random()\n"
        assert rules_of(lint(bad)) == [self.RULE]

    def test_wall_clock_flagged(self):
        bad = "t = time.time()\n"
        assert rules_of(lint(bad)) == [self.RULE]

    def test_out_of_scope_ok(self):
        assert lint("t = time.time()\n", path=OUTSIDE) == []
        assert lint("x = np.random.rand(3)\n", path=OUTSIDE) == []
        assert lint("x = torch.rand(3)\n", path=OUTSIDE) == []

    @pytest.mark.parametrize("draw", [
        "torch.rand(3)", "torch.randn(2, 3)", "torch.randint(0, 9, (4,))",
        "torch.randperm(8)", "torch.normal(mean, std)",
        "torch.bernoulli(p)", "torch.multinomial(p, 2)",
        "torch.poisson(rate)", "torch.rand_like(x)", "torch.randn_like(x)",
        "torch.randint_like(x, 9)"])
    def test_torch_draw_with_and_without_generator(self, draw):
        assert rules_of(lint(f"x = {draw}\n")) == [self.RULE]
        seeded = draw[:-1] + ", generator=g)"
        assert lint(f"x = {seeded}\n") == []

    @pytest.mark.parametrize("method", [
        "uniform_", "normal_", "random_", "exponential_", "bernoulli_",
        "cauchy_", "log_normal_", "geometric_"])
    def test_torch_inplace_draw_with_and_without_generator(self, method):
        assert rules_of(lint(f"w.{method}()\n")) == [self.RULE]
        assert lint(f"w.{method}(generator=g)\n") == []

    @pytest.mark.parametrize("seed", [
        "torch.manual_seed(0)", "torch.seed()",
        "torch.cuda.manual_seed(0)", "torch.cuda.manual_seed_all(0)",
        "torch.random.manual_seed(0)"])
    def test_torch_global_seeding_flagged(self, seed):
        assert rules_of(lint(f"{seed}\n")) == [self.RULE]


# ---------------------------------------------------------------------------
# Pass 5: pytree completeness
# ---------------------------------------------------------------------------

_DATACLASS = ("@dataclasses.dataclass(frozen=True)\n"
              "class FooSpec:\n"
              "    keep_alive: float\n"
              "    label: str\n")


class TestPytree:
    RULE = "pytree-completeness"

    def test_meta_typo_flagged(self):
        bad = _DATACLASS + "_register_pytree(FooSpec, meta=('labell',))\n"
        assert rules_of(lint(bad)) == [self.RULE]

    def test_meta_ok(self):
        good = _DATACLASS + "_register_pytree(FooSpec, meta=('label',))\n"
        assert lint(good) == []

    def test_raw_flatten_dropping_field_flagged(self):
        # torch's spelling: same name and argument order as JAX's
        bad = (_DATACLASS +
               "def _flat(s):\n"
               "    return (s.keep_alive,), None\n"
               "def _unflat(kids, aux):\n"
               "    return FooSpec(kids[0], 'x')\n"
               "torch.utils._pytree.register_pytree_node(FooSpec, _flat, "
               "_unflat)\n")
        found = [f for f in lint(bad) if f.rule == self.RULE]
        assert len(found) == 1
        assert "drops field(s) ['label']" in found[0].message

    def test_raw_flatten_complete_ok(self):
        good = (_DATACLASS +
                "def _flat(s):\n"
                "    return (s.keep_alive,), s.label\n"
                "def _unflat(kids, aux):\n"
                "    return FooSpec(kids[0], aux)\n"
                "pytree.register_pytree_node(FooSpec, _flat, _unflat)\n")
        assert lint(good) == []

    def test_dataclasses_fields_counts_as_full_coverage(self):
        good = (_DATACLASS +
                "def _flat(s):\n"
                "    vals = [getattr(s, f.name) "
                "for f in dataclasses.fields(s)]\n"
                "    return tuple(vals), None\n"
                "pytree.register_pytree_node(FooSpec, _flat, None)\n")
        assert [f for f in lint(good) if f.rule == self.RULE] == []


# ---------------------------------------------------------------------------
# Pass 6: deprecation hygiene
# ---------------------------------------------------------------------------


class TestDeprecations:
    RULE = "deprecation-hygiene"

    def test_removed_call_flagged_with_replacement(self):
        bad = "res = simulator.simulate_hybrid_batch(trace, 60)\n"
        found = lint(bad)
        assert rules_of(found) == [self.RULE]
        assert "experiment.run" in found[0].message

    def test_removed_import_flagged(self):
        bad = "from repro_torch.core.simulator import simulate\n"
        assert rules_of(lint(bad)) == [self.RULE]

    def test_synthesize_attr_flagged(self):
        bad = "trace = Trace.synthesize(n_apps=8)\n"
        assert rules_of(lint(bad)) == [self.RULE]

    def test_local_definition_exempt(self):
        good = ("def simulate(trace):\n"
                "    return trace\n"
                "simulate(t)\n")
        assert lint(good) == []

    def test_new_api_ok(self):
        good = "res = experiment.run(trace, FixedSpec(keep_alive=60.0))\n"
        assert lint(good) == []


# ---------------------------------------------------------------------------
# Pass 7: conformance coverage
# ---------------------------------------------------------------------------


class TestConformanceCoverage:
    RULE = "conformance-coverage"
    ENTRY = ("def helper():\n"
             "    pass\n"
             "def launch(trace, spec):\n"
             "    return helper()\n")
    PATH = "src/repro_torch/core/engine.py"

    def config(self, tmp_path, names=("launch",)):
        return LintConfig(
            conformance_entry_points=(
                ("repro_torch/core/engine.py", tuple(names)),),
            conformance_test_dir=str(tmp_path))

    def lint_entry(self, tmp_path, config=None):
        return lint(self.ENTRY, path=self.PATH,
                    rules=[rule_by_name(self.RULE)],
                    config=config or self.config(tmp_path))

    def test_uncovered_entry_point_flagged(self, tmp_path):
        (tmp_path / "test_torch_other_conformance.py").write_text(
            "def test_something():\n    helper()\n")
        found = self.lint_entry(tmp_path)
        assert rules_of(found) == [self.RULE]
        assert "launch()" in found[0].message
        assert found[0].line == 3

    def test_covered_entry_point_ok(self, tmp_path):
        (tmp_path / "test_torch_engine_conformance.py").write_text(
            "def test_launch_matches_oracle():\n"
            "    launch(trace, spec)\n")
        assert self.lint_entry(tmp_path) == []

    def test_mention_outside_conformance_glob_does_not_count(self, tmp_path):
        (tmp_path / "test_torch_engine.py").write_text("launch(trace, spec)\n")
        # the reference's conformance files are not the port's
        (tmp_path / "test_engine_conformance.py").write_text(
            "launch(trace, spec)\n")
        assert rules_of(self.lint_entry(tmp_path)) == [self.RULE]

    def test_bare_name_without_call_does_not_count(self, tmp_path):
        (tmp_path / "test_torch_x_conformance.py").write_text(
            "from repro_torch.core.engine import launch\n")
        assert rules_of(self.lint_entry(tmp_path)) == [self.RULE]

    def test_missing_test_dir_is_its_own_finding(self, tmp_path):
        cfg = LintConfig(
            conformance_entry_points=(
                ("repro_torch/core/engine.py", ("launch",)),),
            conformance_test_dir=str(tmp_path / "nope"))
        found = self.lint_entry(tmp_path, cfg)
        assert rules_of(found) == [self.RULE]
        assert "cannot verify" in found[0].message

    def test_other_modules_out_of_scope(self, tmp_path):
        assert lint("def launch():\n    pass\n",
                    path="src/repro_torch/core/other.py",
                    rules=[rule_by_name(self.RULE)],
                    config=self.config(tmp_path)) == []

    def test_default_entry_points_resolve_in_repo(self):
        """The shipped defaults point at real files of the port with the
        reference's five entry points."""
        cfg = LintConfig()
        ref = ref_lint.LintConfig()
        assert [(k.replace("repro_torch/", "repro/"), v)
                for k, v in cfg.conformance_entry_points] == \
            list(ref.conformance_entry_points)
        for relkey, names in cfg.conformance_entry_points:
            fp = os.path.join(SRC, *relkey.split("/"))
            assert os.path.isfile(fp), relkey
            src = open(fp, encoding="utf-8").read()
            for name in names:
                assert f"def {name}(" in src, (relkey, name)

    def test_cluster_tests_outside_the_glob_leave_the_gap(self, tmp_path):
        """Before the cluster tests became a conformance file, the port's
        run_cluster and sweep_cluster were pinned by no file of the glob."""
        shutil.copy(os.path.join(REPO, "tests",
                                 "test_torch_cluster_conformance.py"),
                    tmp_path / "test_torch_cluster.py")
        path = os.path.join(PORT, "serving", "cluster_vector.py")
        src = open(path, encoding="utf-8").read()
        rule = [rule_by_name(self.RULE)]
        gap = lint(src, path=path, rules=rule,
                   config=LintConfig(conformance_test_dir=str(tmp_path)))
        assert sorted(re.search(r"entry point (\w+)\(", f.message).group(1)
                      for f in gap if f.rule == self.RULE) == \
            ["run_cluster", "sweep_cluster"]
        assert self.RULE not in rules_of(lint(src, path=path, rules=rule))


# ---------------------------------------------------------------------------
# Framework semantics
# ---------------------------------------------------------------------------


class TestSuppressions:
    def test_inline_suppression_with_reason(self):
        src = ("t = time.time()  "
               "# repro-lint: ignore[nondeterminism] -- wall clock is the "
               "measurement\n")
        findings, suppressed = run_source(src, CORE, ALL_RULES)
        assert findings == []
        assert suppressed == 1

    def test_standalone_suppression_covers_next_code_line(self):
        src = ("# repro-lint: ignore[nondeterminism] -- measurement, with a\n"
               "# continuation line of reasoning\n"
               "t = time.time()\n")
        findings, suppressed = run_source(src, CORE, ALL_RULES)
        assert findings == []
        assert suppressed == 1

    def test_reasonless_suppression_does_not_suppress(self):
        src = "t = time.time()  # repro-lint: ignore[nondeterminism]\n"
        findings, suppressed = run_source(src, CORE, ALL_RULES)
        assert suppressed == 0
        assert sorted(rules_of(findings)) == ["lint-directive",
                                              "nondeterminism"]

    def test_unknown_rule_in_directive_reported(self):
        src = "x = 1  # repro-lint: ignore[not-a-rule] -- because\n"
        findings, _ = run_source(src, CORE, ALL_RULES)
        assert rules_of(findings) == ["lint-directive"]

    def test_wrong_rule_does_not_suppress(self):
        src = ("t = time.time()  "
               "# repro-lint: ignore[tracer-leak] -- wrong rule\n")
        findings, suppressed = run_source(src, CORE, ALL_RULES)
        assert suppressed == 0
        assert "nondeterminism" in rules_of(findings)

    def test_directive_in_docstring_is_not_a_directive(self):
        src = ('"""Docs: write # repro-lint: ignore[rule] -- reason."""\n'
               "x = 1\n")
        assert parse_suppressions(src) == []
        findings, _ = run_source(src, CORE, ALL_RULES)
        assert findings == []


class TestFramework:
    def test_syntax_error_becomes_parse_finding(self):
        findings, _ = run_source("def f(:\n", CORE, ALL_RULES)
        assert rules_of(findings) == ["parse-error"]

    def test_rule_registry(self):
        """The reference's seven names in its order: one directive serves
        both linters, and the reference reports a name it does not know."""
        assert [r.name for r in ALL_RULES] == \
            [r.name for r in ref_lint.ALL_RULES]
        assert len(ALL_RULES) == 7
        with pytest.raises(KeyError):
            rule_by_name("nope")

    def test_relkey_scoping_is_root_invariant(self):
        bad = "FLAGS = ('--use_fast_math',)\n"
        for root in ("src/repro_torch/kernels/k.py", "repro_torch/kernels/k.py",
                     "/abs/path/src/repro_torch/kernels/k.py",
                     "/abs/repro_torch/x/src/repro_torch/kernels/k.py"):
            assert rules_of(lint(bad, path=root)) == ["x64-discipline"]
        # the reference's tree is out of the port's kernel scope
        assert lint(bad, path="src/repro/kernels/k.py") == []

    def test_config_overrides(self):
        cfg = LintConfig(determinism_scopes=())
        assert lint("t = time.time()\n", config=cfg) == []
        cfg = LintConfig(package="repro",
                         determinism_scopes=("repro/core/",))
        assert rules_of(lint("t = time.time()\n",
                             path="src/repro/core/x.py", config=cfg)) == \
            ["nondeterminism"]

    def test_json_schema_v1(self):
        path = os.path.join(PORT, "core", "policy_math.py")
        payload = json.loads(render_json(run_paths([path], ALL_RULES)))
        assert payload["version"] == 1
        assert set(payload.keys()) == {"version", "counts", "findings"}
        assert set(payload["counts"]) == {"files", "findings", "suppressed"}
        for f in payload["findings"]:
            assert set(f) == {"file", "line", "col", "rule", "message"}

    def test_findings_sorted_and_stable(self):
        src = "t = time.time()\nu = time.time()\n"
        findings, _ = run_source(src, CORE, ALL_RULES)
        assert [f.line for f in findings] == sorted(f.line for f in findings)


# ---------------------------------------------------------------------------
# Parity with the reference linter
# ---------------------------------------------------------------------------

# The rules whose contract carries over, and the part of each that does.
_CARRIED = {"single-source-decision-math", "deprecation-hygiene",
            "pytree-completeness", "conformance-coverage", "nondeterminism",
            "x64-discipline"}
_UNREBASED = "float32 cast of absolute-time column"


def _carried(findings):
    return sorted((f.line, f.col, f.rule) for f in findings
                  if f.rule in _CARRIED and (f.rule != "x64-discipline"
                                             or f.message.startswith(
                                                 _UNREBASED)))


def _aimed_at_reference() -> LintConfig:
    """The port's linter pointed at the reference's package and scopes."""
    ref = ref_lint.LintConfig()
    return LintConfig(
        package="repro", policy_math_relkey=ref.policy_math_relkey,
        kernel_scopes=ref.kernel_scopes,
        determinism_scopes=ref.determinism_scopes,
        conformance_entry_points=ref.conformance_entry_points,
        conformance_test_dir=ref.conformance_test_dir,
        conformance_test_glob=ref.conformance_test_glob)


REF_FILES = sorted(Path(REF).rglob("*.py"))
SRC_FILES = sorted(Path(SRC).rglob("*.py"))


class TestParity:
    def test_shared_knobs_are_the_references(self):
        port, ref = LintConfig(), ref_lint.LintConfig()
        for knob in ("time_name_pattern", "rng_allowed", "removed_calls",
                     "removed_attrs", "register_helpers",
                     "conformance_test_dir"):
            assert getattr(port, knob) == getattr(ref, knob), knob

    @pytest.mark.parametrize("path", REF_FILES,
                             ids=[p.relative_to(REF).as_posix()
                                  for p in REF_FILES])
    def test_reference_file_findings_equal(self, path):
        src = without_directives(path.read_text(encoding="utf-8"))
        want, _ = ref_lint.run_source(src, str(path), ref_lint.ALL_RULES)
        got, _ = run_source(src, str(path), ALL_RULES,
                            _aimed_at_reference())
        assert _carried(got) == _carried(want)

    def test_reference_tree_has_findings_to_compare(self):
        """With its directives off the reference's tree does have findings
        of the carried rules (its engine's clock reads, a float32 idle
        gap), so the equality above is not vacuous."""
        n = 0
        for path in REF_FILES:
            src = without_directives(path.read_text(encoding="utf-8"))
            n += len(_carried(ref_lint.run_source(
                src, str(path), ref_lint.ALL_RULES)[0]))
        assert n >= 5

    @pytest.mark.parametrize("snippet", [
        "thr = total * policy_math.PCT_SCALE\n",
        "thr = t.astype(jnp.int32) * jnp.int32(policy_math.PCT_SCALE)\n",
        "lo = it * (1.0 - margin)\n",
        "warm = load_at <= it and it <= unload_at\n",
        "def f(times):\n    return times.astype(np.float32)\n",
        "def f(t_abs):\n    return np.asarray(t_abs, np.float32)\n",
        "def f(times):\n    t = _rebase_chunk(times)\n"
        "    return t.astype(np.float32)\n",
        "noise = np.random.rand(8)\n",
        "import random\nx = random.random()\n",
        "t = time.time()\nu = datetime.datetime.now()\n",
        "k = uuid.uuid4()\n",
        _DATACLASS + "_register_pytree(FooSpec, meta=('labell',))\n",
        "res = simulator.simulate_hybrid_batch(trace, 60)\n",
        "from repro.core.simulator import simulate\n",
        "trace = Trace.synthesize(n_apps=8)\n",
        "t = time.time()  # repro-lint: ignore[nondeterminism] -- measured\n",
    ])
    def test_reference_fixture_findings_equal(self, snippet):
        path = "src/repro/core/x.py"
        want, n_want = ref_lint.run_source(snippet, path, ref_lint.ALL_RULES)
        got, n_got = run_source(snippet, path, ALL_RULES,
                                _aimed_at_reference())
        assert _carried(got) == _carried(want)
        assert n_got == n_want

    def test_parse_suppressions_equal_on_every_source(self):
        assert len(SRC_FILES) >= 180
        for path in SRC_FILES:
            src = path.read_text(encoding="utf-8")
            assert parse_suppressions(src) == [
                _as_port(s) for s in ref_lint.parse_suppressions(src)], path

    def test_json_schema_equal(self):
        path = os.path.join(REF, "serving", "engine.py")
        src = without_directives(open(path, encoding="utf-8").read())
        want = json.loads(ref_lint.render_json({
            "version": 1, "counts": {"files": 1, "findings": 0,
                                     "suppressed": 0},
            "findings": ref_lint.run_source(src, path,
                                            ref_lint.ALL_RULES)[0]}))
        got = json.loads(render_json({
            "version": 1, "counts": {"files": 1, "findings": 0,
                                     "suppressed": 0},
            "findings": run_source(src, path, ALL_RULES,
                                   _aimed_at_reference())[0]}))
        assert want["findings"] and got["findings"]
        assert got == want
        a = json.loads(render_json(run_paths([PORT], ALL_RULES)))
        b = json.loads(ref_lint.render_json(ref_lint.run_paths(
            [REF], ref_lint.ALL_RULES)))
        assert a["version"] == b["version"] == 1
        assert set(a) == set(b) and set(a["counts"]) == set(b["counts"])


def _as_port(s):
    """A reference ``Suppression`` as the port's dataclass (same fields)."""
    from repro_torch.analysis.framework import Suppression
    return Suppression(line=s.line, rules=s.rules, reason=s.reason,
                       standalone=s.standalone, target=s.target)


# ---------------------------------------------------------------------------
# The port's own findings, with its directives stripped
# ---------------------------------------------------------------------------


def test_stripped_port_finds_the_fifteen_clock_reads():
    """Every wall-clock read in the port's seed-deterministic packages is a
    measurement with a reasoned directive; without the directives they are
    the rule's seventeen findings, one for each ``time.perf_counter()``
    (fifteen, and the two around the serve engine's graph capture)."""
    want, got = [], []
    for rel in ("serving/engine.py", "serving/cluster_vector.py",
                "kernels/build.py"):
        path = os.path.join(PORT, *rel.split("/"))
        src = open(path, encoding="utf-8").read()
        want += [(rel, i) for i, line in enumerate(src.splitlines(), 1)
                 if "time.perf_counter()" in line]
        got += [(rel, f.line) for f in lint(without_directives(src),
                                           path=path)]
        assert lint(src, path=path) == []
    assert sorted(got) == sorted(want)
    assert len(got) == 17


def test_every_port_directive_has_a_reason():
    n = 0
    for path in sorted(Path(PORT).rglob("*.py")):
        for s in parse_suppressions(path.read_text(encoding="utf-8")):
            assert s.reason, f"{path}:{s.line}"
            n += 1
    assert n >= 29          # 15 clock reads, policy.py, 13 in policy_math


# ---------------------------------------------------------------------------
# Dogfood: the port's tree is clean, via the CLI chip_smoke.py runs too
# ---------------------------------------------------------------------------


def _cli(*args, cwd=REPO, block=False):
    env = dict(os.environ, PYTHONPATH=SRC)
    head = ("import sys, runpy\n"
            "sys.modules['torch'] = sys.modules['jax'] = None\n"
            if block else "import sys, runpy\n")
    code = head + (f"sys.argv = ['repro_torch.analysis', *{list(args)!r}]\n"
                   "runpy.run_module('repro_torch.analysis', "
                   "run_name='__main__', alter_sys=True)\n")
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=str(cwd), timeout=120)


class TestDogfood:
    def test_src_tree_is_clean(self):
        report = run_paths([PORT], ALL_RULES)
        msgs = "\n".join(f.render() for f in report["findings"])
        assert report["counts"]["findings"] == 0, f"lint findings:\n{msgs}"
        assert report["counts"]["files"] >= 80
        assert report["counts"]["suppressed"] >= 16

    def test_cli_exit_codes(self):
        clean = _cli()                       # default path: src/repro_torch
        assert clean.returncode == 0, clean.stdout + clean.stderr
        assert re.search(r"^0 finding\(s\) in \d+ file\(s\)",
                         clean.stdout, re.M)
        usage = _cli("--select", "nope", PORT)
        assert usage.returncode == 2

    def test_cli_findings_exit_one(self, tmp_path):
        bad = tmp_path / "repro_torch" / "core" / "bad.py"
        bad.parent.mkdir(parents=True)
        bad.write_text("t = time.time()\nx = torch.rand(3)\n")
        proc = _cli("--json", str(tmp_path))
        assert proc.returncode == 1
        payload = json.loads(proc.stdout)
        assert [f["rule"] for f in payload["findings"]] == \
            ["nondeterminism", "nondeterminism"]

    def test_changed_mode(self, tmp_path):
        git = ["git", "-C", str(tmp_path)]
        try:
            subprocess.run(git + ["init", "-q"], check=True,
                           capture_output=True)
        except (OSError, subprocess.CalledProcessError):
            pytest.skip("git unavailable")
        subprocess.run(git + ["config", "user.email", "t@t"], check=True)
        subprocess.run(git + ["config", "user.name", "t"], check=True)
        pkg = tmp_path / "repro_torch" / "core"
        pkg.mkdir(parents=True)
        (pkg / "clean.py").write_text("x = 1\n")
        (pkg / "old.py").write_text("y = 2\n")
        subprocess.run(git + ["add", "-A"], check=True)
        subprocess.run(git + ["commit", "-qm", "seed"], check=True,
                       capture_output=True)
        (pkg / "bad.py").write_text("t = time.time()\n")      # untracked
        (pkg / "old.py").write_text("y = torch.randn(2)\n")   # modified
        proc = _cli("--changed", "repro_torch", cwd=tmp_path)
        assert proc.returncode == 1, proc.stdout + proc.stderr
        assert "bad.py" in proc.stdout and "old.py" in proc.stdout
        assert "clean.py" not in proc.stdout

    def test_list_rules_with_torch_and_jax_blocked(self):
        proc = _cli("--list-rules", block=True)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        names = [line.split(":")[0] for line in proc.stdout.splitlines()]
        assert names == [r.name for r in ref_lint.ALL_RULES]

    def test_lint_with_torch_and_jax_blocked(self):
        proc = _cli(PORT, block=True)
        assert proc.returncode == 0, proc.stdout + proc.stderr


def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_under_test", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_lint_phase(capsys):
    """``chip_smoke.py``'s host phase: the linter in-process, one line."""
    _chip_smoke().lint_phase()
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "lint"
    assert line["findings"] == 0 and line["files"] >= 80
    assert line["suppressed"] >= 16 and line["seconds"] > 0


def test_chip_smoke_tf32_gates(monkeypatch):
    """The runtime side of the TF32 rule fails the run for each switch."""
    import torch
    cs = _chip_smoke()
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    assert torch.get_float32_matmul_precision() == "highest"
    assert cs.tf32_gates() == []
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert cs.tf32_gates() == ["tf32: cudnn_allow_tf32 is on"]
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    torch.set_float32_matmul_precision("high")
    try:
        assert len(cs.tf32_gates()) == 2      # "high" turns matmul TF32 on
    finally:
        torch.set_float32_matmul_precision("highest")
    assert cs.tf32_gates() == []
