"""The precision control at a size a test run holds: the reference computed
in float8 (``w8``: its matrices; ``w8a8``: their inputs too) in the
program's place must come out not correct, through the harness's own
``correct``, where the program's bfloat16 readings of the same run pass.
At this size the gaps are not the cells', so the test sets the limit by
the cells' rule: above the program's readings over its seeds, below the
controls' least, which is at least three times the program's."""
import pytest

from portbench.tests import tiny

SEEDS = (2 ** 33 + 1, 2 ** 33 + 2)
LIMIT = 0.002


@pytest.mark.parametrize("workload", ["qwen2-7b.code-warm",
                                      "olmoe-1b-7b.code-warm",
                                      "qwen2-7b.code-cold"])
def test_control_fails_where_the_program_passes(workload):
    program, controls = [], []
    for seed in SEEDS:
        res = tiny.run(workload, dtype="bfloat16", control=True, seed=seed,
                       limit=LIMIT)
        r = res["readings"]
        assert r["sampled_tokens"] >= 100
        assert not res["correct"]
        assert res["checks"]["logit_gap_mean"]["value"] == r["w8a8_mean"]
        assert res["checks"]["pool_mismatches"]["value"] == 0
        program.append(r["logit_gap_mean"])
        controls += [r["w8_mean"], r["w8a8_mean"]]
    assert max(program) <= LIMIT
    assert min(controls) > LIMIT
    assert min(controls) >= 3 * max(program)
