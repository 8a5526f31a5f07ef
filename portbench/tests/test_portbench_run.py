"""The command line: without a card a run fails and prints no result; on
the card (``gpu``) one short cell runs correct and names the card."""
import json
import shutil
import subprocess
import sys

import pytest

from portbench.tests import tiny

ARGS = ["--workload", "olmoe-1b-7b.code-warm", "--seed", str(2 ** 33 + 9),
        "--seconds", "5", "--trace", "0"]


def run_py(cwd, timeout):
    return subprocess.run([sys.executable, "portbench/run.py", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=timeout)


def test_no_card_no_result(tmp_path):
    """Here (no card, or a tree of the benchmark's files alone) the run
    exits non-zero and its standard output holds no result."""
    import torch
    if torch.cuda.is_available():
        shutil.copy(tiny.ROOT / "BENCHMARK.json", tmp_path)
        shutil.copytree(tiny.ROOT / "portbench", tmp_path / "portbench")
        cwd = tmp_path
    else:
        cwd = tiny.ROOT
    out = run_py(cwd, 120)
    assert out.returncode != 0
    assert "correct" not in out.stdout


@pytest.mark.gpu
def test_one_short_cell_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = run_py(tiny.ROOT, 900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert res["device"]["kind"] == torch.cuda.get_device_name(0)
    assert {"request_p50_s", "tokens_per_s", "setup_s"} == set(res["metrics"])
    assert list(res)[-1] == "checks"
