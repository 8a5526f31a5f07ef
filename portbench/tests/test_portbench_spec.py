"""BENCHMARK.json and the files it names: every cell, configuration, mix
and metric parses and resolves, within the benchmark's limits; a cell, a
mix and a metric added as files alone are picked up."""
import json
import re
import shutil

import pytest

from portbench.tests import tiny

BENCH = tiny.BENCH
PB = tiny.ROOT / "portbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    # a full check of 24 cells, each run with its minute of slack and each
    # cell's compile allowance, fits in twelve hours
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert 1 <= cells <= 24
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_entry(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"])
    assert entry["file"] == f"portbench/configs/{entry['name']}.json"
    cfg = json.loads((tiny.ROOT / entry["file"]).read_text())
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert sorted(cfg["reduced"]) == sorted(entry["reduced"])
    # every key in reduced differs from the published value, and no other
    assert sorted(cfg["published"]) == sorted(cfg["reduced"])
    for key, published in cfg["published"].items():
        assert cfg[key] != published
    widths = re.compile(r"(size|_dim|_rank|heads|experts_per_tok)$")
    assert not [k for k in entry["reduced"] if widths.search(k)]
    assert 1 <= len(entry["why"]) <= 200
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_is_what_the_program_runs(entry):
    """The file's ``model`` group is the port's own configuration of the
    architecture with the kernels on, at the published norm epsilon (the
    port's presets hold 1e-5 for every model; the program reads the
    configuration's), and the published keys say the same numbers."""
    from repro_torch.configs import get
    from repro_torch.configs.base import ModelConfig
    cfg = json.loads((tiny.ROOT / entry["file"]).read_text())
    m = cfg["model"]
    assert ModelConfig(**m) == get(m["arch_id"]).with_(
        use_kernels=True, norm_eps=cfg["rms_norm_eps"])
    for hf, field in cfg["hf_keys"].items():
        assert cfg[hf] == m[field], hf
    assert m["n_heads"] * m["head_dim"] == cfg["hidden_size"]


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_resolves(w):
    from portbench.cell import Cell
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    c = Cell(BENCH, w["name"])
    assert c.config["name"] == w["config"]
    assert c.traffic["name"] == w["traffic"]
    assert hasattr(c.reference, "forward_logits")
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in names
        assert callable(c.reader(m["name"]))


def test_pairs_of_config_and_traffic_are_unique():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(len(pairs) // 4, 1)


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", cells)) <= cells
    if "bound" in m:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert (PB / "metrics" / f"{m['name']}.py").exists()
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    if m["name"].endswith("_roofline") or "mfu" in m["name"]:
        assert m["unit"] == "%"


def test_every_cell_reports_what_it_must():
    for w in BENCH["workloads"]:
        mine = lambda m: w["name"] in m.get("workloads", [w["name"]])
        e2e = [m["name"] for m in BENCH["end_to_end"] if mine(m)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert [m for m in BENCH["per_layer"] if mine(m)]
    for m in BENCH["per_layer"]:
        for cell in m.get("workloads", []):
            e2e = {x["name"] for x in BENCH["end_to_end"]
                   if cell in x.get("workloads", [cell])}
            assert m["moves"] in e2e, (m["name"], cell)


def test_a_cell_added_as_files_is_picked_up(tmp_path):
    """A new mix, a new cell and a new per-layer metric, as files and
    entries only: the harness finds each by its name."""
    from portbench.cell import Cell, RunRecord
    root = tmp_path / "portbench"
    for d in ("configs", "traffic", "metrics", "reference"):
        shutil.copytree(PB / d, root / d)
    t = json.loads((PB / "traffic" / "code-warm.json").read_text())
    t["name"] = "chat-warm"
    t["new_tokens"] = {"dist": "log_uniform", "low": 64, "high": 256}
    (root / "traffic" / "chat-warm.json").write_text(json.dumps(t))
    (root / "metrics" / "requests_read.py").write_text(
        "def read(run):\n    return float(len(run.requests)) or None\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "olmoe-1b-7b.chat-warm",
                               "config": "olmoe-1b-7b",
                               "traffic": "chat-warm", "chips": 1,
                               "why": "added by files"})
    bench["per_layer"].append({"name": "requests_read", "unit": "1",
                               "better": "higher", "source":
                               "program_counter", "layer": "invoker",
                               "moves": "tokens_per_s",
                               "workloads": ["olmoe-1b-7b.chat-warm"]})
    c = Cell(bench, "olmoe-1b-7b.chat-warm", root=root)
    assert c.traffic["new_tokens"]["low"] == 64
    assert "requests_read" in [m["name"] for m in c.per_layer]
    run = RunRecord([{"index": 0, "error": None}], 0, [], None,
                    c.config["model"], tiny_cpu())
    assert c.reader("requests_read")(run) == 1.0


def tiny_cpu():
    import torch
    return torch.device("cpu")
